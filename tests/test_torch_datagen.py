"""The port's data pipeline and synthetic scene generator against the JAX
package's on the CPU, under the same seeds: the dataset.yaml contract,
``load_sample`` (plain, flipped, and with the scale / translate / HSV
augmentations drawing from one generator), ``load_mosaic`` (instances
dropped by a draw), ``augment_hsv``, and whole ``DataLoader`` epochs (with
and without augmentation, the tiny-dataset wrap-around): images, boxes,
classes, masks and validity bit for bit. The generator's randomisation
helpers draw for draw, its backgrounds, and ``generate`` at 128 x 96 in
both depth instruments: label files, ``scene_gt.json``,
``scene_camera.json`` and ``mask_visib/`` equal; splat depth and images
equal to the byte; the exact-raster instrument's depth and colour within
a unit on a few pixels (the 3 x 3 pose transform rounds apart between XLA
and ATen, which moves a depth across a millimetre boundary or a shade
across a uint8 level)."""
import glob
import json
import os

import cv2
import numpy as np
import pytest
import torch

from helpers import box_mesh, l_shape_mesh, write_mesh
from test_training import make_synthetic_dataset

from poseestimator_tpu.training import data as jdata
from poseestimator_tpu.training import synth as jsynth

from poseestimator_tpu_torch.apps import generate as gen_app
from poseestimator_tpu_torch.geom3d.camera import Intrinsics
from poseestimator_tpu_torch.training import data as pdata
from poseestimator_tpu_torch.training import synth as psynth
from torch_threads import two_threads  # noqa: F401

FIELDS = ("images", "boxes", "classes", "masks", "inst_valid")


@pytest.fixture(scope="module")
def blobs(tmp_path_factory):
    root = tmp_path_factory.mktemp("blobs")
    yml = make_synthetic_dataset(str(root), n_images=7, size=128)
    return yml, jdata.list_samples(jdata.load_dataset_yaml(yml), "train")


def _same(a, b):
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and np.array_equal(x, y)


def test_dataset_contract(blobs):
    yml, samples = blobs
    assert vars(pdata.load_dataset_yaml(yml)) == vars(jdata.load_dataset_yaml(yml))
    assert pdata.load_dataset_yaml(yml).nc == 1
    spec = pdata.load_dataset_yaml(yml)
    assert pdata.list_samples(spec, "train") == samples
    assert pdata.list_samples(spec, "val") == jdata.list_samples(jdata.load_dataset_yaml(yml),
                                                                  "val")
    for _, lbl in samples:
        for (ca, pa), (cb, pb) in zip(pdata.parse_label_file(lbl), jdata.parse_label_file(lbl)):
            assert ca == cb and np.array_equal(pa, pb)
    assert pdata.parse_label_file(lbl + ".missing") == []


@pytest.mark.parametrize("aug", [{}, {"flip_lr": True},
                                 {"scale_jitter": 0.3, "translate_jitter": 0.1, "hsv": True},
                                 {"flip_lr": True, "scale_jitter": 0.3, "hsv": True}])
@pytest.mark.parametrize("imgsz", [96, 160])
def test_load_sample_matches_jax(blobs, aug, imgsz):
    _, samples = blobs
    for s in range(3):
        _same(pdata.load_sample(*samples[s], imgsz, 4, rng=np.random.default_rng(s), **aug),
              jdata.load_sample(*samples[s], imgsz, 4, rng=np.random.default_rng(s), **aug))


@pytest.mark.parametrize("max_instances", [8, 3])
def test_load_mosaic_matches_jax(blobs, max_instances):
    """Four quadrants; with 3 slots for 4 instances the kept ones are drawn."""
    _, samples = blobs
    for idx in ([0, 1, 2, 3], [4, 4, 5, 6]):
        _same(pdata.load_mosaic(samples, idx, 128, max_instances, np.random.default_rng(1)),
              jdata.load_mosaic(samples, idx, 128, max_instances, np.random.default_rng(1)))


def test_augment_hsv_matches_jax(rng):
    img = rng.integers(0, 256, (61, 97, 3), dtype=np.uint8)
    for s in range(4):
        assert np.array_equal(pdata.augment_hsv(img, np.random.default_rng(s)),
                              jdata.augment_hsv(img, np.random.default_rng(s)))


@pytest.mark.parametrize("augment,batch", [(False, 3), (True, 2), (True, 16)])
def test_dataloader_epochs_match_jax(blobs, augment, batch):
    """Two epochs under one seed (mosaic 0.5 when augmenting; batch 16 >
    7 samples: the wrap-around batch)."""
    _, samples = blobs
    kw = dict(imgsz=96, max_instances=6, augment=augment, mosaic=0.5, seed=4)
    pl, jl = pdata.DataLoader(samples, batch, **kw), jdata.DataLoader(samples, batch, **kw)
    assert len(pl) == len(jl)
    for _ in range(2):
        got, want = list(pl), list(jl)
        assert len(got) == len(want) == len(jl)
        for a, b in zip(got, want):
            _same([getattr(a, f) for f in FIELDS], [getattr(b, f) for f in FIELDS])


def test_randomisation_helpers_draw_for_draw():
    intr = Intrinsics.from_fov(60.0, 160, 120)
    from poseestimator_tpu import geom3d as g3

    jintr = g3.Intrinsics.from_fov(60.0, 160, 120)
    for s in range(5):
        a, b = np.random.default_rng(s), np.random.default_rng(s)
        assert np.array_equal(psynth._rand_rotation(a), jsynth._rand_rotation(b))
        assert np.array_equal(psynth._place_instance(a, intr, 0.3),
                              jsynth._place_instance(b, jintr, 0.3))
        for x, y in zip(psynth._distractor_cloud(a, 500, 0.2), jsynth._distractor_cloud(b, 500,
                                                                                          0.2)):
            assert np.array_equal(x, y)
        assert a.random() == b.random()


def test_procedural_background_matches_jax():
    """uint8 backgrounds of the same draws: equal except where the cubic
    blotch upsampling's last-bit difference (IPP inside OpenCV) crosses an
    integer, at most 1 level on 0.01% of values."""
    for s, (h, w) in enumerate([(96, 128), (480, 640), (50, 41)]):
        a = psynth._procedural_background(np.random.default_rng(s), h, w)
        b = jsynth._procedural_background(np.random.default_rng(s), h, w)
        d = np.abs(a.astype(int) - b)
        assert d.max() <= 1 and (d > 0).mean() <= 1e-4


def _cads(tmp_path):
    a, b = tmp_path / "boxy.ply", tmp_path / "ell.ply"
    write_mesh(a, box_mesh(0.12, 0.07, 0.05))
    write_mesh(b, l_shape_mesh(0.2))
    return [f"boxy={a}", f"ell={b}"]


@pytest.mark.parametrize("instrument", ["splat", "mesh"])
def test_generate_matches_jax(tmp_path, instrument):
    cad = _cads(tmp_path)
    kw = dict(cad=cad, n_train=4, n_val=2, width=128, height=96, points_per_object=3000,
              min_visib_px=24, bop=True, depth_instrument=instrument, seed=3)
    J, P = str(tmp_path / "jax"), str(tmp_path / "port")
    sj = jsynth.generate(jsynth.SynthConfig(out=J, **kw), log=lambda *a: None)
    sp = psynth.generate(psynth.SynthConfig(out=P, device="cpu", **kw), log=lambda *a: None)
    assert sp["frames"] == sj["frames"] and sp["skipped_instances"] == sj["skipped_instances"]
    assert sp["classes"] == sj["classes"]
    assert open(f"{P}/dataset.yaml").read() == open(f"{J}/dataset.yaml").read().replace(J, P)
    labels = sorted(glob.glob(f"{J}/*/labels/*.txt"))
    assert len(labels) == sum(sj["frames"].values())
    for f in labels:
        a = [np.array(ln.split(), float) for ln in open(f.replace(J, P)).read().splitlines()]
        b = [np.array(ln.split(), float) for ln in open(f).read().splitlines()]
        assert [len(x) for x in a] == [len(x) for x in b]
        for x, y in zip(a, b):
            assert x[0] == y[0]
            np.testing.assert_allclose(x[1:], y[1:], rtol=0, atol=1e-5)
    for name in ("scene_gt.json", "scene_camera.json"):
        assert json.load(open(f"{P}/{name}")) == json.load(open(f"{J}/{name}"))
    for f in sorted(glob.glob(f"{J}/mask_visib/*.png")):
        assert np.array_equal(cv2.imread(f.replace(J, P), cv2.IMREAD_UNCHANGED),
                              cv2.imread(f, cv2.IMREAD_UNCHANGED))
    n_px = 0
    for f in sorted(glob.glob(f"{J}/depth/*.png")):
        a = cv2.imread(f.replace(J, P), cv2.IMREAD_UNCHANGED).astype(int)
        b = cv2.imread(f, cv2.IMREAD_UNCHANGED).astype(int)
        if instrument == "splat":
            assert np.array_equal(a, b)
        else:
            assert np.abs(a - b).max() <= 1 and (a != b).mean() <= 1e-3
        n_px += a.size
    for f in sorted(glob.glob(f"{J}/rgb/*.png")):
        a, b = cv2.imread(f.replace(J, P)).astype(int), cv2.imread(f).astype(int)
        if instrument == "splat":
            assert np.array_equal(a, b)
        else:
            assert np.abs(a - b).max() <= 1 and (a != b).any(-1).mean() <= 2e-3
    for f in sorted(glob.glob(f"{J}/*/images/*.jpg")):
        if instrument == "splat":  # the JPEG encoder gives cv2.imwrite's bytes
            assert open(f.replace(J, P), "rb").read() == open(f, "rb").read()
    assert n_px > 0


def test_generate_app_writes_the_dataset(tmp_path):
    """``apps/generate.py`` with ``--device cpu`` writes what ``generate``
    writes; the dataset feeds the port's loader."""
    cad = _cads(tmp_path)
    assert gen_app.main([*sum((["--cad", c] for c in cad), []), "--out", str(tmp_path / "a"),
                         "--train", "2", "--val", "1", "--imgsz", "96x64", "--points", "2000",
                         "--min-visib-px", "24", "--seed", "2", "--device", "cpu"]) == 0
    psynth.generate(psynth.SynthConfig(cad=cad, out=str(tmp_path / "b"), n_train=2, n_val=1,
                                       width=96, height=64, points_per_object=2000,
                                       min_visib_px=24, seed=2, device="cpu"),
                    log=lambda *a: None)
    for f in sorted(glob.glob(str(tmp_path / "a" / "*" / "*" / "*"))):
        assert open(f, "rb").read() == open(f.replace("/a/", "/b/"), "rb").read(), f
    spec = pdata.load_dataset_yaml(str(tmp_path / "a" / "dataset.yaml"))
    batch = next(iter(pdata.DataLoader(pdata.list_samples(spec, "train"), 2, imgsz=96)))
    assert batch.images.shape == (2, 96, 96, 3) and batch.inst_valid.any()
