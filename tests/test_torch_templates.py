"""Port parity, the template database: ``render_templates`` of both
packages on the L-shape CAD (the same view files; per view the same point
count within 1%, clouds within 5 mm of each other by mean nearest-neighbour
distance, equal sidecar; the port's PNG decodes to the JAX package's image
within one grey level on average), and ``load_templates`` of each package
on the other's database (equal stacks)."""
import os

import cv2
import numpy as np
import pytest
import torch

from poseestimator_tpu.templates.creation import render_templates as j_render_templates
from poseestimator_tpu.templates.db import load_templates as j_load_templates
from poseestimator_tpu.utils.plyio import read_ply
from poseestimator_tpu_torch.templates.creation import render_templates
from poseestimator_tpu_torch.templates.db import load_templates
from poseestimator_tpu_torch.utils.plyio import write_ply

from helpers import l_shape_mesh
from torch_threads import two_threads  # noqa: F401


@pytest.fixture(scope="module")
def databases(tmp_path_factory):
    d = tmp_path_factory.mktemp("db")
    mesh = l_shape_mesh()
    cad = str(d / "l.ply")
    write_ply(cad, mesh.vertices, faces=mesh.faces)
    port = render_templates(cad, str(d / "port"), device="cpu")
    ref = j_render_templates(cad, str(d / "jax"))
    return cad, d, port, ref


def test_render_templates_match(databases):
    _, d, port, ref = databases
    assert [os.path.basename(p) for p in port] == [os.path.basename(p) for p in ref]
    assert len(port) == 5
    for p, r in zip(port, ref):
        a, b = read_ply(p).vertices, read_ply(r).vertices
        assert abs(len(a) - len(b)) <= 0.01 * len(b)
        nn = torch.cdist(torch.from_numpy(a), torch.from_numpy(b)).min(1).values
        assert float(nn.mean()) < 0.005, (os.path.basename(p), float(nn.mean()))
    for sub in ("port", "jax"):
        with open(d / sub / "view_set.txt") as f:
            assert f.read() == "reduced\n"
    for name in sorted(os.listdir(d / "jax")):
        if name.endswith(".png"):
            a = cv2.imread(str(d / "port" / name))
            b = cv2.imread(str(d / "jax" / name))
            assert a is not None and a.shape == b.shape == (480, 640, 3)
            assert np.abs(a.astype(np.int16) - b).mean() < 1.0


def test_databases_load_in_either_package(databases):
    cad, d, _, _ = databases
    for sub in ("port", "jax"):
        jdb = j_load_templates(str(d / sub), cad)
        tdb = load_templates(str(d / sub), cad, device="cpu")
        assert tdb.paths == jdb.paths and tdb.count == 5
        np.testing.assert_array_equal(tdb.points.numpy(), np.asarray(jdb.points))
        np.testing.assert_array_equal(tdb.valid.numpy(), np.asarray(jdb.valid))
        assert tdb.points.shape[1] % 1024 == 0
        c = tdb.cloud(2)
        assert int(c.count()) == int(np.asarray(jdb.valid[2]).sum())


def test_load_templates_renders_missing_and_other_view_set(databases, tmp_path):
    cad = databases[0]
    db = load_templates(str(tmp_path / "v"), cad, device="cpu")
    assert db.count == 5
    full = load_templates(str(tmp_path / "v"), cad, view_set="full", device="cpu")
    assert full.count == 26 and len(os.listdir(tmp_path / "v")) == 2 * 26 + 1
    with pytest.raises(FileNotFoundError):
        load_templates(str(tmp_path / "w"), str(tmp_path / "missing.ply"), device="cpu")
