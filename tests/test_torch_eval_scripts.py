"""Port parity, the evaluation scripts beside ``eval_tracking``'s parity
(``tests/test_torch_eval.py``): ``scaling_eval.py``, ``clique_sweep.py``, ``eval_init.py``,
``predict.py``, ``testrun.py`` and ``mirror.py`` against the JAX
package's ``tools/`` and ``detection/`` scripts, and the template search's
batched renders. Tolerances, stated per test:

- ``scaling_eval`` at world 1 and 2 (gloo CPU ranks): scores bit-equal,
  winner's ADD < 0.15 m; ``clique_sweep``: the graphs equal the JAX
  sweep's and the greedy/exact agreement is the JAX sweep's; ``eval_init``
  on a 2-frame 128x96 scene: a finite row per configuration;
- ``predict``: pixels equal to ``detection/predict.py``'s drawing outside
  each ``putText`` label box, labels printed exactly, ``--folder`` counts
  equal; ``testrun``: pixels equal; ``mirror``: labels byte-equal,
  decoded images equal;
- the search: batched renders bit-equal to single ones, the scores of any
  part of a batch bit-equal to the batch's, the search's scores on half
  its templates bit-equal to the whole search's on the CPU.
"""
import json
import os
from types import SimpleNamespace

import cv2
import numpy as np
import pytest
import torch

from poseestimator_tpu_torch import kernel_cases as kc
from poseestimator_tpu_torch.apps import (clique_sweep, eval_init, eval_tracking, mirror, predict,
                                          scaling_eval, testrun)
from poseestimator_tpu_torch.geom3d.camera import Intrinsics
from poseestimator_tpu_torch.utils.plyio import write_ply
from torch_threads import two_threads  # noqa: F401


def test_scaling_eval_worlds_bit_equal(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "2")  # each spawned rank: two threads
    args = scaling_eval.build_parser().parse_args(
        ["--cpu", "--worlds", "1,2", "--templates", "4", "--points", "128", "--repeat", "1"])
    rows = scaling_eval.run(args, quiet=True)
    assert [r["world"] for r in rows] == [1, 2]
    assert all(r["scores_bit_equal"] and r["winner_add_m"] < 0.15 for r in rows)


def test_clique_sweep_matches_jax():
    import jax.numpy as jnp

    from poseestimator_tpu.registration import native as j_native
    from poseestimator_tpu.registration.maxclique import max_clique_greedy as j_greedy
    from tools import clique_sweep as j_sweep

    argv = ["--cpu", "--ks", "32,64", "--ratios", "0.5,0.9", "--budget", "12", "--seed", "3"]
    rows = clique_sweep.run(clique_sweep.build_parser().parse_args(argv), quiet=True)
    ks, ratios = [32, 64], [0.5, 0.9]
    trials = clique_sweep.trials_per_cell(ks, ratios, 12)
    rng_p, rng_j = np.random.default_rng(3), np.random.default_rng(3)
    cell = 0
    for K in ks:
        for ratio in ratios:
            agree = 0
            for _ in range(int(trials[cell])):
                a, n_in = clique_sweep.make_graph(rng_p, K, ratio, 0.01, 1.0)
                b, m_in = j_sweep.make_graph(rng_j, K, ratio, 0.01, 1.0)
                np.testing.assert_array_equal(a, b)
                _, g = j_greedy(jnp.asarray(b), jnp.ones(K, bool))
                _, e = j_native.max_clique_exact(b)
                agree += int(int(g) == int(e))
            assert rows[cell]["trials"] == trials[cell]
            assert rows[cell]["agreement_rate"] == agree / trials[cell]
            cell += 1


def test_eval_init_rows(tmp_path, capsys):
    assert eval_init.main(["--cpu", "--work-dir", str(tmp_path), "--frames", "2", "--imgsz",
                           "128x96", "--configs", "reduced:1:2",
                           "--json-out", str(tmp_path / "rows.json")]) == 0
    rows = json.loads((tmp_path / "rows.json").read_text())
    assert [r["config"] for r in rows] == ["reduced:1:2"]
    assert np.isfinite(rows[0]["adds_mean_mm"]) and 0.0 <= rows[0]["bop_ar"] <= 1.0
    assert os.path.exists(tmp_path / "scene_mesh" / "scene_gt.json")


class _StubDetector:
    """Fixed detections in place of a trained model, for both scripts:
    two masked boxes for one image, and for a batch a count per image
    from its mean intensity (0 for the black padding)."""

    def __init__(self, *a, **kw):
        pass

    def detect_mask(self, img, class_id=0, conf=0.7):
        h, w = img.shape[:2]
        out = []
        for i, (x1, y1, x2, y2) in enumerate(((5, 20, 40, 50), (30, 8, 60, 44))):
            m = np.zeros((h, w), np.uint8)
            m[y1 + 2:y2 - 2, x1 + 3:x2 - 3] = 255
            out.append({"mask": m, "class_id": i, "conf": 0.9 - 0.1 * i,
                        "bbox": np.array([x1, y1, x2, y2], np.float32)})
        return out

    def predict_batch(self, imgs, conf=0.25):
        imgs = np.asarray(imgs)
        n = (imgs.reshape(len(imgs), -1).mean(1) // 40).astype(np.int64)
        valid = np.arange(4)[None, :] < n[:, None]
        return SimpleNamespace(valid=torch.from_numpy(valid) if self.torch else valid), None


def _jax_annotate(img, results):
    """detection/predict.py:69-80 verbatim (its ``--image`` path cannot run
    as it stands: ``main`` binds ``np`` locally in the ``--folder`` branch)."""
    vis = img.copy()
    rng = np.random.default_rng(0)
    for r in results:
        color = tuple(int(c) for c in rng.integers(64, 255, 3))
        m = r["mask"] > 0
        vis[m] = (0.5 * vis[m] + 0.5 * np.asarray(color)).astype(np.uint8)
        x1, y1, x2, y2 = [int(v) for v in r["bbox"]]
        cv2.rectangle(vis, (x1, y1), (x2, y2), color, 2)
        cv2.putText(vis, f"{r['class_id']}:{r['conf']:.2f}", (x1, max(y1 - 4, 10)),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.5, color, 1)
    return vis


def test_predict_matches_jax_outside_labels(tmp_path, monkeypatch, capsys):
    import detection.predict as j_predict
    from poseestimator_tpu_torch.pipeline import detector as det_mod

    rng = np.random.default_rng(1)
    img = (rng.random((64, 80, 3)) * 255).astype(np.uint8)
    src = str(tmp_path / "in.png")
    cv2.imwrite(src, img)
    monkeypatch.setattr(det_mod, "Detector", type("S", (_StubDetector,), {"torch": True}))
    predict.main(["--image", src, "--save", str(tmp_path / "p.png"), "--device", "cpu"])
    out = capsys.readouterr().out
    results = _StubDetector().detect_mask(img)
    want, got = _jax_annotate(img, results), cv2.imread(str(tmp_path / "p.png"))
    keep = np.ones(img.shape[:2], bool)
    for r in results:
        x, y = int(r["bbox"][0]), max(int(r["bbox"][1]) - 4, 10)
        text = f"{r['class_id']}:{r['conf']:.2f}"
        assert f"label {text} at ({x}, {y})" in out
        (tw, th), base = cv2.getTextSize(text, cv2.FONT_HERSHEY_SIMPLEX, 0.5, 1)
        keep[max(y - th - 1, 0):y + base + 1, max(x - 1, 0):x + tw + 1] = False
    assert keep.sum() > keep.size // 2
    np.testing.assert_array_equal(got[keep], want[keep])
    assert not np.array_equal(got, img)

    # --folder: batches of 4, the tail padded; the per-file counts printed alike
    folder = tmp_path / "imgs"
    folder.mkdir()
    for i in range(6):
        cv2.imwrite(str(folder / f"{i}.jpg"), np.full((24, 32, 3), 30 * i + 10, np.uint8))
    monkeypatch.setattr(j_predict, "Detector", type("J", (_StubDetector,), {"torch": False}))
    j_predict.main(["--folder", str(folder), "--batch", "4"])
    want = capsys.readouterr().out.splitlines()
    predict.main(["--folder", str(folder), "--batch", "4", "--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert got[:-1] == want[:-1] and len(got) == 7
    assert got[-1].split(", ")[-1] == want[-1].split(", ")[-1]  # the total detections


def test_testrun_matches_jax(tmp_path):
    from detection.testrun import draw_yolo_polygons as j_draw

    img = (np.random.default_rng(2).random((60, 90, 3)) * 255).astype(np.uint8)
    src, lab = str(tmp_path / "a.png"), str(tmp_path / "a.txt")
    cv2.imwrite(src, img)
    with open(lab, "w") as f:
        f.write("0 0.1 0.1 0.5 0.15 0.45 0.6 0.12 0.55\n1 0.6 0.2 0.95 0.3 0.8 0.9\n")
    for cls in (None, 1):
        want = j_draw(src, lab, cls, show=False)
        got = testrun.draw_yolo_polygons(src, lab, cls, save=str(tmp_path / "o.png"))
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(cv2.imread(str(tmp_path / "o.png")), want)


@pytest.mark.parametrize("flip", ["h", "v", "hv"])
def test_mirror_matches_jax(tmp_path, flip):
    from detection.mirror import mirror_dataset as j_mirror

    imgs, labs = tmp_path / "images", tmp_path / "labels"
    imgs.mkdir()
    labs.mkdir()
    rng = np.random.default_rng(4)
    y, x = np.mgrid[0:45, 0:70]
    photo = np.clip(np.stack([x * 3, y * 4, x + y], -1) + rng.normal(0, 20, (45, 70, 3)), 0,
                    255).astype(np.uint8)
    cv2.imwrite(str(imgs / "a.jpg"), photo)
    cv2.imwrite(str(imgs / "b.png"), photo[::-1])
    cv2.imwrite(str(imgs / "c.jpg"), photo)  # no label: skipped
    for s in ("a", "b"):
        (labs / f"{s}.txt").write_text("0 0.1 0.2 0.3 0.4 0.5 0.6\n\n2 0.9 0.8 0.7 0.6 0.25 0.125\n")
    assert j_mirror(str(imgs), str(labs), str(tmp_path / "ji"), str(tmp_path / "jl"), flip) == 2
    assert mirror.mirror_dataset(str(imgs), str(labs), str(tmp_path / "pi"),
                                 str(tmp_path / "pl"), flip) == 2
    assert sorted(os.listdir(tmp_path / "pi")) == sorted(os.listdir(tmp_path / "ji"))
    for s in ("a", "b"):
        assert (tmp_path / "pl" / f"{s}.txt").read_bytes() == (tmp_path / "jl" / f"{s}.txt").read_bytes()
    for name in ("a.jpg", "b.png"):
        want = cv2.imread(str(tmp_path / "ji" / name), cv2.IMREAD_UNCHANGED)
        got = cv2.imread(str(tmp_path / "pi" / name), cv2.IMREAD_UNCHANGED)
        np.testing.assert_array_equal(got, want)


# --- the template search's batched renders --------------------------------

@pytest.fixture(scope="module")
def lshape_estimator(tmp_path_factory):
    from poseestimator_tpu_torch.pipeline.pose_estimator import PoseEstimator

    d = tmp_path_factory.mktemp("search")
    v, f = kc.lshape_mesh(0.3)
    cad = str(d / "l.ply")
    write_ply(cad, v, faces=f)
    intr = Intrinsics.from_fov(60.0, 320, 240)
    return PoseEstimator(cad, str(d / "views"), intr, target_points=100, seed=0, device="cpu",
                         search_window=(64, 128))


def _observe(est, angle=0.3):
    from poseestimator_tpu_torch.geom3d.camera import backproject_depth
    from poseestimator_tpu_torch.geom3d.sampling import random_sample
    from poseestimator_tpu_torch.render.raster import render_depth_mesh

    T = (eval_tracking._rot_z(angle) @ eval_tracking._look_at_cv(
        np.array([1.0, 1.0, 1.0]) / np.sqrt(3) * 0.7)).astype(np.float32)
    d = render_depth_mesh(est._mesh_v, est._mesh_f, torch.from_numpy(T), est.intr, near=0.01,
                          far=5.0)
    cloud = random_sample(backproject_depth(d, est.intr, depth_min=0.01, depth_max=5.0), 4096,
                          torch.Generator().manual_seed(1))
    return T, d, cloud


def test_batched_window_scores_match_alone(lshape_estimator):
    from poseestimator_tpu_torch.pipeline.pose_estimator import render_windows, score_pose_candidates
    from poseestimator_tpu_torch.render.raster import render_depth_mesh

    est = lshape_estimator
    T, d, _ = _observe(est)
    rng = np.random.default_rng(5)
    Ts = np.stack([T] * 6).astype(np.float32)
    Ts[:, :3, 3] += rng.normal(0, 0.01, (6, 3)).astype(np.float32)
    Ts = torch.from_numpy(Ts)
    ri = est.intr.scaled(2)
    deps, o = render_windows(est._mesh_v, est._mesh_f, Ts, ri, (64, 128))
    for b in range(6):  # each window bit for bit the single render
        one = render_depth_mesh(est._mesh_v, est._mesh_f, Ts[b], ri, near=0.01, far=5.0,
                                origin=o[b].to(torch.float32), out_hw=(64, 128))
        assert torch.equal(deps[b], one)
    full = score_pose_candidates(est._mesh_v, est._mesh_f, Ts, d, d > 0, est.intr, (64, 128))
    for part in (slice(0, 3), slice(3, 6), slice(2, 3)):
        assert torch.equal(score_pose_candidates(est._mesh_v, est._mesh_f, Ts[part], d, d > 0,
                                                 est.intr, (64, 128)), full[part])
    assert torch.isfinite(full).all() and int(torch.argmin(full)) >= 0


def test_search_half_the_templates_equals_whole(lshape_estimator):
    from poseestimator_tpu_torch.pipeline import pose_estimator as pe

    est = lshape_estimator
    _, d, cloud = _observe(est)
    n = est._tpl_points.shape[0]
    gen = torch.Generator().manual_seed(0)
    draws = pe._search_draws(gen, cloud.points.shape[0], n, 1, est.intr, est.search_window, 2, False,
                             "mesh", torch.device("cpu"), None)
    kw = dict(win_hw=est.search_window, score_res=2, n_polish=1, n_final=None)
    prep = pe._prep_dst(*_dst(est, cloud), est.intr, d > 0, True, pe._f32(est.voxel_size), gen,
                        draws, score_res=2, dst_cap=est._search_cap)
    args = (est._mesh_v, est._mesh_f, est.intr, True, pe._f32(est.voxel_size), gen)
    whole = pe._score_templates(prep, est._tpl_points, est._tpl_valid, est._tpl_fpfh, *args,
                                draws, **kw)
    h = n // 2
    mine = {"ransac": draws["ransac"][:h],
            "views": {k: v for k, v in draws["views"].items() if k[1] < h}}
    half = pe._score_templates(prep, est._tpl_points[:h], est._tpl_valid[:h],
                               est._tpl_fpfh[:h], *args, mine, **kw)
    for a, b in zip(half, whole):
        assert torch.equal(a, b[:h])


def _dst(est, cloud):
    return cloud.points, cloud.valid
