"""Port parity, the per-stage profilers (``apps/profile_stages.py``,
``apps/profile_search.py``), their bench scene (``apps/_scene.py``) and the
profiling hooks (``utils/profiling.py``). Tolerances, stated per test:

- the scene's arrays equal ``tools/_scene.py``'s for the same seed (surface
  samples, raster assets, poses bit for bit; the observed depth within
  1e-6 m, its silhouette equal);
- ``profile_stages``' deterministic prefixes against the JAX package's
  functions on the same inputs, with the port's seeded weights converted:
  letterbox within 1e-6, the network's heads within the YOLO parity
  tolerances (2e-4 + 1e-3 relative), decode within 5e-3 px, NMS and the
  mask on the port's own decoded outputs (equal decisions, boxes within
  1e-6; >= 99.9% of mask pixels), the windowed render and the observed
  back-projection within 1e-6;
- prefix 10 is the fused frame bit for bit, the full search prefix
  ``search_templates`` bit for bit, on the same draws;
- both tools' stage labels equal the JAX tools', letter for letter.
"""
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poseestimator_tpu import geom3d as g3
from poseestimator_tpu.models import yolo as Y
from poseestimator_tpu.models.yolo.weights import state_dict_to_variables
from poseestimator_tpu.pipeline.window import window_origin as j_window_origin
from poseestimator_tpu.render.raster import render_depth_mesh as j_render
from poseestimator_tpu.utils.profiling import StageTimer as JStageTimer
from poseestimator_tpu_torch.apps import _scene, profile_search, profile_stages
from poseestimator_tpu_torch.geom3d.camera import Intrinsics
from poseestimator_tpu_torch.models.yolo import weights as tweights
from poseestimator_tpu_torch.models.yolo.decode import decode_boxes
from poseestimator_tpu_torch.pipeline.window import window_origin
from poseestimator_tpu_torch.utils import profiling
from test_torch_yolo import _randomized
from torch_threads import two_threads  # noqa: F401

# tools/profile_stages.py:165-170
JAX_STAGES = ["dispatch_floor", "letterbox", "yolo_forward", "decode+nms", "assemble_mask",
              "render_depth(win)", "tpl_backproj+sample4k", "obs_backproject(win)",
              "obs_sample4k", "outlier_removal", "icp_dense"]
# tools/profile_search.py:266-272
JAX_HYP_SPLIT = ["prep (sample+voxel+FPFH dst, obs render)", "+match (mutual-NN FPFH x5)",
                 "+RANSAC 2048 x5", "+TEASER x5", "+PCA hypotheses (full block)"]
# tools/profile_search.py:274-282
JAX_LADDER = ["prep (sample+voxel+FPFH dst, obs render)",
              "+hypotheses (match+RANSAC2048+TEASER x5)", "+coarse ICP (25 chains, 30 it)",
              "+fine polish stage 1 (q-res, r=1.0v)", "+fine polish stage 2 (q-res, r=0.3v)",
              "+fine polish stage 3 (h-res, r=0.1v)", "+score+argmin (FULL)"]


def test_stage_labels_match_jax():
    assert list(profile_stages.STAGES) == JAX_STAGES
    assert [label for _, label in profile_search.HYP_SPLIT] == JAX_HYP_SPLIT
    assert [label for _, label in profile_search.LADDER] == JAX_LADDER
    # tools/profile_search.py:109-113: n_stages 1..7, hypotheses level 1..4
    assert [n for n, _ in profile_search.LADDER] == [(k, 4) for k in range(1, 8)]
    assert [n for n, _ in profile_search.HYP_SPLIT] == [(1, 4), (2, 1), (2, 2), (2, 3), (2, 4)]


def test_scene_arrays_match_jax():
    from tools._scene import box_mesh_arrays as j_box_mesh_arrays
    from tools._scene import box_surface as j_box_surface
    from tools._scene import make_light_scene as j_make_light_scene

    assert np.array_equal(_scene.box_surface(np.random.default_rng(3), 500),
                          j_box_surface(np.random.default_rng(3), 500))
    for a, b in zip(_scene.box_mesh_arrays(), j_box_mesh_arrays()):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    W, H = 160, 120
    got = _scene.make_light_scene(Intrinsics.from_fov(60.0, W, H), np.random.default_rng(0),
                                  "cpu")
    want = j_make_light_scene(g3.Intrinsics.from_fov(60.0, W, H), np.random.default_rng(0))
    names = ("cad_pts", "cad_valid", "mesh_v", "mesh_f", "T0", "T_obs")
    for name, a, b in zip(names, got[:6], want[:6]):
        assert np.array_equal(a.numpy(), np.asarray(b)), name
    np.testing.assert_allclose(got[6].numpy(), np.asarray(want[6]), rtol=0, atol=1e-6)
    assert np.array_equal(got[7].numpy(), np.asarray(want[7]))
    assert got[7].sum() > 100  # the box is in view


@pytest.fixture(scope="module")
def stages_profile():
    """The profiled frame at 640x480 (the auto 128 x 128 render window)
    with a 64-pixel letterbox, its network's batch statistics and biases
    randomised as in tests/test_torch_yolo.py (fresh ones put every mask
    logit near 0, where rounding alone flips the threshold)."""
    prof = profile_stages.Profile("cpu", res=(640, 480), imgsz=64)
    variables = _randomized(state_dict_to_variables(prof.frame.model.state_dict()), seed=4)
    tweights.load_variables(prof.frame.model, variables)
    prof.variables = variables
    return prof


def test_stages_prefixes_match_jax(stages_profile):
    prof = stages_profile
    f = prof.frame
    color = prof.color.numpy()
    # 1 letterbox
    lt = prof.prefix(1)
    lj, mj = Y.letterbox(jnp.asarray(color), 64)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0, atol=1e-6)
    # 2 the network, on the port's seeded weights converted
    traw = prof.prefix(2)
    jraw = jax.jit(lambda v, x: Y.YOLO11Seg(nc=5, scale="n").apply(v, x, train=False))(
        prof.variables, lj[None])
    for key in ("box", "cls", "mc"):
        for lvl in range(3):
            np.testing.assert_allclose(traw[key][lvl].numpy(), np.asarray(jraw[key][lvl]),
                                       atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(traw["proto"].numpy(), np.asarray(jraw["proto"]), atol=2e-4,
                               rtol=1e-3)
    bt, ct, mct = decode_boxes(traw)
    bj, cj, mcj = Y.decode_boxes(jraw)
    np.testing.assert_allclose(bt.numpy(), np.asarray(bj), atol=5e-3, rtol=1e-3)
    # 3 NMS on the port's own decoded outputs: the same decisions
    d = prof.prefix(3)
    dj = Y.nms(jnp.asarray(bt[0].numpy()), jnp.asarray(ct[0].numpy()),
               jnp.asarray(mct[0].numpy()), conf_thres=0.25, iou_thres=0.7, pre_nms=1024,
               max_det=32)
    n = int(dj.count())
    assert int(d.count()) == n >= 1
    np.testing.assert_allclose(d.boxes.numpy()[:n], np.asarray(dj.boxes)[:n], rtol=0, atol=1e-6)
    # 4 the top detection's mask, from the port's prototypes and coefficients
    _, mask = prof.prefix(4)
    mj4 = Y.assemble_masks(jnp.asarray(traw["proto"][0].numpy()),
                           jnp.asarray(d.coeffs[:1].numpy()), jnp.asarray(d.boxes[:1].numpy()),
                           jnp.asarray(d.valid[:1].numpy()), mj, 480, 640)[0]
    assert (mask.numpy() == np.asarray(mj4)).mean() >= 0.999
    # 5 the half-resolution render in its window, at the tracked pose
    jintr = g3.Intrinsics.from_fov(60.0, 640, 480)
    jintr_r = g3.Intrinsics(fx=jintr.fx / 2, fy=jintr.fy / 2, cx=jintr.cx / 2,
                            cy=jintr.cy / 2, width=320, height=240)
    assert prof.win == (128, 128)
    mv, mf, T0 = (jnp.asarray(t.numpy()) for t in (f.mesh_v, f.mesh_f.to(torch.int32), prof.T0))
    o_j = j_window_origin(mv, T0, jintr_r, *prof.win)
    o_t = window_origin(f.mesh_v, prof.T0, prof.intr.scaled(2), *prof.win)
    assert np.array_equal(o_t.numpy(), np.asarray(o_j))
    np.testing.assert_allclose(prof.prefix(5).numpy(), np.asarray(j_render(
        mv, mf, T0, jintr_r, near=0.01, far=5.0, origin=o_j.astype(jnp.float32),
        out_hw=prof.win)), rtol=0, atol=1e-6)
    # 7 the observed window back-projected under the detected mask OR the silhouette
    obs = prof.prefix(7)
    of = np.asarray(o_j) * 2
    sl = np.s_[of[1]:of[1] + 256, of[0]:of[0] + 256]
    want = g3.backproject_depth(jnp.asarray(prof.depth.numpy()[sl]), jintr,
                                mask=jnp.asarray((mask | prof.sil).numpy()[sl]),
                                depth_min=1e-6, origin=jnp.asarray(of))
    assert np.array_equal(obs.valid.numpy(), np.asarray(want.valid))
    v = obs.valid.numpy()
    assert v.sum() > 100
    np.testing.assert_allclose(obs.points.numpy()[v], np.asarray(want.points)[v], rtol=0,
                               atol=1e-6)


def test_prefix_10_is_the_fused_frame(stages_profile):
    for i in (0, 1):
        chk = stages_profile.check_prefix(i)
        assert chk["ok"]
        assert chk["pose_max_abs"] == 0.0 and chk["fitness_abs"] == 0.0
        assert chk["n_iters"][0] == chk["n_iters"][1] >= 1


def test_full_search_prefix_is_search_templates():
    prof = profile_search.SearchProfile("cpu", realistic=True, res=(128, 96))
    assert prof.tpl[0].shape[0] == 5
    chk = prof.check_full(3)
    assert chk["winner"][0] == chk["winner"][1]
    assert chk["pose_max_abs"] == 0.0 and chk["scores_max_abs"] == 0.0
    # the ladder's prefixes are the search's stages: the coarse prefix's
    # chains and the polish prefix's poses feed the full result
    assert prof.prefix(3, 4, 3).shape == (25, 4, 4)
    assert prof.prefix(2, 1, 3)[0].shape[0] == 5  # --hyp-split's match prefix


def test_stage_timer_takes_sync_as_jax():
    want = list(inspect.signature(JStageTimer.stage).parameters)
    assert list(inspect.signature(profiling.StageTimer.stage).parameters) == want
    timer = profiling.StageTimer()
    x = torch.ones(3)
    with timer.stage("host"):
        x = x + 1
    with timer.stage("synced", sync=x):
        x = x * 2
    with timer.stage("current card", sync=True):
        pass
    assert set(timer.timings_ms) == {"host", "synced", "current card"}
    assert all(t >= 0.0 for t in timer.timings_ms.values())
    calls, resets = [], []
    ms = profiling.time_calls(calls.append, 3, "cpu", after_warm=lambda: resets.append(len(calls)))
    assert calls == [0, 0, 0, 1, 2] and resets == [2] and ms >= 0.0
