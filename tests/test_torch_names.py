"""Port parity, the public names the port's modules define beside their
JAX counterparts: ``kabsch_T``, ``random_rotation`` (the JAX package's
normal draw injected), ``camera_eye_lookat_up_from_H``, ``bounding_box``,
``masked_min``, ``TemplateMetrics``, ``translate_key`` (every key of a
YOLO11n-seg state dict, and keys with no flax leaf) and ``load_checkpoint``
(an Ultralytics-style state dict in half precision, in memory and as a
``.pt`` file). Float32 throughout: each within 1e-5 of the JAX package's,
the keys and dataclass fields equal."""
from dataclasses import asdict, fields

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poseestimator_tpu.geom3d import cloud as jcloud
from poseestimator_tpu.geom3d import masked as jmasked
from poseestimator_tpu.geom3d import se3 as jse3
from poseestimator_tpu.models.yolo import weights as jweights
from poseestimator_tpu.registration.kabsch import kabsch_T as j_kabsch_T
from poseestimator_tpu.utils import metrics_log as jmetrics
from poseestimator_tpu_torch.geom3d import cloud as tcloud
from poseestimator_tpu_torch.geom3d import masked as tmasked
from poseestimator_tpu_torch.geom3d import se3 as tse3
from poseestimator_tpu_torch.models.yolo import weights as tweights
from poseestimator_tpu_torch.models.yolo.model import YOLO11Seg, init_random_
from poseestimator_tpu_torch.registration import kabsch as tkabsch
from poseestimator_tpu_torch.utils import metrics_log as tmetrics


def _t(a):
    return torch.from_numpy(np.array(a))


def test_kabsch_T(rng):
    src = rng.normal(size=(200, 3)).astype(np.float32)
    R = np.asarray(jse3.random_rotation(jax.random.PRNGKey(3)))
    dst = (src @ R.T + np.float32([0.1, -0.2, 0.3])).astype(np.float32)
    w = rng.uniform(0.1, 1.0, 200).astype(np.float32)
    Tj = np.asarray(j_kabsch_T(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w)))
    Tt = tkabsch.kabsch_T(_t(src), _t(dst), _t(w))
    assert Tt.shape == (4, 4) and Tt.dtype == torch.float32
    np.testing.assert_allclose(Tt.numpy(), Tj, atol=1e-5)
    np.testing.assert_allclose(Tt.numpy()[3], [0, 0, 0, 1])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_rotation(seed):
    """The JAX draw injected: the same rotation within 1e-5; drawn from a
    generator: a rotation (orthonormal, det +1)."""
    key = jax.random.PRNGKey(seed)
    q = np.asarray(jax.random.normal(key, (4,)))
    np.testing.assert_allclose(tse3.random_rotation(draw=_t(q)).numpy(),
                               np.asarray(jse3.random_rotation(key)), atol=1e-5)
    R = tse3.random_rotation(torch.Generator().manual_seed(seed)).double()
    np.testing.assert_allclose((R @ R.T).numpy(), np.eye(3), atol=1e-5)
    assert abs(float(torch.linalg.det(R)) - 1.0) < 1e-5


def test_camera_eye_lookat_up_from_H():
    for seed in range(3):
        H = np.eye(4, dtype=np.float32)
        H[:3, :3] = np.asarray(jse3.random_rotation(jax.random.PRNGKey(seed)))
        H[:3, 3] = [0.05 * seed, -0.1, 0.6]
        jo = jse3.camera_eye_lookat_up_from_H(jnp.asarray(H))
        to = tse3.camera_eye_lookat_up_from_H(_t(H))
        for a, b in zip(jo, to):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5)


def test_bounding_box(rng):
    pts = rng.normal(size=(50, 3)).astype(np.float32)
    valid = rng.uniform(size=50) < 0.7
    pts[~valid] = 100.0  # invalid rows must not count
    for v in (valid, np.zeros(50, bool)):
        jb = jcloud.bounding_box(jcloud.PointCloud(points=jnp.asarray(pts), valid=jnp.asarray(v)))
        tb = tcloud.bounding_box(tcloud.PointCloud(points=_t(pts), valid=_t(v)))
        for a, b in zip(jb, tb):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5)


def test_masked_min(rng):
    x = rng.normal(size=(6, 9)).astype(np.float32)
    m = rng.uniform(size=(6, 9)) < 0.5
    m[2] = False  # an all-masked row gives the fill
    for axis in (None, 0, 1):
        a = np.asarray(jmasked.masked_min(jnp.asarray(x), jnp.asarray(m), axis=axis))
        b = tmasked.masked_min(_t(x), _t(m), dim=axis).numpy()
        np.testing.assert_allclose(b, a, rtol=1e-5)
    np.testing.assert_allclose(
        tmasked.masked_min(_t(x), _t(m), dim=1, fill=-1.0).numpy(),
        np.asarray(jmasked.masked_min(jnp.asarray(x), jnp.asarray(m), axis=1, fill=-1.0)))


def test_template_metrics():
    assert [f.name for f in fields(tmetrics.TemplateMetrics)] == \
        [f.name for f in fields(jmetrics.TemplateMetrics)]
    args = (3, 120, 40, 38, 35)
    assert asdict(tmetrics.TemplateMetrics(*args)) == asdict(jmetrics.TemplateMetrics(*args))


@pytest.fixture(scope="module")
def ultralytics_sd():
    """A seeded YOLO11n-seg (nc 3) as an Ultralytics checkpoint stores it:
    half precision, with the fixed DFL projection."""
    m = init_random_(YOLO11Seg(nc=3, scale="n"), torch.Generator().manual_seed(0))
    sd = {k: (v.half() if v.is_floating_point() else v) for k, v in m.state_dict().items()}
    sd["model.23.dfl.conv.weight"] = torch.arange(16.0).view(1, 16, 1, 1).half()
    return sd


def test_translate_key(ultralytics_sd):
    keys = list(ultralytics_sd) + ["model.model.0.conv.weight", "model.model.23.cv2.0.2.bias",
                                   "foo.bar", "model.99.conv.weight", "model.23.cv9.0.weight"]
    for k in keys:
        assert tweights.translate_key(k) == jweights.translate_key(k), k
    assert tweights.translate_key("model.23.proto.upsample.weight") == (
        ("m23_proto", "upsample"), "deconv.weight")


def test_load_checkpoint(ultralytics_sd, tmp_path):
    """In memory and from a ``.pt`` file of ``{"model": state dict}``: the
    port's state dict equals the JAX package's flax variables mapped back
    (within 1e-5, float32); the DFL projection is dropped, and the result
    loads into the port model strictly."""
    path = tmp_path / "ultra.pt"
    torch.save({"model": ultralytics_sd}, path)
    for src in (ultralytics_sd, str(path)):
        sd = tweights.load_checkpoint(src)
        want = tweights.variables_to_state_dict(jweights.load_checkpoint(src))
        assert {k for k in sd if not k.endswith("num_batches_tracked")} == set(
            k for k in want if not k.endswith("num_batches_tracked"))
        for k, v in want.items():
            if not k.endswith("num_batches_tracked"):
                assert sd[k].dtype == torch.float32
                np.testing.assert_allclose(sd[k].numpy(), v.numpy(), atol=1e-5, err_msg=k)
        YOLO11Seg(nc=3, scale="n").load_state_dict(sd, strict=True)
