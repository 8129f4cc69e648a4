"""Port parity, kernel K2 (triangle z-buffer): ``face_coeffs`` within 1e-6
relative to the magnitude of the products each face's coefficients are
formed from (XLA on the CPU contracts them into fused multiply-adds, so
cancelling coefficients differ in their last bits), and the plain raster
against the JAX package's ``render_depth_mesh`` with ``backend="xla"`` and
``"pallas_interpret"`` on the fixtures of tests/test_raster.py: coverage
identical, depth within 1e-6 m. The CUDA kernel is held against the plain
version by tests/test_torch_kernels_cuda.py and by chip_smoke.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poseestimator_tpu import geom3d as g3
from poseestimator_tpu.render import raster as jraster
from poseestimator_tpu.render.mesh import make_icosphere as j_icosphere
from poseestimator_tpu_torch.geom3d.camera import Intrinsics
from poseestimator_tpu_torch.render import raster as traster
from poseestimator_tpu_torch.render.mesh import make_icosphere, pad_faces

from helpers import box_mesh

J_INTR = g3.Intrinsics(fx=300.0, fy=300.0, cx=80.0, cy=60.0, width=160, height=120)
T_INTR = Intrinsics(fx=300.0, fy=300.0, cx=80.0, cy=60.0, width=160, height=120)


def _T(z):
    T = np.eye(4, dtype=np.float32)
    T[2, 3] = z
    return T


def _rotated(vf, seed):
    """Vertices rotated in numpy float32, so both packages start from the
    same camera-frame vertices: their 3x3 matmuls round differently in the
    last bit, and the plane setup amplifies that to ~1e-5 m at silhouettes."""
    v, f = vf
    q = np.random.default_rng(seed).normal(size=4)
    R = np.asarray(g3.quat_to_R(jnp.asarray(q / np.linalg.norm(q), jnp.float32)))
    return (v @ R.T).astype(np.float32), f


def _render_both(v, f, T, backend, **kw):
    jkw = dict(kw)
    tkw = dict(kw)
    if "origin" in kw:
        jkw["origin"] = jnp.asarray(kw["origin"])
        tkw["origin"] = torch.tensor(kw["origin"])
    dj = np.asarray(jraster.render_depth_mesh(
        jnp.asarray(v), jnp.asarray(f), jnp.asarray(T), J_INTR, backend=backend, **jkw))
    dt = traster.render_depth_mesh(torch.from_numpy(v), torch.from_numpy(f),
                                   torch.from_numpy(T), T_INTR, **tkw).numpy()
    return dj, dt


def _assert_same(dj, dt):
    np.testing.assert_array_equal(dt > 0, dj > 0)
    np.testing.assert_allclose(dt, dj, rtol=0, atol=1e-6)


def _box(sx, sy, sz):
    m = box_mesh(sx, sy, sz)
    return m.vertices, m.faces


FIXTURES = {
    # tests/test_raster.py: cube front face (exact plane)
    "plane": lambda: (*_box(0.2, 0.2, 0.2), _T(0.6), {}),
    # slanted quad
    "slanted": lambda: (
        np.array([[-0.2, -0.2, 0.5 - 0.06 - 0.04], [0.2, -0.2, 0.5 + 0.06 - 0.04],
                  [0.2, 0.2, 0.5 + 0.06 + 0.04], [-0.2, 0.2, 0.5 - 0.06 + 0.04]],
                 np.float32),
        np.array([[0, 1, 2], [0, 2, 3]], np.int32), np.eye(4, dtype=np.float32), {}),
    # sphere (4 subdivisions, 5120 faces)
    "sphere": lambda: (*make_icosphere(0.1, 4), _T(0.5), {}),
    # rotated box and icosphere of the backend-parity test
    "rotated_box": lambda: (*_rotated(_box(0.15, 0.1, 0.08), 5), _T(0.55), {}),
    "rotated_sphere": lambda: (*_rotated(make_icosphere(0.08, 2), 5), _T(0.55), {}),
    # window crop
    "window": lambda: (*_box(0.12, 0.12, 0.12), _T(0.5),
                       {"origin": np.array([40.0, 20.0], np.float32), "out_hw": (64, 64)}),
    # padded faces are inert
    "padded": lambda: (box_mesh(0.1, 0.1, 0.1).vertices,
                       pad_faces(box_mesh(0.1, 0.1, 0.1).faces, 64), _T(0.5), {}),
    # hidden-surface removal
    "hidden": lambda: (*_box(0.2, 0.2, 0.2), _T(0.7), {}),
}


def test_icosphere_matches_jax():
    v, f = make_icosphere(0.1, 3)
    m = j_icosphere(0.1, 3)
    np.testing.assert_array_equal(v, m.vertices)
    np.testing.assert_array_equal(f, m.faces)


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_face_coeffs_match(name):
    v, f, T, kw = FIXTURES[name]()
    origin = kw.get("origin")
    cj, bj = jraster.face_coeffs(jnp.asarray(v), jnp.asarray(f), jnp.asarray(T), J_INTR,
                                 origin=None if origin is None else jnp.asarray(origin))
    ct, bt = traster.face_coeffs(torch.from_numpy(v), torch.from_numpy(f),
                                 torch.from_numpy(T), T_INTR,
                                 origin=None if origin is None else torch.tensor(origin))
    # per-face scale: |x| |y| / |2A| of the projected vertices, times 1/z
    bj = np.asarray(bj)
    ext = np.maximum(np.abs(bj[:2]).max(0), 1.0) * np.maximum(np.abs(bj[2:]).max(0), 1.0)
    cj = np.asarray(cj)
    twoA = np.abs(cj[0] * (bj[1] - bj[0]) + cj[1] * (bj[3] - bj[2])) + 1e-9
    scale = np.maximum(ext / twoA, 1.0) * (1.0 + np.abs(cj[9:]).max(0))
    live = cj[2] > -1e29
    err = np.abs(ct.numpy().T - cj)[:, live]
    assert (err <= 1e-6 * scale[live]).all(), float((err / scale[live]).max())
    np.testing.assert_array_equal(ct.numpy()[~live, 2], cj[2, ~live])
    np.testing.assert_allclose(bt.numpy().T, bj, rtol=1e-6, atol=1e-6)


SPHERES = ("rotated_sphere", "sphere")
FLAT = sorted(n for n in FIXTURES if n not in SPHERES)


@pytest.mark.parametrize("name,backend", [(n, b) for n in FLAT
                                          for b in ("xla", "pallas_interpret")])
def test_plain_raster_matches_jax(name, backend):
    v, f, T, kw = FIXTURES[name]()
    dj, dt = _render_both(v, f, T, backend, **kw)
    assert (dt > 0).sum() > 100
    _assert_same(dj, dt)


@pytest.mark.parametrize("name", SPHERES)
def test_sphere_raster_matches_jax(name):
    """Spheres hold sliver faces at the silhouette, whose 1/z planes are
    ill-conditioned: under ``jit`` XLA on the CPU fuses the face setup into
    multiply-adds, which moves such a plane far beyond 1e-6 m at grazing
    pixels (away from the analytic depth, not toward it). So the jitted ``render_depth_mesh(backend="xla")`` must give identical
    coverage, and the depth is held to 1e-6 m against the same JAX
    functions run op by op (the face setup eagerly, then ``_render_xla``),
    which round as the port does."""
    v, f, T, _ = FIXTURES[name]()
    dj, dt = _render_both(v, f, T, "xla")
    np.testing.assert_array_equal(dt > 0, dj > 0)
    cj, _ = jraster.face_coeffs(jnp.asarray(v), jnp.asarray(f), jnp.asarray(T), J_INTR)
    izj = np.asarray(jraster._render_xla(cj, 120, 160))
    de = np.where(izj > 1.0 / 100.0, 1.0 / np.maximum(izj, 1e-30), 0.0)
    _assert_same(de, dt)


def test_sphere_depth_sub_mm():
    """The port's own render against the closed-form ray-sphere depth: < 1 mm
    away from grazing incidence (the bar of tests/test_raster.py)."""
    r, zc = 0.1, 0.5
    v, f = make_icosphere(r, 4)
    d = traster.render_depth_mesh(torch.from_numpy(v), torch.from_numpy(f),
                                  torch.from_numpy(_T(zc)), T_INTR).numpy()
    vv, uu = np.nonzero(d > 0)
    ray = np.stack([(uu - 80.0) / 300.0, (vv - 60.0) / 300.0, np.ones(len(uu))], 1)
    a = (ray ** 2).sum(1)
    disc = 4 * zc * zc - 4 * a * (zc * zc - r * r)
    t = (2 * zc - np.sqrt(np.maximum(disc, 0.0))) / (2 * a)
    n = (t[:, None] * ray - [0, 0, zc]) / r
    cosang = -(n * ray / np.linalg.norm(ray, axis=1, keepdims=True)).sum(1)
    interior = (disc > 0) & (cosang > 0.3)
    assert interior.sum() > 1500
    assert np.abs(d[vv, uu][interior] - t[interior]).max() < 1e-3


def test_wrapper_rejects_bad_input():
    with pytest.raises(ValueError):
        traster.raster(torch.zeros(8, 11), torch.zeros(8, 4), 16, 16)
    with pytest.raises(TypeError):
        traster.raster(torch.zeros(8, 12, dtype=torch.float64), torch.zeros(8, 4), 16, 16)
