"""Port parity, kernel K1 (fused nearest neighbour): the plain PyTorch
version against the JAX package's Pallas kernel in interpret mode and
against ``knn.nearest_neighbor``, on the cases of tests/test_pallas_nn.py.
Indices must be equal, distances within 1e-6 (both recompute the winner's
distance exactly), found flags equal. The CUDA kernel itself is held
against the plain version by tests/test_torch_kernels_cuda.py and by
chip_smoke.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poseestimator_tpu.geom3d.knn import nearest_neighbor as j_nearest_neighbor
from poseestimator_tpu.geom3d.pallas_nn import nn_pallas
from poseestimator_tpu_torch.geom3d import fused_nn as tnn
from poseestimator_tpu_torch.geom3d.knn import nearest_neighbor


def _both(q, qv, d, dv):
    pj = nn_pallas(jnp.asarray(q), jnp.asarray(qv), jnp.asarray(d), jnp.asarray(dv),
                   interpret=True)
    pt = tnn.fused_nn(torch.from_numpy(q), torch.from_numpy(qv),
                      torch.from_numpy(d), torch.from_numpy(dv))
    return [np.asarray(a) for a in pj], [a.numpy() for a in pt]


def _assert_same(pj, pt):
    np.testing.assert_array_equal(pt[1], pj[1])
    np.testing.assert_allclose(pt[0], pj[0], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(pt[2], pj[2])


@pytest.mark.parametrize("n,m", [(100, 300), (256, 512), (300, 700)])
def test_plain_matches_pallas_interpret(rng, n, m):
    q = rng.normal(size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(m, 3)).astype(np.float32)
    qv = rng.uniform(size=n) < 0.9
    dv = rng.uniform(size=m) < 0.8
    _assert_same(*_both(q, qv, d, dv))


def test_plain_matches_nearest_neighbor_mm_scale(rng):
    """mm-scale clouds 0.5 m from the origin, where the expanded distance
    form cancels hardest (the tracking regime)."""
    q = (rng.normal(size=(400, 3)) * 0.03 + [0, 0, 0.5]).astype(np.float32)
    d = (q + rng.normal(size=q.shape) * 0.002).astype(np.float32)[rng.permutation(400)]
    qv = np.ones(400, bool)
    dv = rng.uniform(size=400) < 0.9
    rj = [np.asarray(a) for a in j_nearest_neighbor(
        jnp.asarray(q), jnp.asarray(qv), jnp.asarray(d), jnp.asarray(dv))]
    rt = [a.numpy() for a in nearest_neighbor(
        torch.from_numpy(q), torch.from_numpy(qv), torch.from_numpy(d), torch.from_numpy(dv))]
    _assert_same(rj, rt)


def test_invalid_data_excluded(rng):
    q = rng.normal(size=(50, 3)).astype(np.float32)
    d = rng.normal(size=(128, 3)).astype(np.float32)
    d[0] = q[0]
    dv = np.ones(128, bool)
    dv[0] = False
    pj, pt = _both(q, np.ones(50, bool), d, dv)
    _assert_same(pj, pt)
    assert pt[1][0] != 0


def test_invalid_query_and_all_data_invalid(rng):
    q = rng.normal(size=(10, 3)).astype(np.float32)
    d = rng.normal(size=(64, 3)).astype(np.float32)
    qv = np.ones(10, bool)
    qv[3] = False
    pj, pt = _both(q, qv, d, np.ones(64, bool))
    _assert_same(pj, pt)
    assert not pt[2][3] and pt[0][3] == 0.0
    pj, pt = _both(q, np.ones(10, bool), d, np.zeros(64, bool))
    _assert_same(pj, pt)
    assert not pt[2].any()


def test_plain_chunking_is_exact(rng, monkeypatch):
    """The plain version's query chunking does not change any result."""
    q = rng.normal(size=(257, 3)).astype(np.float32)
    d = rng.normal(size=(129, 3)).astype(np.float32)
    qv, dv = np.ones(257, bool), rng.uniform(size=129) < 0.7
    args = [torch.from_numpy(a) for a in (q, qv, d, dv)]
    whole = tnn.fused_nn_plain(*args)
    monkeypatch.setattr(tnn, "_PLAIN_CHUNK_ELEMS", 129 * 10)
    chunked = tnn.fused_nn_plain(*args)
    for a, b in zip(whole, chunked):
        assert torch.equal(a, b)


def test_wrapper_rejects_bad_input():
    q = torch.zeros(4, 3)
    v3, v4 = torch.ones(3, dtype=torch.bool), torch.ones(4, dtype=torch.bool)
    with pytest.raises(TypeError):
        tnn.fused_nn(q.double(), v4, q, v4)
    with pytest.raises(ValueError):
        tnn.fused_nn(q, v3, q, v4)
