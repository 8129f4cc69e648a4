"""The batched registration's sums over points, independent of the batch:
``kabsch.tree_sum`` (the order the card uses, a pairwise tree fixed by the
point count) and, at the template search's shapes (80 chains x 128 points,
16 x 768, 16 x 2048), ``kabsch_batched`` and ``icp_point_to_point_batched``
giving each chain the same bits in the whole batch and in half of it, both
as the CPU computes them (the plain sums) and in the card's order
(``kabsch.fixed_order`` forced on), which stays within 1e-5 of the plain
one. ``tests/test_torch_kernels_cuda.py`` holds the same on the card."""
import numpy as np
import pytest
import torch

from poseestimator_tpu_torch.geom3d.cloud import PointCloud
from poseestimator_tpu_torch.registration import kabsch as K
from poseestimator_tpu_torch.registration.icp import icp_point_to_point_batched
from torch_threads import two_threads  # noqa: F401

SHAPES = [(80, 128), (16, 768), (16, 2048)]


@pytest.fixture(params=[False, True], ids=["plain", "card order"])
def card_order(request, monkeypatch):
    if request.param:
        monkeypatch.setattr(K, "fixed_order", lambda x: True)
    return request.param


@pytest.mark.parametrize("n", [1, 3, 128, 768, 1000, 2048])
def test_tree_sum_is_row_independent_and_accurate(n):
    g = torch.Generator().manual_seed(n)
    x = torch.randn(16, n, 3, generator=g)
    s = K.tree_sum(x, -2)
    for b in (0, 7, 15):
        assert torch.equal(K.tree_sum(x[b:b + 1], -2)[0], s[b])
    assert torch.equal(K.tree_sum(x[:8], -2), s[:8])
    exact = x.double().sum(-2)
    assert (s.double() - exact).abs().max() <= 2 * n * 2.0 ** -24 * x.abs().max()
    assert torch.equal(K.tree_sum(x.transpose(1, 2), -1), s)


def _chains(B, N, seed):
    """B chains of N points sampled from one box surface, each from its own
    perturbed start, and the destination cloud (2048 points)."""
    rng = np.random.default_rng(seed)
    face = rng.integers(0, 3, 4096)
    half = np.array([0.06, 0.04, 0.025])
    p = rng.uniform(-1, 1, (4096, 3)) * half
    p[np.arange(4096), face] = np.sign(p[np.arange(4096), face]) * half[face]
    p = p.astype(np.float32)
    dst = PointCloud(points=torch.from_numpy(p[:2048]), valid=torch.ones(2048, dtype=torch.bool))
    src = np.stack([p[rng.choice(4096, N, replace=False)] for _ in range(B)])
    valid = rng.uniform(size=(B, N)) < 0.95
    T0 = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    for b in range(B):
        a = rng.normal(size=3) * 0.03
        c, s = np.cos(a[2]), np.sin(a[2])
        T0[b, :3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
        T0[b, :3, 3] = rng.normal(size=3) * 0.004
    return torch.from_numpy(src), torch.from_numpy(valid), dst, torch.from_numpy(T0)


@pytest.mark.parametrize("B,N", SHAPES)
def test_kabsch_batched_per_chain(B, N, card_order):
    src, valid, _, T0 = _chains(B, N, B + N)
    dst = src @ T0[:, :3, :3].transpose(-1, -2) + T0[:, None, :3, 3]
    w = valid.float()
    R, t = K.kabsch_batched(src, dst, w)
    h = B // 2
    Rh, th = K.kabsch_batched(src[:h], dst[:h], w[:h])
    assert torch.equal(Rh, R[:h]) and torch.equal(th, t[:h])
    R1, t1 = K.kabsch_batched(src[3:4], dst[3:4], w[3:4])
    assert torch.equal(R1[0], R[3]) and torch.equal(t1[0], t[3])
    np.testing.assert_allclose(R.numpy(), T0[:, :3, :3].numpy(), atol=1e-5)
    if card_order:  # the card's order against the CPU's plain sums
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(K, "fixed_order", lambda x: False)
            Rp, tp = K.kabsch_batched(src, dst, w)
        np.testing.assert_allclose(R.numpy(), Rp.numpy(), atol=1e-5)
        np.testing.assert_allclose(t.numpy(), tp.numpy(), atol=1e-5)


@pytest.mark.parametrize("B,N", SHAPES)
def test_icp_batched_per_chain(B, N, card_order):
    src, valid, dst, T0 = _chains(B, N, 2 * B + N)
    kw = dict(max_corr_dist=0.02, max_iterations=30, relative_fitness=1e-6, relative_rmse=1e-6)
    r = icp_point_to_point_batched(src, valid, dst, init_T=T0, **kw)
    h = B // 2
    rh = icp_point_to_point_batched(src[:h], valid[:h], dst, init_T=T0[:h], **kw)
    assert torch.equal(rh.T, r.T[:h])
    assert torch.equal(rh.n_iters, r.n_iters[:h])
    assert torch.equal(rh.fitness, r.fitness[:h]) and torch.equal(rh.inlier_rmse, r.inlier_rmse[:h])
    assert int(r.n_iters.max()) >= 3
