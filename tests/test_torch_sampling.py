"""Port parity, sampling and outlier removal. The test rebuilds the JAX
package's random draws from its key (the splits of geom3d/sampling.py) and
injects them into the port, so the selected indices must be identical and
the exact-count guarantee must hold on both routes. Outlier removal: keep
masks identical to the JAX path with ``approx=False`` and ``approx=True``
(on the CPU ``approx_min_k`` is exact)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poseestimator_tpu.geom3d import sampling as jsamp
from poseestimator_tpu.geom3d.cloud import PointCloud as JCloud
from poseestimator_tpu.geom3d.outliers import remove_statistical_outlier as j_sor
from poseestimator_tpu_torch.geom3d.cloud import PointCloud
from poseestimator_tpu_torch.geom3d.outliers import remove_statistical_outlier
from poseestimator_tpu_torch.geom3d.sampling import random_sample, uses_stratified
from torch_threads import two_threads  # noqa: F401


def jax_draws(key, capacity: int, n: int):
    """The Gumbel scores and uniform offset random_sample draws from key."""
    n = min(n, capacity)
    if capacity >= 8 * n:
        kg, ku = jax.random.split(key)
        return (np.asarray(jax.random.gumbel(kg, (capacity,), jnp.float32)),
                np.asarray(jax.random.uniform(ku, ())))
    return np.asarray(jax.random.gumbel(key, (capacity,))), None


def _inject(draws):
    g, u = draws
    return torch.from_numpy(np.array(g)), None if u is None else torch.from_numpy(np.array(u))


def _sample_both(pts, valid, n, seed):
    key = jax.random.PRNGKey(seed)
    js = jax.jit(jsamp.random_sample, static_argnums=2)(
        key, JCloud(points=jnp.asarray(pts), valid=jnp.asarray(valid)), n)
    ts = random_sample(PointCloud(points=torch.from_numpy(pts), valid=torch.from_numpy(valid)),
                       n, draws=_inject(jax_draws(key, len(pts), n)))
    return js, ts


@pytest.mark.parametrize("cap,n,frac", [
    (500, 100, 0.5),     # top-k route
    (300, 400, 0.7),     # n > capacity: clamps, keeps every valid point
    (4096, 256, 0.3),    # stratified route
    (5000, 600, 0.02),   # stratified, fewer valid points than n
])
def test_random_sample_matches_with_injected_draws(rng, cap, n, frac):
    pts = rng.normal(size=(cap, 3)).astype(np.float32)
    valid = rng.uniform(size=cap) < frac
    js, ts = _sample_both(pts, valid, n, seed=cap + n)
    np.testing.assert_array_equal(ts.valid.numpy(), np.asarray(js.valid))
    np.testing.assert_array_equal(ts.points.numpy(), np.asarray(js.points))
    assert int(ts.count()) == min(int(valid.sum()), n)


def test_stratified_exact_count_on_clustered_mask():
    """A raster-clustered validity mask (starved bins) keeps exactly n."""
    H, W = 120, 160
    vm = np.zeros(H * W, bool)
    for r in range(30, 90):
        vm[r * W + 40: r * W + 100] = True  # 3600 clustered pixels
    pts = np.zeros((H * W, 3), np.float32)
    pts[:, 0] = np.arange(H * W)
    assert uses_stratified(H * W, 2048)
    js, ts = _sample_both(pts, vm, 2048, seed=9)
    np.testing.assert_array_equal(ts.points.numpy(), np.asarray(js.points))
    assert int(ts.count()) == 2048 == int(js.count())
    assert vm[ts.points.numpy()[ts.valid.numpy(), 0].astype(int)].all()


def test_generator_draws_keep_the_contract():
    g = torch.Generator().manual_seed(0)
    valid = torch.rand(20000, generator=g) < 0.3
    pts = torch.arange(20000, dtype=torch.float32)[:, None].repeat(1, 3)
    out = random_sample(PointCloud(points=pts, valid=valid), 1000, generator=g)
    sel = out.points[out.valid, 0].long()
    assert int(out.count()) == 1000 and valid[sel].all() and len(set(sel.tolist())) == 1000


@pytest.mark.parametrize("approx", [False, True])
def test_statistical_outlier_keep_mask(rng, approx):
    pts = (rng.normal(size=(600, 3)) * 0.02 + [0, 0, 0.5]).astype(np.float32)
    pts[:40] += rng.normal(size=(40, 3)).astype(np.float32) * 0.05  # outliers
    valid = rng.uniform(size=600) < 0.9
    jk = j_sor(JCloud(points=jnp.asarray(pts), valid=jnp.asarray(valid)), 20, 1.0,
               approx=approx)
    tk = remove_statistical_outlier(
        PointCloud(points=torch.from_numpy(pts), valid=torch.from_numpy(valid)), 20, 1.0)
    np.testing.assert_array_equal(tk.valid.numpy(), np.asarray(jk.valid))
    assert 0 < int(tk.count()) < int(valid.sum())
