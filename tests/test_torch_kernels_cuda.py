"""The port's CUDA kernels against their plain PyTorch versions on a card:
K1 indices and found flags identical and distances within 1e-6, K2 max-1/z
images identical, and each wrapper counts exactly its own launches. The
``cuda``-marked cases need a card (the kernels have no CPU mode) and skip
without one.

This file imports no JAX, so it also runs where JAX is not installed:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py
"""
import pytest
import torch

from poseestimator_tpu_torch.geom3d import fused_nn as tnn
from poseestimator_tpu_torch.geom3d.camera import Intrinsics
from poseestimator_tpu_torch.render import raster as traster
from poseestimator_tpu_torch.render.mesh import make_icosphere


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("n,m,p", [(1000, 3000, 0.8), (4096, 4096, 1.0), (300, 20000, 0.5)])
def test_fused_nn_kernel_matches_plain(n, m, p):
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(n + m)
    q = torch.randn(n, 3, device="cuda", generator=g)
    d = torch.randn(m, 3, device="cuda", generator=g)
    qv = torch.rand(n, device="cuda", generator=g) < 0.9
    dv = torch.rand(m, device="cuda", generator=g) < p
    before = tnn.fused_nn_stats.launches
    kd, ki, kf = tnn.fused_nn(q, qv, d, dv)
    torch.cuda.synchronize()
    assert tnn.fused_nn_stats.launches == before + 1
    pd, pi, pf = tnn.fused_nn_plain(q, qv, d, dv)
    assert torch.equal(ki, pi) and torch.equal(kf, pf)
    assert float((kd - pd).abs().max()) <= 1e-6


@pytest.mark.cuda
def test_raster_kernel_matches_plain():
    _need_card()
    intr = Intrinsics(fx=300.0, fy=300.0, cx=80.0, cy=60.0, width=160, height=120)
    v, f = make_icosphere(0.08, 3)
    T = torch.eye(4, device="cuda")
    T[2, 3] = 0.5
    coef, bbox = traster.face_coeffs(torch.from_numpy(v).cuda(), torch.from_numpy(f).cuda(),
                                     T, intr, origin=torch.tensor([40.0, 20.0], device="cuda"))
    before = traster.raster_stats.launches
    izk = traster.raster(coef, bbox, 64, 96)
    torch.cuda.synchronize()
    assert traster.raster_stats.launches == before + 1
    izp = traster.raster_plain(coef, 64, 96)
    assert torch.equal(izk, izp)
    assert int((izk > 0).sum()) > 1000


def test_wrappers_raise_on_other_devices():
    """A tensor on neither the CPU nor a CUDA card is an error, never a
    silent detour through the plain version."""
    q = torch.zeros(4, 3, device="meta")
    v = torch.ones(4, dtype=torch.bool, device="meta")
    with pytest.raises(RuntimeError):
        tnn.fused_nn(q, v, q, v)
    with pytest.raises(RuntimeError):
        traster.raster(torch.zeros(8, 12, device="meta"), torch.zeros(8, 4, device="meta"), 8, 8)
