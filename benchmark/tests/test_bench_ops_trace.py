"""The counted ops against hand counts at small shapes, and the trace reader
and the metric arithmetic on a synthetic event list."""
from __future__ import annotations

from types import SimpleNamespace

import pytest
import torch

from benchmark.harness import peaks, readings, registry, trace


def test_k1_counts_valid_pairs_and_bytes():
    op = registry.module("ops", "k1_nn")
    qv = torch.tensor([True, True, False, True])  # 3 valid queries of 4
    dv = torch.tensor([True, False, True, True, True, False])  # 4 valid of 6
    ops, nbytes = op.count(op.capture(None, qv, None, dv))
    assert ops == 9 * 3 * 4
    assert nbytes == 13 * (4 + 6) + 13 * 4
    qb = torch.tensor([[True, True], [True, False]])  # batched: 2 and 1 valid
    db = torch.tensor([[True, True, True], [True, True, False]])  # 3 and 2 valid
    ops, _ = op.count(op.capture(None, qb, None, db))
    assert ops == 9 * (2 * 3 + 1 * 2)


def test_k2_counts_covered_pairs():
    op = registry.module("ops", "k2_raster")
    # xmin, xmax, ymin, ymax: pixels 1..3 x 2..3 -> 3 x 2; one empty; one clipped to 0..1 x 0..0
    bbox = torch.tensor([[0.5, 3.2, 1.1, 3.0], [1e9, -1e9, 1e9, -1e9], [-5.0, 1.5, -2.0, 0.0]])
    ops, nbytes = op.count(op.capture(None, bbox, 4, 5))
    assert ops == 20 * (3 * 2 + 0 + 2 * 1)
    assert nbytes == 64 * 3 + 4 * 4 * 5


def test_yolo_forward_count_from_shapes():
    from torch.utils.flop_counter import FlopCounterMode

    from benchmark.reference import yolo

    op = registry.module("ops", "yolo11_forward")
    from poseestimator_tpu_torch.models.yolo.model import YOLO11Seg

    model = YOLO11Seg(nc=5, scale="n")
    flops, nbytes = op.count(op.capture(model, torch.empty(1, 3, 640, 640)))
    # YOLO11n-seg at 640: Ultralytics' table gives 10.4 GFLOPs (with DFL)
    assert 8e9 < flops < 13e9
    assert nbytes > 4 * sum(p.numel() for p in model.parameters())
    sd = {k: torch.empty(v.shape, device="meta") for k, v in model.state_dict().items()}
    with FlopCounterMode(display=False) as fc:
        yolo.conv(sd, "model.0", torch.empty(1, 3, 640, 640, device="meta"), 2)
    assert fc.get_total_flops() == 2 * 3 * 9 * 16 * 320 * 320


EVENTS = [("fused_nn_kernel", 1000, 100), ("Memcpy HtoD", 1050, 100),
          ("raster_kernel", 1500, 50), ("fused_nn_kernel", 2000, 200),
          ("Memset", 2100, 10)]


def test_trace_reader():
    assert trace.kernel_count(EVENTS) == 3
    assert trace.busy_ns(EVENTS) == 150 + 50 + 200
    assert trace.matching_ns(EVENTS, ("fused_nn_kernel",)) == 300
    top = trace.top_ops(EVENTS)
    assert top[0] == ["fused_nn_kernel", 300e-9]


def test_readings_on_a_synthetic_slice():
    k1 = registry.module("ops", "k1_nn")
    r = SimpleNamespace(unit="frame", events=EVENTS, slice_steps=2, slice_s=2e-6,
                        before_steps=10, before_s=1.0, ops={"k1_nn": k1},
                        counted={"k1_nn": [(9e6, 1e3), (9e6, 1e3)]}, counters={}, step_s=[])
    least = 2 * peaks.least_s(9e6, 1e3)
    assert readings.roofline_pct(r, "k1_nn") == pytest.approx(100 * least / 300e-9)
    assert readings.launches(r) == 1.5
    assert readings.idle_pct(r) == pytest.approx(100 * (1 - 400e-9 / 2e-6))
    assert readings.mfu_pct(r) == pytest.approx(100 * 9e6 * 10 / (1.0 * peaks.F32_FLOPS))
    assert readings.roofline_pct(r, "k2_raster") is None
    # both halves of a split quantity take its one reader
    for name in ("k1_roofline.init", "k1_roofline.frame"):
        assert registry.module("metrics", name).read(r) == readings.roofline_pct(r, "k1_nn")


def test_idle_gaps_go_to_the_innermost_open_stage():
    from benchmark.harness.spans import label_gaps

    # the mark's fill starts on the device 1000 ns after its launch on the host (t=0)
    events = [("FillFunctor", 1000, 10), ("k", 1100, 100), ("k", 1500, 100), ("k", 2600, 10)]
    spans = [("request", 0, 3000), ("track.step", 50, 900), ("track.icp", 300, 700)]
    got = dict(map(tuple, label_gaps(events, spans, 0)))
    # gaps: 1010-1100 (mid 55 -> track.step), 1200-1500 (mid 350 -> track.icp),
    # 1600-2600 (mid 1100 -> request)
    assert got == {"track.step": 90e-9, "track.icp": 300e-9, "request": 1000e-9}
