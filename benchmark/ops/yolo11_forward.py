"""The detector's work: one YOLO11-seg forward, counted from its layers'
shapes.

The operations are the convolutions' and the attention's multiply-adds,
twice each, as ``torch.utils.flop_counter`` counts them over the
reference's forward (``reference/yolo.py``) on meta tensors of the model's
weight shapes and the input's shape: no data, no device. The bytes are the
weights and the input read once and the head's outputs written once. No
kernel is mapped to it (the forward is many library kernels), so it enters
the whole step's ``mfu`` and no roofline."""
from __future__ import annotations

from functools import lru_cache

KERNELS = ()
TARGETS = (("poseestimator_tpu_torch.models.yolo.model", "YOLO11Seg.forward"),)


def capture(model, x, *args, **kwargs):
    return model, tuple(x.shape)


@lru_cache(maxsize=8)
def _count(shapes: tuple, x_shape: tuple) -> tuple[float, float]:
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from benchmark.reference import yolo

    with torch.device("meta"):
        sd = {k: torch.empty(s) for k, s in shapes}
        x = torch.empty(x_shape)
        with FlopCounterMode(display=False) as fc:
            out = yolo.forward(sd, x)
    n_out = sum(t.numel() for key in ("box", "cls", "mc") for t in out[key])
    n_out += out["proto"].numel()
    n_w = sum(torch.Size(s).numel() for k, s in shapes if not k.endswith("num_batches_tracked"))
    return float(fc.get_total_flops()), 4.0 * (n_w + torch.Size(x_shape).numel() + n_out)


def count(cap) -> tuple[float, float]:
    model, x_shape = cap
    return _count(tuple((k, tuple(v.shape)) for k, v in model.state_dict().items()), x_shape)
