"""Detector weights made by the benchmark from the run's seed, on the device,
in one draw: conv kernels ~ N(0, 1 / fan_in), BatchNorm at identity, head
biases 0 and the box head's DFL bias 1.0 (the law of the port's
``init_random_``, whose class scores straddle 0.5 so that NMS sees real
candidates). The names and shapes are those of the port's ``YOLO11Seg``
state dict, read from a copy built on the meta device; the values are the
benchmark's, handed alike to the program and to the reference."""
from __future__ import annotations

import math

import torch


def yolo_state_dict(nc: int, scale: str, seed: int, device) -> dict:
    from poseestimator_tpu_torch.models.yolo.model import YOLO11Seg

    with torch.device("meta"):
        shapes = {k: (v.shape, v.dtype) for k, v in YOLO11Seg(nc=nc, scale=scale)
                  .state_dict().items()}
    kernels = [k for k, (s, _) in shapes.items() if len(s) == 4]
    total = sum(math.prod(shapes[k][0]) for k in kernels)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    sd, at = {}, 0
    for k, (shape, dtype) in shapes.items():
        if len(shape) == 4:
            n = math.prod(shape)
            sd[k] = (flat[at:at + n].view(shape) / math.sqrt(n // shape[0])).contiguous()
            at += n
        elif k.endswith(("bn.weight", "running_var")):
            sd[k] = torch.ones(shape, dtype=dtype, device=device)
        else:
            sd[k] = torch.zeros(shape, dtype=dtype, device=device)
    for i in range(3):
        sd[f"model.23.cv2.{i}.2.bias"].fill_(1.0)
    return sd
