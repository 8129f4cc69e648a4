"""Device resolution and the numeric policy of the port.

Geometry runs in float32 end to end, and no float32 product may be rounded
to TF32: a reduced-mantissa cross term mis-assigns most nearest neighbours
at millimetre point scales (the JAX package measured 88% with bf16, and TF32
keeps the same 10-bit mantissa). PyTorch leaves cuDNN convolutions in TF32
by default, so the policy switches both flags off.

Entry points take ``device`` and default to ``"cuda"``. A caller that wants
the CPU says so; a missing card is an error, never a silent fallback.
"""
from __future__ import annotations

import torch


def set_numeric_policy() -> None:
    """Full float32 matrix products and convolutions on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on; raises when CUDA is asked for and
    absent. Applies the numeric policy as a side effect."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path")
    set_numeric_policy()
    return dev
