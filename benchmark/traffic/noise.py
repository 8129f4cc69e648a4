"""Depth-sensor noise: Gaussian with a standard deviation that grows with
the square of the depth, sigma = coef * z^2 (the form of
``poseestimator_tpu_torch/templates/creation.py::add_depth_dependent_noise``,
here drawn on the device from the run's generator).

RealSense D400 data sheet: depth RMS error <= 2% at 2 m, i.e. coef 0.01 /m
(2.5 mm at 0.5 m). Kinect v1 (Khoshelham & Oude Elberink, Sensors 2012):
sigma ~ 1.43e-3 z^2 m, taken as coef 0.0016 /m.
"""
from __future__ import annotations

import torch


def add_noise(depth: torch.Tensor, coef: float, gen: torch.Generator) -> torch.Tensor:
    """``depth`` (..., H, W) metres with noise where it is > 0, clipped at 0."""
    n = torch.randn(depth.shape, generator=gen, device=depth.device, dtype=torch.float32)
    noisy = torch.where(depth > 0, depth + n * (coef * depth * depth), depth)
    return torch.clamp(noisy, min=0.0)
