"""Plain PyTorch forward of YOLO11-seg (Ultralytics ``yolo11-seg.yaml``) from
a state dict in Ultralytics' ``model.{i}...`` numbering: the reference the
detector's raw outputs are held to.

Every block is written out as functional calls on the weights the benchmark
made: a ``Conv`` is conv (no bias, 'same' padding) + BatchNorm (eps 1e-3,
running statistics) + SiLU. Channel counts, group counts and repeats are read
from the weights' shapes; the attention's head count is the architecture's
rule, max(c // 64, 1). Returns the head's outputs in NHWC: ``box``, ``cls``
and ``mc`` per level and ``proto``.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _has(sd, prefix):
    return any(k.startswith(prefix) for k in sd)


def conv(sd, p, x, stride=1, act=True):
    w = sd[p + ".conv.weight"]
    g = x.shape[1] // w.shape[1]
    y = F.conv2d(x, w, None, stride, w.shape[-1] // 2, 1, g)
    y = F.batch_norm(y, sd[p + ".bn.running_mean"], sd[p + ".bn.running_var"],
                     sd[p + ".bn.weight"], sd[p + ".bn.bias"], False, 0.0, 1e-3)
    return F.silu(y) if act else y


def bottleneck(sd, p, x):
    y = conv(sd, p + ".cv2", conv(sd, p + ".cv1", x))
    return x + y if x.shape[1] == y.shape[1] else y


def c3k(sd, p, x):
    a = conv(sd, p + ".cv1", x)
    i = 0
    while _has(sd, f"{p}.m.{i}."):
        a = bottleneck(sd, f"{p}.m.{i}", a)
        i += 1
    return conv(sd, p + ".cv3", torch.cat((a, conv(sd, p + ".cv2", x)), 1))


def c3k2(sd, p, x):
    y = list(conv(sd, p + ".cv1", x).chunk(2, 1))
    i = 0
    while _has(sd, f"{p}.m.{i}."):
        q = f"{p}.m.{i}"
        y.append(c3k(sd, q, y[-1]) if _has(sd, q + ".cv3.") else bottleneck(sd, q, y[-1]))
        i += 1
    return conv(sd, p + ".cv2", torch.cat(y, 1))


def sppf(sd, p, x):
    y = [conv(sd, p + ".cv1", x)]
    for _ in range(3):
        y.append(F.max_pool2d(y[-1], 5, 1, 2))
    return conv(sd, p + ".cv2", torch.cat(y, 1))


def attention(sd, p, x):
    B, C, H, W = x.shape
    heads = max(C // 64, 1)
    head_dim = C // heads
    key_dim = head_dim // 2
    q, k, v = conv(sd, p + ".qkv", x, act=False).view(B, heads, 2 * key_dim + head_dim, H * W) \
        .split([key_dim, key_dim, head_dim], dim=2)
    scale = float(np.float32(key_dim ** -0.5))
    attn = ((q.transpose(-2, -1) @ k) * scale).softmax(dim=-1)
    out = (v @ attn.transpose(-2, -1)).view(B, C, H, W)
    out = out + conv(sd, p + ".pe", v.reshape(B, C, H, W), act=False)
    return conv(sd, p + ".proj", out, act=False)


def c2psa(sd, p, x):
    a, b = conv(sd, p + ".cv1", x).chunk(2, 1)
    i = 0
    while _has(sd, f"{p}.m.{i}."):
        q = f"{p}.m.{i}"
        b = b + attention(sd, q + ".attn", b)
        b = b + conv(sd, q + ".ffn.1", conv(sd, q + ".ffn.0", b), act=False)
        i += 1
    return conv(sd, p + ".cv2", torch.cat((a, b), 1))


def head(sd, feats):
    p = "model.23"
    nhwc = lambda t: t.permute(0, 2, 3, 1)  # noqa: E731
    box, cls, mc = [], [], []
    for i, f in enumerate(feats):
        b = conv(sd, f"{p}.cv2.{i}.1", conv(sd, f"{p}.cv2.{i}.0", f))
        box.append(nhwc(F.conv2d(b, sd[f"{p}.cv2.{i}.2.weight"], sd[f"{p}.cv2.{i}.2.bias"])))
        c = conv(sd, f"{p}.cv3.{i}.0.1", conv(sd, f"{p}.cv3.{i}.0.0", f))
        c = conv(sd, f"{p}.cv3.{i}.1.1", conv(sd, f"{p}.cv3.{i}.1.0", c))
        cls.append(nhwc(F.conv2d(c, sd[f"{p}.cv3.{i}.2.weight"], sd[f"{p}.cv3.{i}.2.bias"])))
        m = conv(sd, f"{p}.cv4.{i}.1", conv(sd, f"{p}.cv4.{i}.0", f))
        mc.append(nhwc(F.conv2d(m, sd[f"{p}.cv4.{i}.2.weight"], sd[f"{p}.cv4.{i}.2.bias"])))
    q = conv(sd, f"{p}.proto.cv1", feats[0])
    q = F.conv_transpose2d(q, sd[f"{p}.proto.upsample.weight"], sd[f"{p}.proto.upsample.bias"], 2)
    q = conv(sd, f"{p}.proto.cv3", conv(sd, f"{p}.proto.cv2", q))
    return {"box": tuple(box), "cls": tuple(cls), "mc": tuple(mc), "proto": nhwc(q)}


def forward(sd: dict, x: torch.Tensor) -> dict:
    """Raw head outputs of a letterboxed NCHW batch in [0, 1]."""
    up = lambda t: F.interpolate(t, scale_factor=2, mode="nearest")  # noqa: E731
    x = c3k2(sd, "model.2", conv(sd, "model.1", conv(sd, "model.0", x, 2), 2))
    x4 = c3k2(sd, "model.4", conv(sd, "model.3", x, 2))
    x6 = c3k2(sd, "model.6", conv(sd, "model.5", x4, 2))
    x10 = c2psa(sd, "model.10", sppf(sd, "model.9", c3k2(sd, "model.8",
                                                          conv(sd, "model.7", x6, 2))))
    x13 = c3k2(sd, "model.13", torch.cat((up(x10), x6), 1))
    p3 = c3k2(sd, "model.16", torch.cat((up(x13), x4), 1))
    p4 = c3k2(sd, "model.19", torch.cat((conv(sd, "model.17", p3, 2), x13), 1))
    p5 = c3k2(sd, "model.22", torch.cat((conv(sd, "model.20", p4, 2), x10), 1))
    return head(sd, (p3, p4, p5))


def letterbox(color_bgr: torch.Tensor, size: int = 640) -> torch.Tensor:
    """(1, 3, size, size) float32 input of an (H, W, 3) uint8 image whose
    longer side is ``size``: the image centred on a 114-grey canvas, / 255.
    (At a scale of exactly 1 the bilinear resample is the identity.)"""
    h, w = color_bgr.shape[:2]
    if max(h, w) != size:
        raise ValueError("the reference letterbox takes images whose longer side is the input size")
    canvas = torch.full((size, size, 3), 114.0, dtype=torch.float32, device=color_bgr.device)
    y0, x0 = (size - h) // 2, (size - w) // 2
    canvas[y0:y0 + h, x0:x0 + w] = color_bgr.to(torch.float32)
    return (canvas / 255.0).permute(2, 0, 1)[None]


def widest_gap(prog: dict, ref: dict) -> float:
    """Largest |program - reference| over every output, relative to that
    output's largest reference magnitude."""
    worst = 0.0
    for key in ("box", "cls", "mc", "proto"):
        a = prog[key] if isinstance(prog[key], (tuple, list)) else (prog[key],)
        b = ref[key] if isinstance(ref[key], (tuple, list)) else (ref[key],)
        for x, y in zip(a, b):
            x, y = x.to(torch.float32), y.to(torch.float32)
            if x.shape != y.shape:
                return float("inf")
            scale = float(y.abs().max().clamp(min=1e-12))
            worst = max(worst, float((x - y).abs().max()) / scale)
    return worst
