"""YOLO11 segmentation model as ``torch.nn`` modules (counterpart of
``poseestimator_tpu/models/yolo/model.py`` and ``layers.py``).

Graph of the public YOLO11-seg architecture at any compound scale; the
``state_dict`` keys follow the Ultralytics ``model.{i}.{...}`` numbering
(parameterless Upsample/Identity fill slots 11/12/14/15/18/21), so the JAX
package's flax variables carry across one to one (``weights.py``). The
DFL expectation lives in ``decode.py``, as in the JAX package, so the head
holds no DFL conv.

``forward`` takes a letterboxed NCHW batch and returns the raw head outputs
in the JAX package's layout: ``{"box", "cls", "mc"}`` per-level (B, H, W, C)
views and ``"proto"`` (B, Hp, Wp, nm).

``YOLO11Seg(dtype=torch.bfloat16)`` computes in bfloat16 as the JAX
package's ``YOLO11Seg(dtype=jnp.bfloat16)`` does, its parameters staying
float32: every conv casts its input, kernel and bias to bfloat16 and
returns bfloat16, and BatchNorm computes in float32 from the bfloat16
input (its batch statistics too, in training) and rounds once. SiLU,
sigmoid and softmax are torch's fused ops, which round once where XLA's
expansions of them round at every step (within two bfloat16 ulps of
them). The head's outputs are bfloat16. In float32 every module computes
exactly as before.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

SCALES = {
    # depth, width, max_channels
    "n": (0.50, 0.25, 1024),
    "s": (0.50, 0.50, 1024),
    "m": (0.50, 1.00, 512),
    "l": (1.00, 1.00, 512),
    "x": (1.00, 1.50, 512),
}
STRIDES = (8, 16, 32)


def make_divisible(x: float, divisor: int = 8) -> int:
    return max(divisor, int(x + divisor / 2) // divisor * divisor)


class _Dtyped:
    """A module whose compute dtype follows its block's (``YOLO11Seg``
    sets it; None: its parameters' dtype, float32 or a float64 copy's); its
    parameters keep theirs."""

    compute_dtype = None


class Conv2d(nn.Conv2d, _Dtyped):
    """``nn.Conv2d`` under flax's ``nn.Conv(dtype=)``: the input, kernel and
    bias cast to the compute dtype, the output in it."""

    def forward(self, x):
        dt = self.compute_dtype or self.weight.dtype
        return self._conv_forward(x.to(dt), self.weight.to(dt),
                                  None if self.bias is None else self.bias.to(dt))


class ConvTranspose2d(nn.ConvTranspose2d, _Dtyped):
    """``nn.ConvTranspose2d`` under flax's ``nn.ConvTranspose(dtype=)``, as
    ``Conv2d``."""

    def forward(self, x):
        dt = self.compute_dtype or self.weight.dtype
        return F.conv_transpose2d(x.to(dt), self.weight.to(dt),
                                  None if self.bias is None else self.bias.to(dt), self.stride,
                                  self.padding, self.output_padding, self.groups, self.dilation)


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` with flax's train-mode law (``layers.py``: momentum
    0.97, eps 1e-3): the running variance averages the batch's *biased*
    variance, the one the batch is normalised with. ``nn.BatchNorm2d``
    averages the unbiased one, n / (n - 1) larger per channel for n = B H W
    values; the update is corrected after the fused call, a per-channel
    operation. Evaluation is ``nn.BatchNorm2d``'s own.

    ``mesh``, a ``parallel.Mesh`` of more than one rank (set by the data-
    parallel ``Trainer``), makes the train-mode statistics those of the
    global batch, as the JAX package's single GSPMD program computes them:
    the per-channel sums, then the sums of squared deviations from the
    global mean, are all-reduced through a differentiable all-reduce (so
    the backward carries the cross-rank terms of the mean and variance),
    and the running statistics move by the global mean and biased
    variance.

    A bfloat16 input (a bfloat16 block's) is normalised in float32 and the
    result rounded to bfloat16 once, as flax's ``BatchNorm(dtype=)`` does;
    in training the batch statistics are reduced in float32 from it
    (flax's ``force_float32_reductions``)."""

    mesh = None

    def forward(self, x):
        # flax computes a bfloat16 block's BatchNorm in float32
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        if not self.training:
            y = super().forward(xf)
        elif self.mesh is not None and self.mesh.size > 1:
            y = self._global_batch(xf)
        else:
            prior = self.running_var.clone()
            y = super().forward(xf)
            n = x.numel() // x.shape[1]
            # running = (1 - m) prior + m s2 n / (n - 1); flax keeps (1 - m) prior
            # + m s2. Through .data: autograd saved the buffer with the call (its
            # train-mode backward does not read it) and would refuse a new version
            rv = self.running_var.data
            rv.sub_((rv - (1.0 - self.momentum) * prior) / n)
        return y.to(x.dtype)

    def _global_batch(self, x):
        mesh = self.mesh
        n = float(x.numel() // x.shape[1] * mesh.size)  # every rank holds B / size images
        mean = mesh.all_reduce_grad(x.sum((0, 2, 3))) / n
        xc = x - mean[None, :, None, None]
        var = mesh.all_reduce_grad((xc * xc).sum((0, 2, 3))) / n
        scale = torch.rsqrt(var + self.eps) * self.weight
        y = xc * scale[None, :, None, None] + self.bias[None, :, None, None]
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean.detach(), alpha=m)
            self.running_var.mul_(1.0 - m).add_(var.detach(), alpha=m)
            self.num_batches_tracked.add_(1)
        return y


class Conv(nn.Module):
    """Conv2d(bias=False) + BatchNorm2d(eps 1e-3, flax's law) + SiLU."""

    def __init__(self, c1, c2, k=1, s=1, g=1, act=True):
        super().__init__()
        self.conv = Conv2d(c1, c2, k, s, k // 2, groups=g, bias=False)
        self.bn = BatchNorm2d(c2, eps=1e-3, momentum=0.03)
        self.act = nn.SiLU() if act else nn.Identity()

    def forward(self, x):
        return self.act(self.bn(self.conv(x)))


class Bottleneck(nn.Module):
    def __init__(self, c1, c2, shortcut=True, k=(3, 3), e=0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, k[0])
        self.cv2 = Conv(c_, c2, k[1])
        self.add = shortcut and c1 == c2

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C3k(nn.Module):
    def __init__(self, c1, c2, n=2, shortcut=True, e=0.5, k=3):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, 1)
        self.cv2 = Conv(c1, c_, 1)
        self.cv3 = Conv(2 * c_, c2, 1)
        self.m = nn.Sequential(*(Bottleneck(c_, c_, shortcut, (k, k), 1.0) for _ in range(n)))

    def forward(self, x):
        return self.cv3(torch.cat((self.m(self.cv1(x)), self.cv2(x)), 1))


class C3k2(nn.Module):
    def __init__(self, c1, c2, n=1, c3k=False, e=0.5, shortcut=True):
        super().__init__()
        self.c = int(c2 * e)
        self.cv1 = Conv(c1, 2 * self.c, 1)
        self.cv2 = Conv((2 + n) * self.c, c2, 1)
        self.m = nn.ModuleList(
            C3k(self.c, self.c, 2, shortcut) if c3k
            else Bottleneck(self.c, self.c, shortcut, (3, 3), 0.5)
            for _ in range(n)
        )

    def forward(self, x):
        y = list(self.cv1(x).split((self.c, self.c), 1))
        for m in self.m:
            y.append(m(y[-1]))
        return self.cv2(torch.cat(y, 1))


class SPPF(nn.Module):
    def __init__(self, c1, c2, k=5):
        super().__init__()
        c_ = c1 // 2
        self.cv1 = Conv(c1, c_, 1)
        self.cv2 = Conv(c_ * 4, c2, 1)
        self.m = nn.MaxPool2d(kernel_size=k, stride=1, padding=k // 2)

    def forward(self, x):
        y = [self.cv1(x)]
        for _ in range(3):
            y.append(self.m(y[-1]))
        return self.cv2(torch.cat(y, 1))


class Attention(nn.Module):
    def __init__(self, dim, num_heads, attn_ratio=0.5):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.key_dim = int(self.head_dim * attn_ratio)
        self.scale = self.key_dim ** -0.5
        h = dim + self.key_dim * 2 * num_heads
        self.qkv = Conv(dim, h, 1, act=False)
        self.proj = Conv(dim, dim, 1, act=False)
        self.pe = Conv(dim, dim, 3, 1, g=dim, act=False)

    def forward(self, x):
        B, C, H, W = x.shape
        N = H * W
        q, k, v = self.qkv(x).view(
            B, self.num_heads, self.key_dim * 2 + self.head_dim, N
        ).split([self.key_dim, self.key_dim, self.head_dim], dim=2)
        # a weak Python scalar takes the array's dtype in JAX: the scale
        # rounded to it (in bfloat16 the product of two bfloat16 values is
        # exact in float32, so torch's one rounding of it is XLA's)
        scale = float(torch.tensor(self.scale, dtype=q.dtype))
        attn = ((q.transpose(-2, -1) @ k) * scale).softmax(dim=-1)
        out = (v @ attn.transpose(-2, -1)).view(B, C, H, W)
        out = out + self.pe(v.reshape(B, C, H, W))
        return self.proj(out)


class PSABlock(nn.Module):
    def __init__(self, c, num_heads):
        super().__init__()
        self.attn = Attention(c, num_heads)
        self.ffn = nn.Sequential(Conv(c, c * 2, 1), Conv(c * 2, c, 1, act=False))

    def forward(self, x):
        x = x + self.attn(x)
        return x + self.ffn(x)


class C2PSA(nn.Module):
    def __init__(self, c1, c2, n=1, e=0.5):
        super().__init__()
        self.c = int(c1 * e)
        self.cv1 = Conv(c1, 2 * self.c, 1)
        self.cv2 = Conv(2 * self.c, c1, 1)
        self.m = nn.Sequential(*(PSABlock(self.c, max(self.c // 64, 1)) for _ in range(n)))

    def forward(self, x):
        a, b = self.cv1(x).split((self.c, self.c), dim=1)
        return self.cv2(torch.cat((a, self.m(b)), 1))


class Proto(nn.Module):
    def __init__(self, c1, c_, c2):
        super().__init__()
        self.cv1 = Conv(c1, c_, 3)
        self.upsample = ConvTranspose2d(c_, c_, 2, 2, 0, bias=True)
        self.cv2 = Conv(c_, c_, 3)
        self.cv3 = Conv(c_, c2, 1)

    def forward(self, x):
        return self.cv3(self.cv2(self.upsample(self.cv1(x))))


class Segment(nn.Module):
    """YOLO11 Segment head: box (DFL logits), class and mask-coefficient
    branches per level, plus the mask prototypes."""

    def __init__(self, nc, nm, npr, ch, reg_max=16):
        super().__init__()
        self.nc, self.nm, self.reg_max = nc, nm, reg_max
        c2 = max(16, ch[0] // 4, reg_max * 4)
        c3 = max(ch[0], min(nc, 100))
        c4 = max(ch[0] // 4, nm)
        self.cv2 = nn.ModuleList(
            nn.Sequential(Conv(x, c2, 3), Conv(c2, c2, 3), Conv2d(c2, 4 * reg_max, 1))
            for x in ch)
        self.cv3 = nn.ModuleList(
            nn.Sequential(
                nn.Sequential(Conv(x, x, 3, g=x), Conv(x, c3, 1)),
                nn.Sequential(Conv(c3, c3, 3, g=c3), Conv(c3, c3, 1)),
                Conv2d(c3, nc, 1),
            )
            for x in ch)
        self.cv4 = nn.ModuleList(
            nn.Sequential(Conv(x, c4, 3), Conv(c4, c4, 3), Conv2d(c4, nm, 1))
            for x in ch)
        self.proto = Proto(ch[0], npr, nm)

    def forward(self, feats):
        nhwc = lambda t: t.permute(0, 2, 3, 1)  # noqa: E731
        return {
            "box": tuple(nhwc(cv(f)) for cv, f in zip(self.cv2, feats)),
            "cls": tuple(nhwc(cv(f)) for cv, f in zip(self.cv3, feats)),
            "mc": tuple(nhwc(cv(f)) for cv, f in zip(self.cv4, feats)),
            "proto": nhwc(self.proto(feats[0])),
        }


class YOLO11Seg(nn.Module):
    """Full YOLO11-seg graph (backbone, PAN-FPN neck, segment head).
    ``dtype``: the compute dtype, ``torch.float32`` or ``torch.bfloat16``
    (the parameters are float32 either way)."""

    def __init__(self, nc=80, scale="n", reg_max=16, nm=32, npr=256, dtype=torch.float32):
        super().__init__()
        depth, width, max_ch = SCALES[scale]

        def c(x):
            return make_divisible(min(x, max_ch) * width)

        def n(x):
            return max(round(x * depth), 1)

        full = scale in ("m", "l", "x")
        self.nc, self.reg_max, self.nm = nc, reg_max, nm
        self.model = nn.ModuleList([
            Conv(3, c(64), 3, 2),                             # 0  P1/2
            Conv(c(64), c(128), 3, 2),                        # 1  P2/4
            C3k2(c(128), c(256), n(2), full, 0.25),           # 2
            Conv(c(256), c(256), 3, 2),                       # 3  P3/8
            C3k2(c(256), c(512), n(2), full, 0.25),           # 4
            Conv(c(512), c(512), 3, 2),                       # 5  P4/16
            C3k2(c(512), c(512), n(2), True, 0.5),            # 6
            Conv(c(512), c(1024), 3, 2),                      # 7  P5/32
            C3k2(c(1024), c(1024), n(2), True, 0.5),          # 8
            SPPF(c(1024), c(1024), 5),                        # 9
            C2PSA(c(1024), c(1024), n(2)),                    # 10
            nn.Upsample(scale_factor=2, mode="nearest"),      # 11
            nn.Identity(),                                     # 12 concat [-1, 6]
            C3k2(c(1024) + c(512), c(512), n(2), full, 0.5),  # 13
            nn.Upsample(scale_factor=2, mode="nearest"),      # 14
            nn.Identity(),                                     # 15 concat [-1, 4]
            C3k2(c(512) + c(512), c(256), n(2), full, 0.5),   # 16 P3
            Conv(c(256), c(256), 3, 2),                       # 17
            nn.Identity(),                                     # 18 concat [-1, 13]
            C3k2(c(256) + c(512), c(512), n(2), full, 0.5),   # 19 P4
            Conv(c(512), c(512), 3, 2),                       # 20
            nn.Identity(),                                     # 21 concat [-1, 10]
            C3k2(c(512) + c(1024), c(1024), n(2), True, 0.5),  # 22 P5
            Segment(nc, nm, c(npr), (c(256), c(512), c(1024)), reg_max),  # 23
        ])
        self.set_dtype(dtype)

    def set_dtype(self, dtype) -> "YOLO11Seg":
        """Set the compute dtype of every block (``dtype`` a torch dtype or
        its name, ``"float32"`` or ``"bfloat16"``)."""
        dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"unsupported detector dtype {dtype}; float32 or bfloat16")
        self.dtype = dtype
        for m in self.modules():
            if isinstance(m, _Dtyped):
                m.compute_dtype = None if dtype == torch.float32 else dtype
        return self

    def forward(self, x):
        m = self.model
        x = m[2](m[1](m[0](x)))
        x4 = m[4](m[3](x))
        x6 = m[6](m[5](x4))
        x10 = m[10](m[9](m[8](m[7](x6))))
        x13 = m[13](torch.cat((m[11](x10), x6), 1))
        p3 = m[16](torch.cat((m[14](x13), x4), 1))
        p4 = m[19](torch.cat((m[17](p3), x13), 1))
        p5 = m[22](torch.cat((m[20](p4), x10), 1))
        return m[23]((p3, p4, p5))


@torch.no_grad()
def init_random_(model: YOLO11Seg, generator: torch.Generator) -> YOLO11Seg:
    """Seeded random weights for a model run without a checkpoint: conv
    kernels ~ N(0, 1/fan_in), BatchNorm at identity, head biases zero (class
    scores then straddle 0.5, so NMS sees real candidates), the box head's
    DFL bias at 1.0 as in the JAX package's init."""
    for name, p in model.named_parameters():
        if p.dim() == 4:  # conv kernels; the proto deconv is square (c_ -> c_)
            p.copy_(torch.randn(p.shape, generator=generator) / math.sqrt(p[0].numel()))
        elif name.endswith("bn.weight"):
            p.fill_(1.0)
        else:
            p.zero_()
    for i in range(3):
        model.model[23].cv2[i][2].bias.fill_(1.0)
    for name, b in model.named_buffers():
        if name.endswith("running_var"):
            b.fill_(1.0)
        elif name.endswith("running_mean"):
            b.zero_()
    return model



@torch.no_grad()
def init_train_(model: YOLO11Seg, generator: torch.Generator) -> YOLO11Seg:
    """Seeded initial weights for training, the JAX package's init law:
    ``init_random_``, with the class bias at log(5 / nc / (640 / stride)^2),
    the prior of ~5 objects in a 640 image, so early class scores start
    near the positive rate instead of 0.5."""
    init_random_(model, generator)
    for i, s in enumerate(STRIDES):
        model.model[23].cv3[i][2].bias.fill_(math.log(5.0 / model.nc / (640.0 / s) ** 2))
    return model
