"""Convolution modules, NCHW, with the reference's torch module names.

Counterpart of `ultralytics_pro_tpu/nn/modules/conv.py` (`autopad:39`,
`Conv:86`, `DWConv:131`, `LightConv:254`, `Concat:305`, `Upsample:328`,
`RepConv:383`, `ChannelAttention:266`, `SpatialAttention:277`, `CBAM:293`,
YOLOR's `ImplicitA:153` and `ImplicitM:167`, and the model-wide
`activation:` override at `:102-128`).
BatchNorm uses eps 1e-3 and momentum 0.03 (`:27-28`), and in train mode
updates its running statistics as flax's `nn.BatchNorm` does (`:73-80`):
see `BatchNorm2d`. "gelu" is the tanh form, as `jax.nn.gelu` computes it by
default (`:109`).
"""

from __future__ import annotations

import contextlib
import math
import threading

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-3
BN_MOMENTUM = 0.03
_RECOMPUTE = threading.local()


@contextlib.contextmanager
def recomputing():
    """Marks the forward that a checkpointed layer re-runs in the backward
    (`torch.utils.checkpoint`'s recompute context): BatchNorm2d normalises
    with the batch statistics as before and leaves its running statistics,
    updated by the first forward, alone. The JAX trainer's `jax.checkpoint`
    likewise returns the statistics of the one forward."""
    _RECOMPUTE.on = True
    try:
        yield
    finally:
        _RECOMPUTE.on = False


class BatchNorm2d(nn.BatchNorm2d):
    """`nn.BatchNorm2d` whose train-mode update of the running statistics is
    flax's: `running = (1 - momentum) * running + momentum * batch` with the
    biased batch variance, where torch's own update takes the unbiased one
    (a factor n / (n - 1), n = B*H*W, that shows on small maps).

    The batch statistics come from the same `F.batch_norm` call that
    normalises (into scratch buffers at momentum 1), so train mode reads the
    activation no more often than torch's own layer. `num_batches_tracked`
    stays as loaded: flax has no counterpart. Eval mode is torch's. Inside
    `recomputing()` the running statistics are not updated."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        mean = torch.zeros_like(self.running_mean)
        var = torch.ones_like(self.running_var)
        y = F.batch_norm(x, mean, var, self.weight, self.bias, True, 1.0, self.eps)
        n = x.numel() // x.shape[1]
        if getattr(_RECOMPUTE, "on", False):
            return y
        with torch.no_grad():  # var holds the unbiased batch variance
            self.running_mean.mul_(1 - self.momentum).add_(mean, alpha=self.momentum)
            self.running_var.mul_(1 - self.momentum).add_(var, alpha=self.momentum * (n - 1) / n)
        return y

_ACTS = {
    "silu": nn.SiLU, "relu": nn.ReLU, "relu6": nn.ReLU6,
    "leakyrelu": lambda: nn.LeakyReLU(0.01), "gelu": lambda: nn.GELU(approximate="tanh"),
    "hardswish": nn.Hardswish,
    "mish": nn.Mish, "sigmoid": nn.Sigmoid, "tanh": nn.Tanh, "identity": nn.Identity,
}


def resolve_act(spec) -> nn.Module:
    """'nn.ReLU()' / 'torch.nn.SiLU()' / 'ReLU' -> a fresh activation module."""
    name = str(spec).split("(")[0].split(".")[-1].lower()
    if name not in _ACTS:
        raise ValueError(f"unsupported activation {spec!r}; known: {sorted(_ACTS)}")
    return _ACTS[name]()


def autopad(k, p=None, d: int = 1):
    """'same'-style padding for kernel k with dilation d."""
    if d > 1:
        k = d * (k - 1) + 1 if isinstance(k, int) else [d * (x - 1) + 1 for x in k]
    if p is None:
        p = k // 2 if isinstance(k, int) else [x // 2 for x in k]
    return p


def conv_act(act) -> nn.Module:
    """A Conv's activation: True -> the model-wide default, a module -> itself,
    anything else -> identity."""
    if act is True:
        return resolve_act(Conv.default_act)
    return act if isinstance(act, nn.Module) else nn.Identity()


class Conv(nn.Module):
    """Conv2d (no bias) + BatchNorm2d + activation (SiLU unless overridden).

    `Conv.default_act` is the model-wide activation; `parse_model` sets it
    from the YAML `activation:` key while it builds a model, as the reference
    does, and restores SiLU afterwards.
    """

    default_act = "silu"

    def __init__(self, c1: int, c2: int, k=1, s=1, p=None, g: int = 1, d: int = 1, act=True):
        super().__init__()
        self.conv = nn.Conv2d(c1, c2, k, s, autopad(k, p, d), groups=g, dilation=d, bias=False)
        self.bn = BatchNorm2d(c2, eps=BN_EPS, momentum=BN_MOMENTUM)
        self.act = conv_act(act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.act(self.bn(self.conv(x)))


class DWConv(Conv):
    """Depth-wise conv: groups = gcd(c1, c2)."""

    def __init__(self, c1: int, c2: int, k=1, s=1, d: int = 1, act=True):
        super().__init__(c1, c2, k, s, g=math.gcd(c1, c2), d=d, act=act)


class LightConv(nn.Module):
    """1x1 Conv without activation, then a depth-wise k x k Conv with `act`."""

    def __init__(self, c1: int, c2: int, k: int = 1, act=None):
        super().__init__()
        self.conv1 = Conv(c1, c2, 1, act=False)
        self.conv2 = DWConv(c2, c2, k, act=act if act is not None else nn.ReLU())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(self.conv1(x))


class RepConv(nn.Module):
    """RepVGG-style conv in its training form: a k x k and a 1x1 Conv (both
    without activation) summed, then the activation. The identity-BN branch
    stays off, as RepC3 builds it."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 1, g: int = 1, act=True):
        super().__init__()
        self.conv1 = Conv(c1, c2, k, s, g=g, act=False)
        self.conv2 = Conv(c1, c2, 1, s, p=0, g=g, act=False)
        self.act = conv_act(act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.act(self.conv1(x) + self.conv2(x))


class Concat(nn.Module):
    """Concatenate a list of tensors along `dimension` (channels by default)."""

    def __init__(self, dimension: int = 1):
        super().__init__()
        self.d = dimension

    def forward(self, xs):
        return torch.cat(xs, self.d)


class ChannelAttention(nn.Module):
    """x times the sigmoid of a biased 1x1 conv (`fc`) of its spatial mean."""

    def __init__(self, c1: int):
        super().__init__()
        self.fc = nn.Conv2d(c1, c1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * torch.sigmoid(self.fc(x.mean((2, 3), keepdim=True)))


class SpatialAttention(nn.Module):
    """x times the sigmoid of a k x k conv (`cv1`, no bias) of its channel mean and max."""

    def __init__(self, k: int = 7):
        super().__init__()
        self.cv1 = nn.Conv2d(2, 1, k, padding=k // 2, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * torch.sigmoid(self.cv1(torch.cat([x.mean(1, keepdim=True), x.amax(1, keepdim=True)], 1)))


class CBAM(nn.Module):
    """ChannelAttention then SpatialAttention; the output has the input's channels."""

    def __init__(self, c1: int, k: int = 7):
        super().__init__()
        self.channel_attention = ChannelAttention(c1)
        self.spatial_attention = SpatialAttention(k)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.spatial_attention(self.channel_attention(x))


class ImplicitA(nn.Module):
    """YOLOR's additive implicit knowledge: x plus a learned per-channel
    offset `implicit`, (1, C, 1, 1) as the reference holds it (the flax leaf
    is (1, 1, 1, C)), initialised N(0, 0.02)."""

    mean = 0.0
    std = 0.02

    def __init__(self, c1: int):
        super().__init__()
        self.implicit = nn.Parameter(torch.empty(1, c1, 1, 1).normal_(self.mean, self.std))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.implicit


class ImplicitM(ImplicitA):
    """YOLOR's multiplicative implicit knowledge: x times a learned
    per-channel gain `implicit` (1, C, 1, 1), initialised N(1, 0.02)."""

    mean = 1.0

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.implicit
