"""YOLOv9 (GELAN) and YOLO12 blocks, NCHW, with the reference's torch module names.

Counterpart of `ultralytics_pro_tpu/nn/modules/v9v10v12.py` (`RepNBottleneck:21`,
`RepNCSP:37`, `RepNCSPELAN4:54`, `ADown:91`, `SPPELAN:110`, `AAttn:162`,
`ABlock:190`, `A2C2f:208`).

Where the JAX blocks differ from the torch reference, the port follows the
JAX package:
- ADown's average pool keeps the map's size: a 2x2 window padded by one zero
  row and column at the bottom and right, divided by 4, where the
  reference's `avg_pool2d(2, 1, 0)` gives (H-1) x (W-1). The stride-2 conv
  after it gives the same output size at even sizes, but other border values.
- AAttn has separate `qk` and `v` 1x1 convs and a 7x7 depth-wise `pe` on v,
  where the reference has one `qkv` conv, so reference YOLO12 weights load
  into neither package.

The JAX names `cv2_csp`, `cv2_conv`, `cv3_csp` and `cv3_conv` of
RepNCSPELAN4 are the reference's nn.Sequential children `cv2.0`, `cv2.1`,
`cv3.0` and `cv3.1` (see `utils/weights.py`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ultralytics_pro_tpu_torch.nn.modules.block import C3
from ultralytics_pro_tpu_torch.nn.modules.conv import Conv, RepConv


class RepNBottleneck(nn.Module):
    """Bottleneck whose first conv is a RepConv (no identity branch)."""

    def __init__(self, c1: int, c2: int, shortcut: bool = True, k=(3, 3), e: float = 0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = RepConv(c1, c_, k[0])
        self.cv2 = Conv(c_, c2, k[1])
        self.add = shortcut and c1 == c2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class RepNCSP(nn.Module):
    """C3-style CSP block of n RepNBottlenecks (`m.i`)."""

    def __init__(self, c1: int, c2: int, n: int = 1, e: float = 0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, 1)
        self.cv2 = Conv(c1, c_, 1)
        self.cv3 = Conv(2 * c_, c2, 1)
        self.m = nn.Sequential(*(RepNBottleneck(c_, c_, e=1.0) for _ in range(n)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.cv3(torch.cat([self.m(self.cv1(x)), self.cv2(x)], 1))


class RepNCSPELAN4(nn.Module):
    """GELAN block: cv1 to c3 channels split in two halves; the second half
    through RepNCSP and a 3x3 Conv (`cv2.0`, `cv2.1`), then again (`cv3.0`,
    `cv3.1`); all four concatenated into cv4."""

    def __init__(self, c1: int, c2: int, c3: int, c4: int, n: int = 1):
        super().__init__()
        self.cv1 = Conv(c1, c3, 1)
        self.cv2 = nn.Sequential(RepNCSP(c3 // 2, c4, n), Conv(c4, c4, 3))
        self.cv3 = nn.Sequential(RepNCSP(c4, c4, n), Conv(c4, c4, 3))
        self.cv4 = Conv(c3 + 2 * c4, c2, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = list(self.cv1(x).chunk(2, 1))
        y.append(self.cv2(y[-1]))
        y.append(self.cv3(y[-1]))
        return self.cv4(torch.cat(y, 1))


def avg_pool_same(x: torch.Tensor) -> torch.Tensor:
    """The JAX ADown's pool: the mean of each 2x2 window, the map padded by
    zeros at the bottom and right, so the output keeps H x W."""
    return F.avg_pool2d(F.pad(x, (0, 1, 0, 1)), 2, 1)


class ADown(nn.Module):
    """Downsample by 2: `avg_pool_same`, then half the channels through a 3x3
    stride-2 Conv (cv1) and half through a 3x3 stride-2 max pool and a 1x1
    Conv (cv2)."""

    def __init__(self, c1: int, c2: int):
        super().__init__()
        self.c = c2 // 2
        self.cv1 = Conv(c1 // 2, self.c, 3, 2)
        self.cv2 = Conv(c1 // 2, self.c, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1, x2 = avg_pool_same(x).chunk(2, 1)
        return torch.cat([self.cv1(x1), self.cv2(F.max_pool2d(x2, 3, 2, 1))], 1)


class SPPELAN(nn.Module):
    """SPP-ELAN: cv1 to c3 channels, three cascaded 5x5 max pools, all four
    concatenated into cv5."""

    def __init__(self, c1: int, c2: int, c3: int, k: int = 5):
        super().__init__()
        self.cv1 = Conv(c1, c3, 1)
        self.m = nn.MaxPool2d(k, 1, k // 2)
        self.cv5 = Conv(4 * c3, c2, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = [self.cv1(x)]
        for _ in range(3):
            y.append(self.m(y[-1]))
        return self.cv5(torch.cat(y, 1))


class AAttn(nn.Module):
    """Area attention: the H*W tokens, in (h, w) order, split into `area`
    equal groups (one group when H*W is not a multiple of area), full
    multi-head attention inside each; `qk` and `v` 1x1 Convs, a 7x7
    depth-wise `pe` on v added to the output, then `proj`. The channels of
    qk are q then k, each head after head, as the JAX block reshapes them."""

    def __init__(self, dim: int, num_heads: int, area: int = 1):
        super().__init__()
        self.num_heads, self.area = num_heads, area
        self.head_dim = dim // num_heads
        self.qk = Conv(dim, dim * 2, 1, act=False)
        self.v = Conv(dim, dim, 1, act=False)
        self.pe = Conv(dim, dim, 7, 1, g=dim, act=False)
        self.proj = Conv(dim, dim, 1, act=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        n = h * w
        area = self.area if n % self.area == 0 else 1
        nh, hd = self.num_heads, self.head_dim
        v = self.v(x)
        qk = self.qk(x).flatten(2).transpose(1, 2).reshape(b * area, n // area, 2, nh, hd)
        q, k = qk[:, :, 0].transpose(1, 2), qk[:, :, 1].transpose(1, 2)  # (B*area, nh, N/area, hd)
        vt = v.flatten(2).transpose(1, 2).reshape(b * area, n // area, nh, hd).transpose(1, 2)
        attn = ((q @ k.transpose(-2, -1)) * hd ** -0.5).softmax(-1)
        out = (attn @ vt).transpose(1, 2).reshape(b, n, c).transpose(1, 2).reshape(b, c, h, w)
        return self.proj(out + self.pe(v))


class ABlock(nn.Module):
    """x + AAttn(x), then x + mlp(x): a 1x1 Conv to dim * mlp_ratio and a 1x1
    Conv back without activation (`mlp.0`, `mlp.1`)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 1.2, area: int = 1):
        super().__init__()
        self.attn = AAttn(dim, num_heads, area)
        hidden = int(dim * mlp_ratio)
        self.mlp = nn.Sequential(Conv(dim, hidden, 1), Conv(hidden, dim, 1, act=False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(x)
        return x + self.mlp(x)


class A2C2f(nn.Module):
    """YOLO12's R-ELAN block: cv1 to c2 / 2 channels, n stages each two
    ABlocks (`m.i.0`, `m.i.1`; max(1, c_ // 32) heads) or, when not a2, a C3
    of two bottlenecks (`m.i`), every stage's output concatenated into cv2.
    With `residual` (scales l and x), a2 and c1 == c2 the output is
    x + gamma * cv2(...), gamma a per-channel parameter starting at 0.01."""

    def __init__(self, c1: int, c2: int, n: int = 1, a2: bool = True, area: int = 1, residual: bool = False,
                 mlp_ratio: float = 2.0, e: float = 0.5):
        super().__init__()
        c_ = int(c2 * e)
        heads = max(1, c_ // 32)
        self.cv1 = Conv(c1, c_, 1)
        self.cv2 = Conv((1 + n) * c_, c2, 1)
        self.m = nn.ModuleList(
            nn.Sequential(ABlock(c_, heads, mlp_ratio, area), ABlock(c_, heads, mlp_ratio, area)) if a2
            else C3(c_, c_, 2) for _ in range(n))
        self.gamma = nn.Parameter(torch.full((c2,), 0.01)) if residual and a2 and c1 == c2 else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = [self.cv1(x)]
        for m in self.m:
            y.append(m(y[-1]))
        out = self.cv2(torch.cat(y, 1))
        return x + self.gamma.view(1, -1, 1, 1) * out if self.gamma is not None else out
