"""BiFPN's weighted sum and the slim neck's GSConv blocks, NCHW, under the
JAX package's parameter names.

Counterpart of `ultralytics_pro_tpu/nn/modules/necks.py` (`Bi_FPN:31`,
`GSConv:55`, `GSBottleneck:78`, `VoVGSCSP:93`). As there:
- Bi_FPN's bare `weight` (one per input, 1 at init) is normalised as
  w / (sum(silu(w)) + 1e-4);
- GSConv's and VoVGSCSP's YOLO Convs use Mish, except GSBottleneck's second
  GSConv (no activation); GSConv's channel shuffle puts the even channels of
  [x1, dw(x1)] first, then the odd;
- VoVGSCSP takes the YAML's repeats as its n (GSBottlenecks `gsb.{i}` of
  e = 1 on half the width).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ultralytics_pro_tpu_torch.nn.modules.conv import Conv


class Bi_FPN(nn.Module):
    """Fast normalised fusion of n same-shaped inputs."""

    def __init__(self, n: int = 2):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(n))

    def forward(self, x: list) -> torch.Tensor:
        w = self.weight / (F.silu(self.weight).sum() + 1e-4)
        return sum(w[i] * x[i] for i in range(len(x)))


class GSConv(nn.Module):
    """A k x k/s Conv to half the width, a depth-wise 5 x 5 Conv of it, both
    concatenated and shuffled (even channels, then odd)."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, act: bool = True):
        super().__init__()
        c_ = c2 // 2
        self.cv1 = Conv(c1, c_, k, s, act=nn.Mish() if act else False)
        self.cv2 = Conv(c_, c_, 5, 1, g=c_, act=nn.Mish() if act else False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1 = self.cv1(x)
        y = torch.cat([x1, self.cv2(x1)], 1)
        return torch.cat([y[:, 0::2], y[:, 1::2]], 1)


class GSBottleneck(nn.Module):
    """GSConv 1x1 to c2 * e, GSConv 3 x 3 without activation, plus a 1x1 Conv shortcut."""

    def __init__(self, c1: int, c2: int, e: float = 0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.gs1 = GSConv(c1, c_, 1)
        self.gs2 = GSConv(c_, c2, 3, act=False)
        self.shortcut = Conv(c1, c2, 1, act=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.gs2(self.gs1(x)) + self.shortcut(x)


class VoVGSCSP(nn.Module):
    """CSP over n GSBottlenecks: cv3(cat(cv2(x), gsb(cv1(x)))), Mish Convs."""

    def __init__(self, c1: int, c2: int, n: int = 1, e: float = 0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, 1, act=nn.Mish())
        self.gsb = nn.ModuleList(GSBottleneck(c_, c_, e=1.0) for _ in range(n))
        self.cv2 = Conv(c1, c_, 1, act=nn.Mish())
        self.cv3 = Conv(2 * c_, c2, 1, act=nn.Mish())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1 = self.cv1(x)
        for m in self.gsb:
            x1 = m(x1)
        return self.cv3(torch.cat([self.cv2(x), x1], 1))
