"""YOLOv8 blocks, NCHW, with the reference's torch module names.

Counterpart of `ultralytics_pro_tpu/nn/modules/block.py` (`Bottleneck:32`,
`C2f:86`, `SPPF:173`, `DFL:251`, `Proto:270`, and RT-DETR's `HGStem:413`, `HGBlock:437`,
`RepC3:505`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ultralytics_pro_tpu_torch.nn.modules.conv import Conv, LightConv, RepConv


def dfl_expectation(box: torch.Tensor, bins: torch.Tensor) -> torch.Tensor:
    """Softmax expectation over len(bins) bins: (B, 4*R, H, W) -> (B, 4, H, W)."""
    b, _, h, w = box.shape
    probs = box.reshape(b, 4, bins.numel(), h, w).softmax(2)
    return torch.einsum("bkrhw,r->bkhw", probs, bins)


class DFL(nn.Module):
    """Distribution-focal-loss decode over `c1` bins.

    Holds the reference's frozen 1x1 conv whose weight is arange(c1), so its
    state_dict key (`dfl.conv.weight`) lines up; the conv's weight is the bins.
    """

    def __init__(self, c1: int = 16):
        super().__init__()
        self.conv = nn.Conv2d(c1, 1, 1, bias=False).requires_grad_(False)
        self.conv.weight.data[:] = torch.arange(c1, dtype=torch.float32).view(1, c1, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dfl_expectation(x, self.conv.weight.reshape(-1))


class Bottleneck(nn.Module):
    """Two convs with an optional residual."""

    def __init__(self, c1: int, c2: int, shortcut: bool = True, g: int = 1, k=(3, 3),
                 e: float = 0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, k[0], 1)
        self.cv2 = Conv(c_, c2, k[1], 1, g=g)
        self.add = shortcut and c1 == c2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C2f(nn.Module):
    """CSP bottleneck with two convs and n cross-connected bottlenecks."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = False, g: int = 1,
                 e: float = 0.5):
        super().__init__()
        self.c = int(c2 * e)
        self.cv1 = Conv(c1, 2 * self.c, 1, 1)
        self.cv2 = Conv((2 + n) * self.c, c2, 1)
        self.m = nn.ModuleList(Bottleneck(self.c, self.c, shortcut, g, k=(3, 3), e=1.0)
                               for _ in range(n))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = list(self.cv1(x).chunk(2, 1))
        for m in self.m:
            y.append(m(y[-1]))
        return self.cv2(torch.cat(y, 1))


class SPPF(nn.Module):
    """Fast spatial pyramid pooling: three cascaded k-max-pools."""

    def __init__(self, c1: int, c2: int, k: int = 5):
        super().__init__()
        c_ = c1 // 2
        self.cv1 = Conv(c1, c_, 1, 1)
        self.cv2 = Conv(c_ * 4, c2, 1, 1)
        self.m = nn.MaxPool2d(kernel_size=k, stride=1, padding=k // 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = [self.cv1(x)]
        for _ in range(3):
            y.append(self.m(y[-1]))
        return self.cv2(torch.cat(y, 1))


class Proto(nn.Module):
    """Segmentation mask prototypes: Conv 3x3, a stride-2 2x2 transposed conv
    (with bias) that doubles the map, Conv 3x3, Conv 1x1 to c2 channels."""

    def __init__(self, c1: int, c_: int = 256, c2: int = 32):
        super().__init__()
        self.cv1 = Conv(c1, c_, 3)
        self.upsample = nn.ConvTranspose2d(c_, c_, 2, 2, 0, bias=True)
        self.cv2 = Conv(c_, c_, 3)
        self.cv3 = Conv(c_, c2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.cv3(self.cv2(self.upsample(self.cv1(x))))


class HGStem(nn.Module):
    """PPHGNetV2 stem: five ReLU convs and a 2x2 max-pool branch."""

    def __init__(self, c1: int, cm: int, c2: int):
        super().__init__()
        self.stem1 = Conv(c1, cm, 3, 2, act=nn.ReLU())
        self.stem2a = Conv(cm, cm // 2, 2, 1, 0, act=nn.ReLU())
        self.stem2b = Conv(cm // 2, cm, 2, 1, 0, act=nn.ReLU())
        self.stem3 = Conv(cm * 2, cm, 3, 2, act=nn.ReLU())
        self.stem4 = Conv(cm, c2, 1, 1, act=nn.ReLU())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.stem1(x)
        x2 = self.stem2b(F.pad(self.stem2a(F.pad(x, (0, 1, 0, 1))), (0, 1, 0, 1)))
        x1 = F.max_pool2d(F.pad(x, (0, 1, 0, 1), value=float("-inf")), 2, 1)
        return self.stem4(self.stem3(torch.cat([x1, x2], 1)))


class HGBlock(nn.Module):
    """PPHGNetV2 block: n cascaded convs (LightConv when `lightconv`), all
    outputs concatenated, then a squeeze (sc) and an excite (ec) 1x1 conv;
    the residual only when `shortcut` and c1 == c2."""

    def __init__(self, c1: int, cm: int, c2: int, k: int = 3, n: int = 6, lightconv: bool = False,
                 shortcut: bool = False):
        super().__init__()
        block = LightConv if lightconv else Conv
        self.m = nn.ModuleList(block(c1 if i == 0 else cm, cm, k=k, act=nn.ReLU()) for i in range(n))
        self.sc = Conv(c1 + n * cm, c2 // 2, 1, 1, act=nn.ReLU())
        self.ec = Conv(c2 // 2, c2, 1, 1, act=nn.ReLU())
        self.add = shortcut and c1 == c2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = [x]
        for m in self.m:
            y.append(m(y[-1]))
        y = self.ec(self.sc(torch.cat(y, 1)))
        return x + y if self.add else y


class RepC3(nn.Module):
    """CSP block with n RepConvs: cv3(m(cv1(x)) + cv2(x)), cv3 only if c_ != c2."""

    def __init__(self, c1: int, c2: int, n: int = 3, e: float = 1.0):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, 1, 1)
        self.cv2 = Conv(c1, c_, 1, 1)
        self.m = nn.Sequential(*(RepConv(c_, c_) for _ in range(n)))
        self.cv3 = Conv(c_, c2, 1, 1) if c_ != c2 else nn.Identity()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.cv3(self.m(self.cv1(x)) + self.cv2(x))
