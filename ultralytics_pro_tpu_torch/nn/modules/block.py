"""YOLOv8 blocks, NCHW, with the reference's torch module names.

Counterpart of `ultralytics_pro_tpu/nn/modules/block.py` (`Bottleneck:32`,
`C2f:86`, `SPP:159`, `SPPF:173`, `DFL:251`, `Proto:270`, and RT-DETR's `HGStem:413`, `HGBlock:437`,
`RepC3:505`), and the v5, v10 and YOLO11 blocks (`C3:110`, `C3k:131`,
`C3k2:147`, `Attention:287`, `PSABlock:316`, `PSA:334`, `C2PSA:352`,
`SCDown:369`, `CIB:382`, `C2fCIB:404`), and the YOLOv4/v7 CSP blocks
(`BottleneckCSP:226`, `BottleneckCSP2:540`, `SPPCSPC:562`).

Where the JAX blocks differ from the torch reference, the port follows the
JAX package: C3k2's plain inner Bottleneck keeps its width (e = 1.0, where
the reference's default halves it), CIB ignores `lk` (no RepVGGDW), and
C2PSA takes at least one head.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ultralytics_pro_tpu_torch.nn.modules.conv import BN_EPS, BN_MOMENTUM, BatchNorm2d, Conv, LightConv, RepConv


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


class C3(nn.Module):
    """CSP bottleneck with 3 convs: cv3(cat(m(cv1(x)), cv2(x))), n bottlenecks
    of kernels (1, 3) in `m`, an nn.Sequential (`m.0.cv1`)."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True, g: int = 1, e: float = 0.5,
                 k=((1, 1), (3, 3))):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, 1, 1)
        self.cv2 = Conv(c1, c_, 1, 1)
        self.cv3 = Conv(2 * c_, c2, 1)
        self.m = nn.Sequential(*(Bottleneck(c_, c_, shortcut, g, k=k, e=1.0) for _ in range(n)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.cv3(torch.cat([self.m(self.cv1(x)), self.cv2(x)], 1))


class C3k(C3):
    """C3 whose bottlenecks are k x k twice."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True, g: int = 1, e: float = 0.5,
                 k: int = 3):
        super().__init__(c1, c2, n, shortcut, g, e, k=(k, k))


class C3k2(C2f):
    """YOLO11's C2f: its inner blocks are C3k (n = 2) when c3k, else
    Bottlenecks of full width (the JAX block's e = 1.0)."""

    def __init__(self, c1: int, c2: int, n: int = 1, c3k: bool = False, e: float = 0.5, g: int = 1,
                 shortcut: bool = True):
        super().__init__(c1, c2, n, shortcut, g, e)
        self.m = nn.ModuleList(C3k(self.c, self.c, 2, shortcut, g) if c3k else
                               Bottleneck(self.c, self.c, shortcut, g, k=(3, 3), e=1.0) for _ in range(n))


class CIB(nn.Module):
    """YOLOv10's conditional identity block: depth-wise 3x3, 1x1, depth-wise
    3x3, 1x1, depth-wise 3x3 (`cv1.0` to `cv1.4`), with the residual when
    shortcut and c1 == c2. `lk` is taken and ignored, as the JAX block does."""

    def __init__(self, c1: int, c2: int, shortcut: bool = True, e: float = 0.5, lk: bool = False):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = nn.Sequential(Conv(c1, c1, 3, g=c1), Conv(c1, 2 * c_, 1), Conv(2 * c_, 2 * c_, 3, g=2 * c_),
                                 Conv(2 * c_, c2, 1), Conv(c2, c2, 3, g=c2))
        self.add = shortcut and c1 == c2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv1(x)
        return x + y if self.add else y


class C2fCIB(C2f):
    """C2f whose inner blocks are CIBs."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = False, lk: bool = False, g: int = 1,
                 e: float = 0.5):
        super().__init__(c1, c2, n, shortcut, g, e)
        self.m = nn.ModuleList(CIB(self.c, self.c, shortcut, e=1.0, lk=lk) for _ in range(n))


class Attention(nn.Module):
    """Multi-head self-attention over a map's H*W positions, with a depth-wise
    3x3 positional encoding of v (`qkv`, `pe`, `proj`).

    `qkv` gives each head's q, k (key_dim each) and v (head_dim) channels in
    turn, head after head; the JAX block splits its channel-last map the
    same way. scale = key_dim ** -0.5."""

    def __init__(self, dim: int, num_heads: int = 8, attn_ratio: float = 0.5):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.key_dim = int(self.head_dim * attn_ratio)
        self.scale = self.key_dim ** -0.5
        self.qkv = Conv(dim, dim + 2 * self.key_dim * num_heads, 1, act=False)
        self.proj = Conv(dim, dim, 1, act=False)
        self.pe = Conv(dim, dim, 3, 1, g=dim, act=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        q, k, v = self.qkv(x).view(b, self.num_heads, 2 * self.key_dim + self.head_dim, h * w).split(
            [self.key_dim, self.key_dim, self.head_dim], dim=2)
        attn = ((q.transpose(-2, -1) @ k) * self.scale).float().softmax(-1).to(v.dtype)
        y = (v @ attn.transpose(-2, -1)).view(b, c, h, w) + self.pe(v.reshape(b, c, h, w))
        return self.proj(y)


class PSABlock(nn.Module):
    """Attention then a 2x feed-forward (`ffn.0`, `ffn.1`), each with a residual when shortcut."""

    def __init__(self, c: int, attn_ratio: float = 0.5, num_heads: int = 4, shortcut: bool = True):
        super().__init__()
        self.attn = Attention(c, num_heads=num_heads, attn_ratio=attn_ratio)
        self.ffn = nn.Sequential(Conv(c, c * 2, 1), Conv(c * 2, c, 1, act=False))
        self.add = shortcut

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(x) if self.add else self.attn(x)
        return x + self.ffn(x) if self.add else self.ffn(x)


class PSA(nn.Module):
    """YOLOv10's position-sensitive attention: half the channels through
    Attention (c // 64 heads) and a feed-forward, both with residuals."""

    def __init__(self, c1: int, c2: int, e: float = 0.5):
        super().__init__()
        self.c = int(c2 * e)
        self.cv1 = Conv(c1, 2 * self.c, 1, 1)
        self.cv2 = Conv(2 * self.c, c2, 1)
        self.attn = Attention(self.c, num_heads=self.c // 64, attn_ratio=0.5)
        self.ffn = nn.Sequential(Conv(self.c, self.c * 2, 1), Conv(self.c * 2, self.c, 1, act=False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, b = self.cv1(x).split((self.c, self.c), 1)
        b = b + self.attn(b)
        b = b + self.ffn(b)
        return self.cv2(torch.cat((a, b), 1))


class C2PSA(nn.Module):
    """YOLO11's CSP block of n PSABlocks (max(1, c // 64) heads) on half the channels."""

    def __init__(self, c1: int, c2: int, n: int = 1, e: float = 0.5):
        super().__init__()
        self.c = int(c2 * e)
        self.cv1 = Conv(c1, 2 * self.c, 1, 1)
        self.cv2 = Conv(2 * self.c, c2, 1)
        self.m = nn.Sequential(*(PSABlock(self.c, attn_ratio=0.5, num_heads=max(1, self.c // 64))
                                 for _ in range(n)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, b = self.cv1(x).split((self.c, self.c), 1)
        return self.cv2(torch.cat((a, self.m(b)), 1))


class SCDown(nn.Module):
    """YOLOv10's separable downsample: a 1x1 Conv, then a depth-wise k x k
    stride-s Conv without activation."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 2):
        super().__init__()
        self.cv1 = Conv(c1, c2, 1, 1)
        self.cv2 = Conv(c2, c2, k, s, g=c2, act=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.cv2(self.cv1(x))


class SPP(nn.Module):
    """Spatial pyramid pooling: cv1 to c1 / 2 channels, its k x k max pools
    (stride 1, same size) beside it, all concatenated into cv2."""

    def __init__(self, c1: int, c2: int, k=(5, 9, 13)):
        super().__init__()
        c_ = c1 // 2
        self.cv1 = Conv(c1, c_, 1, 1)
        self.cv2 = Conv(c_ * (len(k) + 1), c2, 1, 1)
        self.m = nn.ModuleList(nn.MaxPool2d(kernel_size=x, stride=1, padding=x // 2) for x in k)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.cv1(x)
        return self.cv2(torch.cat([x, *(m(x) for m in self.m)], 1))


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


class BottleneckCSP(nn.Module):
    """The original CSP bottleneck: `cv1` (Conv 1x1) and n full-width
    Bottlenecks (`m`), then `cv3`, a plain bias-free 1x1 conv, beside `cv2`,
    a plain bias-free 1x1 conv of the input; the two concatenated through
    their own BatchNorm (`bn`, eps 1e-3, flax momentum 0.97, which is torch's
    0.03) and SiLU (whatever the model's activation), then `cv4`."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True, g: int = 1, e: float = 0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, 1, 1)
        self.cv2 = nn.Conv2d(c1, c_, 1, bias=False)
        self.cv3 = nn.Conv2d(c_, c_, 1, bias=False)
        self.cv4 = Conv(2 * c_, c2, 1, 1)
        self.bn = BatchNorm2d(2 * c_, eps=BN_EPS, momentum=BN_MOMENTUM)
        self.act = nn.SiLU()
        self.m = nn.Sequential(*(Bottleneck(c_, c_, shortcut, g, e=1.0) for _ in range(n)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.cat([self.cv3(self.m(self.cv1(x))), self.cv2(x)], 1)
        return self.cv4(self.act(self.bn(y)))


class BottleneckCSP2(nn.Module):
    """Scaled-YOLOv4's CSP2: hidden width c2, both branches from `cv1`: n
    full-width Bottlenecks (`m`) beside `cv2`, a plain bias-free 1x1 conv;
    concatenated through `bn` and Mish (x tanh(softplus(x)), as JAX computes
    it), then `cv3`."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = False, g: int = 1):
        super().__init__()
        c_ = c2
        self.cv1 = Conv(c1, c_, 1, 1)
        self.cv2 = nn.Conv2d(c_, c_, 1, bias=False)
        self.cv3 = Conv(2 * c_, c2, 1, 1)
        self.bn = BatchNorm2d(2 * c_, eps=BN_EPS, momentum=BN_MOMENTUM)
        self.act = nn.Mish()
        self.m = nn.Sequential(*(Bottleneck(c_, c_, shortcut, g, e=1.0) for _ in range(n)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1 = self.cv1(x)
        return self.cv3(self.act(self.bn(torch.cat([self.m(x1), self.cv2(x1)], 1))))


class SPPCSPC(nn.Module):
    """YOLOv7's CSP-wrapped SPP, hidden width 2 c2 e: `cv1`, `cv3` (3x3),
    `cv4`, then max pools of k at stride 1 with 'same' padding beside it,
    `cv5`, `cv6` (3x3); concatenated with `cv2` of the input, then `cv7`."""

    def __init__(self, c1: int, c2: int, e: float = 0.5, k=(5, 9, 13)):
        super().__init__()
        c_ = int(2 * c2 * e)
        self.cv1 = Conv(c1, c_, 1, 1)
        self.cv2 = Conv(c1, c_, 1, 1)
        self.cv3 = Conv(c_, c_, 3, 1)
        self.cv4 = Conv(c_, c_, 1, 1)
        self.m = nn.ModuleList(nn.MaxPool2d(x, 1, x // 2) for x in k)
        self.cv5 = Conv((len(k) + 1) * c_, c_, 1, 1)
        self.cv6 = Conv(c_, c_, 3, 1)
        self.cv7 = Conv(2 * c_, c2, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1 = self.cv4(self.cv3(self.cv1(x)))
        y1 = self.cv6(self.cv5(torch.cat([x1, *(m(x1) for m in self.m)], 1)))
        return self.cv7(torch.cat([y1, self.cv2(x)], 1))
