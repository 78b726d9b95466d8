"""Model-family modules, NCHW, under the JAX package's parameter names:
RTMDet's CSPNeXt stage, the YOLOR (R family) CSP blocks and stem,
BiFormer's bi-level routing attention, Hyper-YOLO's MANet and hypergraph
conv, and MAF-YOLOv2's RepHMS.

Counterpart of `ultralytics_pro_tpu/nn/modules/families.py`
(`CSPNeXtBlock:48`, `RTMBlock:62`, `MANet:369`, `HyperComputeModule:396`,
`DepthBottleneckUni:439`, `RepHMS:461`, `ResBottleneck:644`,
`BottleneckCSPB:660`, `ResCSPB:683`, `BottleneckCSPC:689`, `ResCSPC:712`,
`Stem:718`, `BiLevelRoutingAttention:895`). The routing's top-k is a stable
descending sort, so ties go to the lower region index as `lax.top_k` breaks
them. MAF-YOLOv2's `AVG` (`:427`) is torch's own `nn.AvgPool2d` (`nn/tasks.py`).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ultralytics_pro_tpu_torch.nn.modules.attention import nchw, nhwc
from ultralytics_pro_tpu_torch.nn.modules.block import Bottleneck
from ultralytics_pro_tpu_torch.nn.modules.conv import BN_EPS, BN_MOMENTUM, BatchNorm2d, Conv, DWConv, conv_act


class CSPNeXtBlock(nn.Module):
    """A k0 x k0 Conv (`cv1`) then a depth-wise k1 x k1 DWConv (`cv2`), with
    the residual where shortcut and c1 == c2."""

    def __init__(self, c1: int, c2: int, shortcut: bool = True, k=(3, 5)):
        super().__init__()
        self.cv1 = Conv(c1, c2, k[0])
        self.cv2 = DWConv(c2, c2, k[1])
        self.add = shortcut and c1 == c2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class RTMBlock(nn.Module):
    """RTMDet's CSPNeXt stage: n CSPNeXtBlocks (`m`) after `cv1` beside `cv2`,
    both 1x1 to c2 e; the concatenated branches times the sigmoid of a biased
    1x1 conv (`attn_fc`) of their spatial mean, before the fusing `cv3` (the
    mmdet CSPLayer order)."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True, e: float = 0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, 1)
        self.cv2 = Conv(c1, c_, 1)
        self.m = nn.Sequential(*(CSPNeXtBlock(c_, c_, shortcut) for _ in range(n)))
        self.attn_fc = nn.Conv2d(2 * c_, 2 * c_, 1)
        self.cv3 = Conv(2 * c_, c2, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.cat([self.m(self.cv1(x)), self.cv2(x)], 1)
        return self.cv3(y * torch.sigmoid(self.attn_fc(y.mean((2, 3), keepdim=True))))


class MANet(nn.Module):
    """Hyper-YOLO's mixed aggregation block, c = c2 e: a 1x1 Conv to 2c
    (`cv_first`); from it a 1x1 Conv to c (`cv_block.1`, the JAX
    `cv_block_1`), a 1x1 Conv to 2cp, a depth-wise k x k and a 1x1 Conv to c
    (`cv_b2.0`-`.2`), and its two halves; n Bottlenecks of width c (`m`,
    3x3 and 3x3, e 1.0), each on the last; all concatenated into a 1x1 Conv
    (`cv_final`)."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = False, p: int = 1, k: int = 3,
                 e: float = 0.5):
        super().__init__()
        c = int(c2 * e)
        dh = int(p * 2 * c)
        self.cv_first = Conv(c1, 2 * c, 1)
        self.cv_block = nn.ModuleDict({"1": Conv(2 * c, c, 1)})
        self.cv_b2 = nn.Sequential(Conv(2 * c, dh, 1), DWConv(dh, dh, k), Conv(dh, c, 1))
        self.m = nn.ModuleList(Bottleneck(c, c, shortcut, k=(3, 3), e=1.0) for _ in range(n))
        self.cv_final = Conv((4 + n) * c, c2, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv_first(x)
        ys = [self.cv_block["1"](y), self.cv_b2(y), *y.chunk(2, 1)]
        for m in self.m:
            ys.append(m(ys[-1]))
        return self.cv_final(torch.cat(ys, 1))


class HyperComputeModule(nn.Module):
    """Hypergraph conv over the H * W tokens t (B, N, C): token pairs closer
    than `threshold` share a hyperedge (the incidence hg, from
    |a|^2 + |b|^2 - 2 a.b clamped at 0, then the square root, as the JAX
    module computes it); a dense layer (`fc`) of the tokens is averaged from
    vertices to edges (hg's transpose) and back, each by the count of
    members (at least 1); plus t, then `bn` and SiLU. The output has the
    input's channels."""

    def __init__(self, c1: int, threshold: float = 10.0):
        super().__init__()
        self.threshold = threshold
        self.fc = nn.Linear(c1, c1)
        self.bn = BatchNorm2d(c1, eps=BN_EPS, momentum=BN_MOMENTUM)

    def incidence(self, t: torch.Tensor) -> torch.Tensor:
        """(B, N, N) 1.0 where two of the (B, N, C) tokens lie within threshold."""
        sq = (t * t).sum(-1)
        d2 = (sq[:, :, None] + sq[:, None, :] - 2.0 * torch.matmul(t, t.transpose(1, 2))).clamp(min=0.0)
        return (torch.sqrt(d2) < self.threshold).to(t.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        t = x.flatten(2).transpose(1, 2)
        hg = self.incidence(t)
        f = self.fc(t)
        ht = hg.transpose(1, 2)
        e = torch.matmul(ht, f) / ht.sum(-1, keepdim=True).clamp(min=1.0)
        v = torch.matmul(hg, e) / hg.sum(-1, keepdim=True).clamp(min=1.0)
        return F.silu(self.bn((v + t).transpose(1, 2).reshape(b, c, h, w)))


class DepthBottleneckUni(nn.Module):
    """A 1x1 Conv to c1 depth_e (`cv1`); a depth-wise k x k and a depth-wise
    small_k x small_k Conv, both without activation (`dw_large`,
    `dw_small`), summed, then the activation; a 1x1 Conv (`cv2`); the
    residual where shortcut and c1 == c2."""

    def __init__(self, c1: int, c2: int, shortcut: bool = True, k: int = 5, depth_e: float = 2.0,
                 small_k: int = 3):
        super().__init__()
        cm = int(c1 * depth_e)
        self.cv1 = Conv(c1, cm, 1)
        self.dw_large = DWConv(cm, cm, k, act=False)
        self.dw_small = DWConv(cm, cm, small_k, act=False)
        self.act = conv_act(True)
        self.cv2 = Conv(cm, c2, 1)
        self.add = shortcut and c1 == c2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv1(x)
        y = self.cv2(self.act(self.dw_large(y) + self.dw_small(y)))
        return x + y if self.add else y


class RepHMS(nn.Module):
    """MAF-YOLOv2's cascaded multi-branch ELAN, c = c2 e: a 1x1 Conv to
    width x c (`conv1`) split in width parts; branch i + 1 (after adding
    branch 0 to branch 1) runs depth DepthBottleneckUni blocks (`m.i.j`),
    from branch 2 on first adding the earlier branch's cascade (reset after
    its last block); branch 0 and every block's output are concatenated into
    a 1x1 Conv (`conv2`). The index bookkeeping is the JAX module's, line
    for line: at width 2 no branch reads the cascade, at width 3 the last
    does."""

    def __init__(self, c1: int, c2: int, width: int = 3, depth: int = 1, depth_e: float = 2.0, k: int = 5,
                 e: float = 0.5):
        super().__init__()
        self.c, self.width, self.depth = int(c2 * e), width, depth
        self.conv1 = Conv(c1, self.c * width, 1)
        self.m = nn.ModuleList(nn.ModuleList(DepthBottleneckUni(self.c, self.c, k=k, depth_e=depth_e)
                                             for _ in range(depth)) for _ in range(width - 1))
        self.conv2 = Conv(self.c * (1 + (width - 1) * depth), c2, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xs = list(self.conv1(x).split(self.c, 1))
        xs[1] = xs[1] + xs[0]
        cascade, elan = [], [xs[0]]
        for i in range(self.width - 1):
            for j in range(self.depth):
                if i > 0:
                    xs[i + 1] = xs[i + 1] + cascade[j]
                    if j == self.depth - 1:
                        cascade = [cascade[-1]] if self.depth > 1 else []
                xs[i + 1] = self.m[i][j](xs[i + 1])
                elan.append(xs[i + 1])
                if i < self.width - 2:
                    cascade.append(xs[i + 1])
        return self.conv2(torch.cat(elan, 1))


class ResBottleneck(nn.Module):
    """A 1x1, 3x3, 1x1 Conv chain (`cv1`, `cv2`, `cv3`), hidden width c2 e,
    with the residual where shortcut and c1 == c2."""

    def __init__(self, c1: int, c2: int, shortcut: bool = True, e: float = 0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, 1)
        self.cv2 = Conv(c_, c_, 3)
        self.cv3 = Conv(c_, c2, 1)
        self.add = shortcut and c1 == c2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv3(self.cv2(self.cv1(x)))
        return x + y if self.add else y


def _inner(cls, c: int, n: int, shortcut: bool) -> nn.Sequential:
    """n inner blocks of width c (`m`): a Bottleneck keeps its width (e 1.0),
    a ResBottleneck halves it inside (e 0.5), as the JAX CSP-B and CSP-C do."""
    return nn.Sequential(*(cls(c, c, shortcut=shortcut, e=1.0 if cls is Bottleneck else 0.5) for _ in range(n)))


class BottleneckCSPB(nn.Module):
    """CSP-B, hidden width c2: `cv1` (Conv 1x1), then n inner blocks (`m`)
    beside `cv2`, a plain bias-free 1x1 conv of cv1's output; concatenated
    through `bn` and the model's activation, then `cv3`."""

    inner = Bottleneck

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = False):
        super().__init__()
        c_ = c2
        self.cv1 = Conv(c1, c_, 1)
        self.m = _inner(self.inner, c_, n, shortcut)
        self.cv2 = nn.Conv2d(c_, c_, 1, bias=False)
        self.bn = BatchNorm2d(2 * c_, eps=BN_EPS, momentum=BN_MOMENTUM)
        self.act = conv_act(True)
        self.cv3 = Conv(2 * c_, c2, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1 = self.cv1(x)
        return self.cv3(self.act(self.bn(torch.cat([self.m(x1), self.cv2(x1)], 1))))


class ResCSPB(BottleneckCSPB):
    """CSP-B over ResBottlenecks."""

    inner = ResBottleneck


class BottleneckCSPC(nn.Module):
    """CSP-C, hidden width c2 // 2: `cv1` (Conv 1x1), n inner blocks (`m`)
    and `cv3`, a plain bias-free 1x1 conv, beside `cv2`, a plain bias-free
    1x1 conv of the input; concatenated through `bn` and the model's
    activation, then `cv4`."""

    inner = Bottleneck

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = False):
        super().__init__()
        c_ = int(c2 * 0.5)
        self.cv1 = Conv(c1, c_, 1)
        self.cv2 = nn.Conv2d(c1, c_, 1, bias=False)
        self.m = _inner(self.inner, c_, n, shortcut)
        self.cv3 = nn.Conv2d(c_, c_, 1, bias=False)
        self.bn = BatchNorm2d(2 * c_, eps=BN_EPS, momentum=BN_MOMENTUM)
        self.act = conv_act(True)
        self.cv4 = Conv(2 * c_, c2, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.cat([self.cv3(self.m(self.cv1(x))), self.cv2(x)], 1)
        return self.cv4(self.act(self.bn(y)))


class ResCSPC(BottleneckCSPC):
    """CSP-C over ResBottlenecks."""

    inner = ResBottleneck


class Stem(nn.Module):
    """The R family's stem: a 3x3 Conv to c2 // 2 (`cv1`), then a 3x3
    stride-2 Conv to c2 (`cv2`)."""

    def __init__(self, c1: int, c2: int):
        super().__init__()
        self.cv1 = Conv(c1, c2 // 2, 3)
        self.cv2 = Conv(c2 // 2, c2, 3, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.cv2(self.cv1(x))


def top_regions(aff: torch.Tensor, k: int) -> torch.Tensor:
    """The indices of each row's k largest affinities, largest first, ties
    to the lower index (`lax.top_k`'s order)."""
    return torch.sort(aff, dim=-1, descending=True, stable=True).indices[..., :k]


class BiLevelRoutingAttention(nn.Module):
    """The map splits into n_win x n_win regions (2 x 2, else 1, where H or W
    does not divide); each region attends to the tokens of the topk regions
    whose mean key best matches its mean query (topk at most the region
    count). q, k, v by one dense layer over channels (`qkv`), a depth-wise
    5x5 of v (`lce`) added to the attention's output, a dense projection
    (`wo`). Heads fall back to 1 where C does not divide."""

    def __init__(self, c1: int, num_heads: int = 8, n_win: int = 4, topk: int = 4):
        super().__init__()
        self.num_heads, self.n_win, self.topk = num_heads, n_win, topk
        self.qkv = nn.Linear(c1, 3 * c1)
        self.lce = nn.Conv2d(c1, c1, 5, padding=2, groups=c1)
        self.wo = nn.Linear(c1, c1)

    def windows(self, h: int, w: int) -> int:
        """The window count a side for an h x w map."""
        if h % self.n_win or w % self.n_win:
            return 2 if h % 2 == 0 and w % 2 == 0 else 1
        return self.n_win

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        nwin = self.windows(h, w)
        hw, ww = h // nwin, w // nwin
        r, t = nwin * nwin, hw * ww
        nh = self.num_heads if c % self.num_heads == 0 else 1
        hd = c // nh
        q, k, v = self.qkv(nhwc(x)).chunk(3, -1)  # (B, H, W, C) each
        lce = nhwc(self.lce(nchw(v)))

        def regionize(z):  # (B, H, W, C) -> (B, R, T, C)
            return z.reshape(b, nwin, hw, nwin, ww, c).permute(0, 1, 3, 2, 4, 5).reshape(b, r, t, c)

        qr, kr, vr = regionize(q), regionize(k), regionize(v)
        aff = torch.einsum("brc,bsc->brs", qr.mean(2), kr.mean(2))
        topk = min(self.topk, r)
        idx = top_regions(aff, topk)  # (B, R, topk)
        rows = torch.arange(b, device=x.device)[:, None, None]
        kg = kr[rows, idx].reshape(b, r, topk * t, nh, hd)
        vg = vr[rows, idx].reshape(b, r, topk * t, nh, hd)
        att = torch.einsum("brqhd,brkhd->brhqk", qr.reshape(b, r, t, nh, hd), kg) / math.sqrt(hd)
        y = torch.einsum("brhqk,brkhd->brqhd", att.softmax(-1), vg)
        y = y.reshape(b, nwin, nwin, hw, ww, c).permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, c)
        return nchw(self.wo(y + lce))
