"""YOLOv13 blocks, NCHW: depth-wise separable convs, the hypergraph
correlation enhancement (HyperACE) and the gated FullPAD tunnels.

Counterpart of `ultralytics_pro_tpu/nn/modules/v13.py` (`DSBottleneck:26`,
`DSC3k:45`, `DSC3k2:67`, `AdaHGComputation:93`, `C3AH:134`, `HyperACE:154`,
`DownsampleConv:201`, `FullPAD_Tunnel:214`) and of
`ultralytics_pro_tpu/nn/modules/attention.py:DSConv:569`.

Where the JAX blocks differ from the torch reference, the port follows the
JAX package:
- DSConv has no dilation (the reference's `conv.py` DSConv has one).
- AdaHGComputation is the reference's AdaHyperedgeGen, AdaHGConv and
  AdaHGComputation folded into one module: its parameters are
  `prototype_base`, `context_net`, `pre_head_proj`, `edge_proj` and
  `node_proj` directly under it, with no `hgnn.edge_generator` level, so
  reference YOLOv13 weights load into neither package. It has no dropout
  (the reference's 0.1), and its GELU is the tanh form, `jax.nn.gelu`'s
  default.
- FullPAD_Tunnel's `gate` is a 0-d parameter that starts at 0, so at
  initialisation every path from HyperACE to the head is cut.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ultralytics_pro_tpu_torch.nn.modules.conv import Conv


class DSConv(nn.Module):
    """A k x k depth-wise Conv (`dwconv`, stride s) then a 1x1 Conv (`pwconv`)."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 1):
        super().__init__()
        self.dwconv = Conv(c1, c1, k, s, g=c1)
        self.pwconv = Conv(c1, c2, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.pwconv(self.dwconv(x))


class DSBottleneck(nn.Module):
    """DSConv k1 to c2 * e channels, DSConv k2 to c2, the residual when shortcut and c1 == c2."""

    def __init__(self, c1: int, c2: int, shortcut: bool = True, e: float = 0.5, k1: int = 3, k2: int = 5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = DSConv(c1, c_, k1)
        self.cv2 = DSConv(c_, c2, k2)
        self.add = shortcut and c1 == c2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class DSC3k(nn.Module):
    """C3 over n full-width DSBottlenecks (`m.i`): cv3(cat(m(cv1(x)), cv2(x)))."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True, e: float = 0.5, k1: int = 3,
                 k2: int = 5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, 1)
        self.cv2 = Conv(c1, c_, 1)
        self.cv3 = Conv(2 * c_, c2, 1)
        self.m = nn.Sequential(*(DSBottleneck(c_, c_, shortcut, 1.0, k1, k2) for _ in range(n)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.cv3(torch.cat([self.m(self.cv1(x)), self.cv2(x)], 1))


class DSC3k2(nn.Module):
    """C2f whose n inner blocks are DSC3k (two DSBottlenecks) when dsc3k,
    else DSBottlenecks of half width: cv1 to 2c channels split in two, each
    block on the last output, all concatenated into cv2."""

    def __init__(self, c1: int, c2: int, n: int = 1, dsc3k: bool = False, e: float = 0.5, shortcut: bool = True):
        super().__init__()
        self.c = int(c2 * e)
        self.cv1 = Conv(c1, 2 * self.c, 1)
        self.cv2 = Conv((2 + n) * self.c, c2, 1)
        self.m = nn.ModuleList(DSC3k(self.c, self.c, 2, shortcut) if dsc3k else DSBottleneck(self.c, self.c, shortcut)
                               for _ in range(n))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = list(self.cv1(x).chunk(2, 1))
        for m in self.m:
            y.append(m(y[-1]))
        return self.cv2(torch.cat(y, 1))


class AdaHGComputation(nn.Module):
    """Adaptive hypergraph convolution over the H*W tokens (in (h, w) order).

    The context (the tokens' mean and max concatenated for "both", or one of
    them) gives offsets (`context_net`) to the ne hyperedge prototypes
    (`prototype_base`); each head scores tokens against prototypes
    (`pre_head_proj`, over sqrt(hd)); the heads' mean, softmaxed over the
    tokens, is the participation A (B, N, E). Edges gather the tokens
    (A^T X, `edge_proj`, GELU), tokens gather the edges back (A He,
    `node_proj`, GELU), plus the tokens."""

    def __init__(self, c: int, num_hyperedges: int = 8, num_heads: int = 4, context: str = "both"):
        super().__init__()
        self.num_heads, self.num_hyperedges, self.context = num_heads, num_hyperedges, context
        self.prototype_base = nn.Parameter(torch.empty(num_hyperedges, c))
        nn.init.xavier_uniform_(self.prototype_base)
        self.context_net = nn.Linear(2 * c if context not in ("mean", "max") else c, num_hyperedges * c)
        self.pre_head_proj = nn.Linear(c, c)
        self.edge_proj = nn.Linear(c, c)
        self.node_proj = nn.Linear(c, c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        nh, ne = self.num_heads, self.num_hyperedges
        hd = c // nh
        tokens = x.flatten(2).transpose(1, 2)  # (B, N, C)
        if self.context == "mean":
            ctx = tokens.mean(1)
        elif self.context == "max":
            ctx = tokens.amax(1)
        else:
            ctx = torch.cat([tokens.mean(1), tokens.amax(1)], -1)
        protos = self.prototype_base[None] + self.context_net(ctx).view(b, ne, c)
        xh = self.pre_head_proj(tokens).view(b, -1, nh, hd)
        logits = torch.einsum("bnhd,behd->bhne", xh, protos.view(b, ne, nh, hd)) / math.sqrt(hd)
        a = logits.mean(1).softmax(1)  # (B, N, E), over the tokens
        he = F.gelu(self.edge_proj(torch.einsum("bne,bnc->bec", a, tokens)), approximate="tanh")
        xn = F.gelu(self.node_proj(torch.einsum("bne,bec->bnc", a, he)), approximate="tanh")
        return (xn + tokens).transpose(1, 2).reshape(b, c, h, w)


class C3AH(nn.Module):
    """CSP block around AdaHGComputation: c_ = c2 * e rounded down to a
    multiple of 16 (at least 16), c_ // 16 heads; cv3(cat(m(cv1(x)), cv2(x)))."""

    def __init__(self, c1: int, c2: int, e: float = 1.0, num_hyperedges: int = 8, context: str = "both"):
        super().__init__()
        c_ = max(16, (int(c2 * e) // 16) * 16)
        self.cv1 = Conv(c1, c_, 1)
        self.m = AdaHGComputation(c_, num_hyperedges, c_ // 16, context)
        self.cv2 = Conv(c1, c_, 1)
        self.cv3 = Conv(2 * c_, c2, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.cv3(torch.cat([self.m(self.cv1(x)), self.cv2(x)], 1))


class HyperACE(nn.Module):
    """Hypergraph-based adaptive correlation enhancement over (P3, P4, P5).

    The fuse step brings P3 (a 2x2 average pool) and P5 (nearest, 2x) to P4's
    size, concatenated into `fuse_conv` (to P4's channels). cv1 gives 3c
    channels, split (y0, y1, y2); `branch1` and `branch2` (C3AH) both read y1;
    n blocks (`m.i`, DSC3k of two 3/7 DSBottlenecks, or DSBottlenecks) run
    on y2 in a chain; cv2 takes [y0, branch1, y2, m.0 ... m.n-1, branch2]."""

    def __init__(self, c1, c2: int, n: int = 1, num_hyperedges: int = 8, dsc3k: bool = True,
                 shortcut: bool = False, e1: float = 0.5, e2: float = 1.0, context: str = "both"):
        super().__init__()
        c = int(c2 * e1)
        self.fuse_conv = Conv(sum(c1), c1[1], 1)
        self.cv1 = Conv(c1[1], 3 * c, 1)
        self.branch1 = C3AH(c, c, e2, num_hyperedges, context)
        self.branch2 = C3AH(c, c, e2, num_hyperedges, context)
        self.m = nn.ModuleList(DSC3k(c, c, 2, shortcut, k1=3, k2=7) if dsc3k else DSBottleneck(c, c, shortcut)
                               for _ in range(n))
        self.cv2 = Conv((4 + n) * c, c2, 1)

    def forward(self, xs) -> torch.Tensor:
        p3, p4, p5 = xs
        h, w = p4.shape[-2:]
        if p5.shape[-2:] != (h // 2, w // 2) or h % 2 or w % 2:
            # jax.image.resize's nearest samples at the half pixel: torch's floor-nearest equals it at 2x only
            raise ValueError(f"HyperACE needs P4 at exactly twice P5's size, got P4 {(h, w)} and P5 "
                             f"{tuple(p5.shape[-2:])}: use an image size that is a multiple of 32")
        p3d = F.avg_pool2d(p3, 2, 2)
        p5u = F.interpolate(p5, scale_factor=2, mode="nearest")
        y = self.cv1(self.fuse_conv(torch.cat([p3d, p4, p5u], 1)))
        y0, y1, y2 = y.chunk(3, 1)
        parts = [y0, self.branch1(y1), y2]
        for m in self.m:
            parts.append(m(parts[-1]))
        parts.append(self.branch2(y1))
        return self.cv2(torch.cat(parts, 1))


class DownsampleConv(nn.Module):
    """A 2x2 average pool (stride 2), then, when channel_adjust, a 1x1 Conv
    (`channel_adjust`) to 2 * c1 channels."""

    def __init__(self, c1: int, channel_adjust: bool = True):
        super().__init__()
        self.channel_adjust = Conv(c1, 2 * c1, 1) if channel_adjust else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.avg_pool2d(x, 2, 2)
        return self.channel_adjust(y) if self.channel_adjust is not None else y


class FullPAD_Tunnel(nn.Module):
    """x[0] + gate * x[1], gate a 0-d parameter starting at 0."""

    def __init__(self):
        super().__init__()
        self.gate = nn.Parameter(torch.zeros(()))

    def forward(self, xs) -> torch.Tensor:
        return xs[0] + self.gate * xs[1]
