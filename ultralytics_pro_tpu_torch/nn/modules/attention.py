"""The attention modules of the v5/v8 attention YAMLs, NCHW, under the JAX
package's parameter names.

Counterpart of `ultralytics_pro_tpu/nn/modules/attention.py` (`_bn:23`,
`MHSA:29`, `CoordAtt:88`, `SEAttention:242`, `ECAAttention:256`,
`SimAM:271`, `EMA:287`, `GAMAttention:317`, `CrissCrossAttention:344`,
`SKAttention:368`, `_ZPoolGate:392`, `TripletAttention:402`,
`ShuffleAttention:420`, `LSKblock:445`, `EffectiveSE:512`,
`SegNext_Attention:586`, `DAttention:606`, `LSKA:670`, `CPCA:694`,
`FocusedLinearAttention:725`), and the blocks of yolov8-att.yaml
(`BottleneckTransformer:58`, `BoT3:71`, `DCNv2:109`, `C2f_DCN:138`,
`C3_DCN:158`, `DeformConvDW:178`, `deformable_LKA:199`,
`deformable_LKA_Attention:211`, `C2f_DLKA:224`). Each attention module's
output has its input's channels. Parameter names are those `utils/weights.py` gives the flax
names: `fc_0` is `fc.0`, `conv_offset_1` is `conv_offset.1`, a name whose
last token is not a number (`convs_0_conv`, `strip0_h`) stays as it is.
SegNext_Attention's `conv0_1` and `conv0_2` are therefore children `1` and
`2` of its `conv0`, and its `conv1_*`, `conv2_*` children of containers
`conv1`, `conv2`; deformable_LKA_Attention's `proj_1`, `proj_2` children of
`proj`; C2f_DCN's and C3_DCN's `m_0_cv1`, `m_0_cv2` keep their names.
DCNv2's and DeformConvDW's kernels are bare `weight` parameters with a
`bias`, as flax holds them (HWIO there, OIHW here: `utils/weights.py`).

Where the JAX modules depart from the torch reference, the port follows
them:
- EMA and ShuffleAttention regroup the map by reshaping its NHWC array,
  (B, H, W, C) -> (B * G, H, W, C / G), which interleaves pixels and
  channels; the port reshapes the same NHWC layout.
- GAMAttention's channel branch multiplies by its MLP's output with no
  sigmoid; TripletAttention's YAML argument (1024) is its `no_spatial`, so
  the YAML models average two gates and build no `hw` gate.
- MHSA has no scaling and no output projection; its `rel_h` (1, heads, hd,
  H, 1) and `rel_w` (1, heads, hd, 1, W) are sized by the map it is built
  for (`MHSA.bind`; `BaseModel` binds it at its `imgsz`), and a map of
  another size raises, as flax raises a ScopeParamShapeError there.
- BatchNorm is the port's (eps 1e-3, flax's running statistics). GroupNorm
  and LayerNorm take flax's epsilon, 1e-6, and torch's two-pass variance
  where flax takes E[x^2] - E[x]^2. GELU is the tanh form.

Zero-initialised parameters: CrissCrossAttention's `gamma` (the module is
the identity until it moves), ShuffleAttention's `cweight` and `sweight`,
FocusedLinearAttention's `pos` and `scale`. DCNv2's `conv_offset_mask` and
DeformConvDW's `offset_net` start lecun-normal, as flax starts them, not at
zero as the reference's do: the sampling points move from the first step.

The deformable convs sample through `ops/deform.py:deform_conv2d`, plain
torch (plain XLA in the JAX package).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ultralytics_pro_tpu_torch.nn.modules.conv import BN_EPS, BN_MOMENTUM, BatchNorm2d, Conv, conv_act
from ultralytics_pro_tpu_torch.ops.deform import deform_conv2d

NORM_EPS = 1e-6  # flax's GroupNorm and LayerNorm


def _bn(c: int) -> BatchNorm2d:
    return BatchNorm2d(c, eps=BN_EPS, momentum=BN_MOMENTUM)


def _dw(c: int, kh: int, kw: int, dilation=(1, 1), padding=None) -> nn.Conv2d:
    """A biased depth-wise conv, by default padded to keep the size."""
    pad = padding if padding is not None else (kh // 2 * dilation[0], kw // 2 * dilation[1])
    return nn.Conv2d(c, c, (kh, kw), padding=pad, dilation=dilation, groups=c)


def nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


class MHSA(nn.Module):
    """Multi-head self-attention over the map's H * W positions, q, k, v by
    biased 1x1 convs, energy q.k plus q.(rel_h + rel_w), no scaling and no
    output projection. Unbound (`rel_h` None) until `bind(h, w)`."""

    def __init__(self, c1: int, heads: int = 4, pos_emb: bool = True):
        super().__init__()
        self.heads, self.hd, self.pos_emb = heads, c1 // heads, pos_emb
        self.query = nn.Conv2d(c1, c1, 1)
        self.key = nn.Conv2d(c1, c1, 1)
        self.value = nn.Conv2d(c1, c1, 1)
        self.rel_h = self.rel_w = None

    @property
    def size_params(self) -> tuple:
        """The parameters sized by the map (`nn/tasks.py:size_bound`)."""
        return ("rel_h", "rel_w") if self.pos_emb else ()

    def bind(self, h: int, w: int) -> None:
        """(Re)create `rel_h` and `rel_w` (zeros) for an h x w map."""
        if self.pos_emb:
            self.rel_h = nn.Parameter(torch.zeros(1, self.heads, self.hd, h, 1))
            self.rel_w = nn.Parameter(torch.zeros(1, self.heads, self.hd, 1, w))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        n = h * w
        if self.pos_emb:
            want = (1, self.heads, self.hd, h, 1)
            if self.rel_h is None or tuple(self.rel_h.shape) != want or self.rel_w.shape[-1] != w:
                got = None if self.rel_h is None else (tuple(self.rel_h.shape), tuple(self.rel_w.shape))
                raise ValueError(f"MHSA parameters 'rel_h', 'rel_w' have shapes {got}, an {h} x {w} map wants "
                                 f"{want} and {(1, self.heads, self.hd, 1, w)}: the module is bound to the map "
                                 "size of the image size it was built for")
        q, k, v = (m(x).reshape(b, self.heads, self.hd, n) for m in (self.query, self.key, self.value))
        energy = torch.einsum("bhdn,bhdm->bhnm", q, k)
        if self.pos_emb:
            pos = (self.rel_h + self.rel_w).reshape(self.heads, self.hd, n)
            energy = energy + torch.einsum("bhdn,hdm->bhnm", q, pos)
        attn = energy.softmax(-1)
        return torch.einsum("bhnm,bhdm->bhdn", attn, v).reshape(b, c, h, w)


class CoordAtt(nn.Module):
    """Coordinate attention: the map pooled along W and along H, through a
    shared 1x1 conv (`conv1`), BN (`bn1`) and h-swish, then sigmoid gates
    along H (`conv_h`) and W (`conv_w`)."""

    def __init__(self, c1: int, reduction: int = 32):
        super().__init__()
        mip = max(8, c1 // reduction)
        self.conv1 = nn.Conv2d(c1, mip, 1)
        self.bn1 = _bn(mip)
        self.conv_h = nn.Conv2d(mip, c1, 1)
        self.conv_w = nn.Conv2d(mip, c1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.shape[2]
        y = torch.cat([x.mean(3), x.mean(2)], 2)[..., None]  # (B, C, H + W, 1)
        y = self.bn1(self.conv1(y))
        y = y * F.relu6(y + 3) / 6
        a_h = torch.sigmoid(self.conv_h(y[:, :, :h]))  # (B, C, H, 1)
        a_w = torch.sigmoid(self.conv_w(y[:, :, h:])).transpose(2, 3)  # (B, C, 1, W)
        return x * a_h * a_w


class SEAttention(nn.Module):
    """Squeeze-and-excitation: the spatial mean through `fc.0`, ReLU, `fc.1`, sigmoid."""

    def __init__(self, c1: int, reduction: int = 16):
        super().__init__()
        hid = max(c1 // reduction, 4)
        self.fc = nn.ModuleList([nn.Linear(c1, hid), nn.Linear(hid, c1)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.sigmoid(self.fc[1](F.relu(self.fc[0](x.mean((2, 3))))))
        return x * y[:, :, None, None]


class ECAAttention(nn.Module):
    """Efficient channel attention: a biased 1-D conv of kernel_size over the
    pooled channels (`conv`, a Conv1d of one channel), sigmoid."""

    def __init__(self, kernel_size: int = 3):
        super().__init__()
        self.conv = nn.Conv1d(1, 1, kernel_size, padding=kernel_size // 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv(x.mean((2, 3))[:, None, :])[:, 0]  # (B, C)
        return x * torch.sigmoid(y)[:, :, None, None]


class SimAM(nn.Module):
    """Parameter-free energy attention."""

    def __init__(self, e_lambda: float = 1e-4):
        super().__init__()
        self.e_lambda = e_lambda

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = x.shape[2] * x.shape[3] - 1
        d = (x - x.mean((2, 3), keepdim=True)) ** 2
        v = d.sum((2, 3), keepdim=True) / n
        return x * torch.sigmoid(d / (4 * (v + self.e_lambda)) + 0.5)


class EMA(nn.Module):
    """Efficient multi-scale attention over G = factor groups of the NHWC
    array reshaped (B * G, H, W, C / G): a 1x1 conv of the H- and W-pooled
    group (`conv1x1`) gating it, GroupNorm (`gn`, one channel a group), a 3x3
    conv (`conv3x3`), and the two branches' cross attention as a sigmoid
    gate of each position."""

    def __init__(self, c1: int, factor: int = 8):
        super().__init__()
        self.g = factor
        cg = c1 // factor
        self.conv1x1 = nn.Conv2d(cg, cg, 1)
        self.conv3x3 = nn.Conv2d(cg, cg, 3, padding=1)
        self.gn = nn.GroupNorm(cg, cg, eps=NORM_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        bg, cg = b * self.g, c // self.g
        xg = nhwc(x).reshape(bg, h, w, cg)
        xh = xg.mean(2)[:, :, None, :]  # (bg, H, 1, cg)
        xw = xg.mean(1)[:, :, None, :]  # (bg, W, 1, cg)
        hw = nhwc(self.conv1x1(nchw(torch.cat([xh, xw], 1))))
        ah, aw = hw[:, :h], hw[:, h:]
        gated = xg * torch.sigmoid(ah).reshape(bg, h, 1, cg) * torch.sigmoid(aw).reshape(bg, 1, w, cg)
        xg1 = nhwc(self.gn(nchw(gated)))
        xg2 = nhwc(self.conv3x3(nchw(xg)))
        x11 = xg1.mean((1, 2)).softmax(-1)[:, None, :]  # (bg, 1, cg)
        x21 = xg2.mean((1, 2)).softmax(-1)[:, None, :]
        weights = (torch.einsum("boc,bnc->bn", x11, xg2.reshape(bg, h * w, cg))
                   + torch.einsum("boc,bnc->bn", x21, xg1.reshape(bg, h * w, cg)))
        weights = torch.sigmoid(weights.reshape(bg, h, w, 1))
        return nchw((xg * weights).reshape(b, h, w, c))


class GAMAttention(nn.Module):
    """Global attention: x times a per-pixel MLP of x (`channel_attention.0`,
    ReLU, `.2`; no sigmoid), then times a sigmoid spatial gate of two grouped
    7x7 convs with BN (`spatial_attention.0/.1`, ReLU, `.3/.4`), its channels
    shuffled over 4 groups."""

    def __init__(self, c1: int, c2: int = 0, group: bool = True, rate: int = 4):
        super().__init__()
        g = rate if group else 1
        c2 = c2 or c1
        self.channel_attention = nn.Sequential(nn.Linear(c1, c1 // rate), nn.ReLU(), nn.Linear(c1 // rate, c1))
        self.spatial_attention = nn.Sequential(
            nn.Conv2d(c1, c1 // rate, 7, padding=3, groups=g), _bn(c1 // rate), nn.ReLU(),
            nn.Conv2d(c1 // rate, c2, 7, padding=3, groups=g), _bn(c2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x * nchw(self.channel_attention(nhwc(x)))
        s = torch.sigmoid(self.spatial_attention(x))
        b, cc, h, w = s.shape
        return x * s.reshape(b, 4, cc // 4, h, w).transpose(1, 2).reshape(b, cc, h, w)


class CrissCrossAttention(nn.Module):
    """Criss-cross attention: each position attends to its column (itself
    masked with -inf) and its row, one softmax over both; `gamma` (0 at
    init) scales the result added to x."""

    def __init__(self, c1: int):
        super().__init__()
        self.query_conv = nn.Conv2d(c1, c1 // 8, 1)
        self.key_conv = nn.Conv2d(c1, c1 // 8, 1)
        self.value_conv = nn.Conv2d(c1, c1, 1)
        self.gamma = nn.Parameter(torch.zeros(1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.shape[2]
        q, k, v = self.query_conv(x), self.key_conv(x), self.value_conv(x)
        e_h = torch.einsum("bchw,bckw->bhwk", q, k)
        e_h = e_h.masked_fill(torch.eye(h, dtype=torch.bool, device=x.device)[:, None, :], -math.inf)
        e_w = torch.einsum("bchw,bchk->bhwk", q, k)
        att = torch.cat([e_h, e_w], -1).softmax(-1)
        out = torch.einsum("bhwk,bckw->bchw", att[..., :h], v) + torch.einsum("bhwk,bchk->bchw", att[..., h:], v)
        return self.gamma * out + x


class SKAttention(nn.Module):
    """Selective kernel: biased k x k conv + BN + ReLU branches
    (`convs_{i}_conv`, `convs_{i}_bn`) fused by a softmax over the branches
    of per-channel weights (`fc`, then `fcs.{i}`)."""

    def __init__(self, c1: int, kernels=(1, 3, 5, 7), reduction: int = 16, L: int = 32):
        super().__init__()
        d = max(L, c1 // reduction)
        self.kernels = tuple(kernels)
        for i, k in enumerate(self.kernels):
            self.add_module(f"convs_{i}_conv", nn.Conv2d(c1, c1, k, padding=k // 2))
            self.add_module(f"convs_{i}_bn", _bn(c1))
        self.fc = nn.Linear(c1, d)
        self.fcs = nn.ModuleList(nn.Linear(d, c1) for _ in self.kernels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feats = [F.relu(getattr(self, f"convs_{i}_bn")(getattr(self, f"convs_{i}_conv")(x)))
                 for i in range(len(self.kernels))]
        u = sum(feats)
        z = self.fc(u.mean((2, 3)))
        ws = torch.stack([fc(z) for fc in self.fcs], 0).softmax(0)[..., None, None]  # (K, B, C, 1, 1)
        return (ws * torch.stack(feats, 0)).sum(0)


class _ZPoolGate(nn.Module):
    """x times the sigmoid of a 7x7 conv (`conv`, no bias) + BN (`bn`) of its
    channel max and mean (dim 1 is the pooled axis)."""

    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(2, 1, 7, padding=3, bias=False)
        self.bn = _bn(1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        z = torch.cat([x.amax(1, keepdim=True), x.mean(1, keepdim=True)], 1)
        return x * torch.sigmoid(self.bn(self.conv(z)))


class TripletAttention(nn.Module):
    """A _ZPoolGate over each pairing of axes, averaged: `cw` pools H (its
    plane C x W), `hc` pools W (plane H x C), `hw` pools C (plane H x W,
    left out with no_spatial)."""

    def __init__(self, no_spatial: bool = False):
        super().__init__()
        self.no_spatial = bool(no_spatial)
        self.cw = _ZPoolGate()
        self.hc = _ZPoolGate()
        if not self.no_spatial:
            self.hw = _ZPoolGate()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1 = self.cw(x.permute(0, 2, 1, 3)).permute(0, 2, 1, 3)
        x2 = self.hc(x.permute(0, 3, 2, 1)).permute(0, 3, 2, 1)
        if self.no_spatial:
            return 0.5 * (x1 + x2)
        return (x1 + x2 + self.hw(x)) / 3.0


class ShuffleAttention(nn.Module):
    """Shuffle attention over G groups of the NHWC array reshaped (B * G, H,
    W, C / G): each group's first half gated by its mean (`cweight`,
    `cbias`), its second by its GroupNorm (`gn`; `sweight`, `sbias`), then
    the channels shuffled over 2 groups. The four parameters keep flax's
    (1, 1, 1, C / 2G) shape."""

    def __init__(self, c1: int, G: int = 8):
        super().__init__()
        self.G = G
        cg = c1 // G // 2
        self.cweight = nn.Parameter(torch.zeros(1, 1, 1, cg))
        self.cbias = nn.Parameter(torch.ones(1, 1, 1, cg))
        self.sweight = nn.Parameter(torch.zeros(1, 1, 1, cg))
        self.sbias = nn.Parameter(torch.ones(1, 1, 1, cg))
        self.gn = nn.GroupNorm(cg, cg, eps=NORM_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        cg = c // self.G // 2
        xg = nhwc(x).reshape(b * self.G, h, w, 2 * cg)
        x0, x1 = xg[..., :cg], xg[..., cg:]
        xc = x0 * torch.sigmoid(self.cweight * x0.mean((1, 2), keepdim=True) + self.cbias)
        xs = x1 * torch.sigmoid(self.sweight * nhwc(self.gn(nchw(x1))) + self.sbias)
        y = torch.cat([xc, xs], -1).reshape(b, h, w, 2, c // 2).transpose(-1, -2).reshape(b, h, w, c)
        return nchw(y)


class LSKblock(nn.Module):
    """Large selective kernel: a 5x5 and a dilated 7x7 depth-wise conv
    (`conv0`, `conv_spatial`), each to C/2 (`conv1`, `conv2`), mixed by a
    sigmoid 7x7 conv of their channel mean and max (`conv_squeeze`), then a
    1x1 conv (`conv`) gating x."""

    def __init__(self, c1: int):
        super().__init__()
        self.conv0 = _dw(c1, 5, 5)
        self.conv_spatial = _dw(c1, 7, 7, dilation=(3, 3))
        self.conv1 = nn.Conv2d(c1, c1 // 2, 1)
        self.conv2 = nn.Conv2d(c1, c1 // 2, 1)
        self.conv_squeeze = nn.Conv2d(2, 2, 7, padding=3)
        self.conv = nn.Conv2d(c1 // 2, c1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a1 = self.conv0(x)
        a2 = self.conv_spatial(a1)
        a1, a2 = self.conv1(a1), self.conv2(a2)
        att = torch.cat([a1, a2], 1)
        sig = torch.sigmoid(self.conv_squeeze(torch.cat([att.mean(1, keepdim=True), att.amax(1, keepdim=True)], 1)))
        return x * self.conv(a1 * sig[:, :1] + a2 * sig[:, 1:])


class EffectiveSE(nn.Module):
    """Effective squeeze-excite: a biased 1x1 conv (`fc`) of the spatial mean
    (with add_maxpool, the mean and max averaged), a hard-sigmoid gate."""

    def __init__(self, c1: int, add_maxpool: bool = False):
        super().__init__()
        self.add_maxpool = add_maxpool
        self.fc = nn.Conv2d(c1, c1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        se = x.mean((2, 3), keepdim=True)
        if self.add_maxpool:
            se = 0.5 * se + 0.5 * x.amax((2, 3), keepdim=True)
        return x * torch.clamp(self.fc(se) / 6.0 + 0.5, 0.0, 1.0)


class SegNext_Attention(nn.Module):
    """SegNeXt's multi-scale conv attention: a 5x5 depth-wise conv (`conv0`),
    plus 1 x k then k x 1 depth-wise strips for k = 7, 11, 21 (`conv0.1`,
    `conv0.2`; `conv1.1`, `conv1.2`; `conv2.1`, `conv2.2`), summed, a 1x1
    conv (`conv3`) gating x."""

    def __init__(self, c1: int):
        super().__init__()
        self.conv0 = _dw(c1, 5, 5)
        self.conv1, self.conv2 = nn.ModuleDict(), nn.ModuleDict()
        for owner, k in ((self.conv0, 7), (self.conv1, 11), (self.conv2, 21)):
            owner.add_module("1", _dw(c1, 1, k))
            owner.add_module("2", _dw(c1, k, 1))
        self.conv3 = nn.Conv2d(c1, c1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        attn = self.conv0(x)
        strips = [o._modules["2"](o._modules["1"](attn)) for o in (self.conv0, self.conv1, self.conv2)]
        return self.conv3(attn + strips[0] + strips[1] + strips[2]) * x


class LayerNorm2d(nn.LayerNorm):
    """LayerNorm over the channels of an NCHW map."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return nchw(super().forward(nhwc(x)))


class DAttention(nn.Module):
    """Deformable attention (the JAX DAT form): q by a 1x1 conv (`proj_q`);
    an offset net on q (`conv_offset.0` depth-wise k x k, `.1` LayerNorm,
    tanh GELU, `.3` 1x1 to (dy, dx), no bias) deforms the align-corners
    reference grid, clamped to [-1, 1]; x is sampled there bilinearly as the
    JAX package writes it (clamp, floor, the four corners), keys and values
    from the samples (`proj_k`, `proj_v`); n_heads-head softmax attention
    plus a depth-wise 3x3 of q (`rpe_table`), then `proj_out`."""

    def __init__(self, c1: int, n_heads: int = 8, ksize: int = 9):
        super().__init__()
        self.n_heads, self.hd = n_heads, c1 // n_heads
        self.proj_q = nn.Conv2d(c1, c1, 1)
        self.conv_offset = nn.Sequential(_dw(c1, ksize, ksize), LayerNorm2d(c1, eps=NORM_EPS),
                                         nn.GELU(approximate="tanh"), nn.Conv2d(c1, 2, 1, bias=False))
        self.proj_k = nn.Conv2d(c1, c1, 1)
        self.proj_v = nn.Conv2d(c1, c1, 1)
        self.rpe_table = _dw(c1, 3, 3)
        self.proj_out = nn.Conv2d(c1, c1, 1)

    @staticmethod
    def sample(x: torch.Tensor, off: torch.Tensor) -> torch.Tensor:
        """x (B, C, H, W) at the reference grid plus off (B, 2, H, W), (dy, dx)
        in [-1, 1] units, bilinearly."""
        b, c, h, w = x.shape
        gy = torch.linspace(-1.0, 1.0, h, dtype=x.dtype, device=x.device)
        gx = torch.linspace(-1.0, 1.0, w, dtype=x.dtype, device=x.device)
        py = ((gy[:, None] + off[:, 0]).clamp(-1.0, 1.0) + 1.0) * 0.5 * (h - 1)
        px = ((gx[None, :] + off[:, 1]).clamp(-1.0, 1.0) + 1.0) * 0.5 * (w - 1)
        y0, x0 = torch.floor(py).long(), torch.floor(px).long()
        y1, x1 = (y0 + 1).clamp(0, h - 1), (x0 + 1).clamp(0, w - 1)
        y0, x0 = y0.clamp(0, h - 1), x0.clamp(0, w - 1)
        wy, wx = (py - y0)[:, None], (px - x0)[:, None]
        flat = x.reshape(b, c, h * w)

        def take(yy, xx):
            return flat.gather(2, (yy * w + xx).reshape(b, 1, h * w).expand(b, c, h * w)).reshape(b, c, h, w)

        return ((take(y0, x0) * (1 - wy) * (1 - wx)) + (take(y0, x1) * (1 - wy) * wx)
                + (take(y1, x0) * wy * (1 - wx)) + (take(y1, x1) * wy * wx))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        n = h * w
        q = self.proj_q(x)
        xs = self.sample(x, self.conv_offset(q))
        k, v = self.proj_k(xs), self.proj_v(xs)

        def heads(t):  # (B, nh, N, hd)
            return t.reshape(b, self.n_heads, self.hd, n).transpose(-1, -2)

        attn = (heads(q) @ heads(k).transpose(-1, -2) * self.hd ** -0.5).softmax(-1)
        out = (attn @ heads(v)).transpose(-1, -2).reshape(b, c, h, w)
        return self.proj_out(out + self.rpe_table(q))


class LSKA(nn.Module):
    """Large separable kernel attention: 1x5 then 5x1 depth-wise (`dw_h`,
    `dw_v`), then 1 x ke and ke x 1 depth-wise at dilation d (`dwd_h`,
    `dwd_v`, XLA's SAME padding: the odd pixel after), a 1x1 conv (`pw`)
    gating x; d = max(k // 3, 2), ke = k // d + 1."""

    def __init__(self, c1: int, k: int = 11):
        super().__init__()
        d = max(k // 3, 2)
        ke = k // d + 1
        total = (ke - 1) * d
        self.pad = (total // 2, total - total // 2)
        self.dw_h = _dw(c1, 1, 5)
        self.dw_v = _dw(c1, 5, 1)
        self.dwd_h = _dw(c1, 1, ke, dilation=(1, d), padding=0)
        self.dwd_v = _dw(c1, ke, 1, dilation=(d, 1), padding=0)
        self.pw = nn.Conv2d(c1, c1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a = self.dw_v(self.dw_h(x))
        a = self.dwd_h(F.pad(a, (*self.pad, 0, 0)))
        a = self.dwd_v(F.pad(a, (0, 0, *self.pad)))
        return x * self.pw(a)


class CPCA(nn.Module):
    """Channel-prior conv attention: a sigmoid channel gate of the mean's and
    the max's MLPs (`ca_fc1`, `ca_fc2`; `ca2_fc1`, `ca2_fc2`), then a sigmoid
    spatial gate: a 5x5 depth-wise conv (`dw5`) plus 1 x k then k x 1
    depth-wise strips for k = 7, 11, 21 (`strip{i}_h`, `strip{i}_v`), each on
    the channel-gated map, summed, a 1x1 conv (`pw`)."""

    STRIPS = (7, 11, 21)

    def __init__(self, c1: int, reduction: int = 4):
        super().__init__()
        hid = max(c1 // reduction, 8)
        for prefix in ("ca", "ca2"):
            self.add_module(f"{prefix}_fc1", nn.Linear(c1, hid))
            self.add_module(f"{prefix}_fc2", nn.Linear(hid, c1))
        self.dw5 = _dw(c1, 5, 5)
        for i, k in enumerate(self.STRIPS):
            self.add_module(f"strip{i}_h", _dw(c1, 1, k))
            self.add_module(f"strip{i}_v", _dw(c1, k, 1))
        self.pw = nn.Conv2d(c1, c1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        def mlp(v, prefix):
            return getattr(self, f"{prefix}_fc2")(F.relu(getattr(self, f"{prefix}_fc1")(v)))

        ca = torch.sigmoid(mlp(x.mean((2, 3)), "ca") + mlp(x.amax((2, 3)), "ca2"))
        y = x * ca[:, :, None, None]
        s = self.dw5(y)
        for i in range(len(self.STRIPS)):
            s = s + getattr(self, f"strip{i}_v")(getattr(self, f"strip{i}_h")(y))
        return y * torch.sigmoid(self.pw(s))


class FocusedLinearAttention(nn.Module):
    """Focused linear attention over the H * W tokens: q and kv by dense
    layers over channels (`q`, `kv`), k plus `pos`, both through ReLU,
    divided by softplus(`scale`), raised to `focusing` with their norms
    restored; O(N d^2) attention per head; a depth-wise conv of v (`dwc`)
    added; a dense projection (`proj`). Heads fall back to 1 where C does
    not divide."""

    def __init__(self, c1: int, num_heads: int = 8, focusing: float = 3.0, dw_k: int = 5):
        super().__init__()
        self.nh = num_heads if c1 % num_heads == 0 else 1
        self.focusing = focusing
        self.q = nn.Linear(c1, c1)
        self.kv = nn.Linear(c1, 2 * c1)
        self.pos = nn.Parameter(torch.zeros(1, 1, c1))
        self.scale = nn.Parameter(torch.zeros(1, 1, c1))
        self.dwc = _dw(c1, dw_k, dw_k)
        self.proj = nn.Linear(c1, c1)

    def _focus(self, t: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
        t = (F.relu(t) + 1e-6) / (scale + 1e-6)
        norm = torch.linalg.vector_norm(t, dim=-1, keepdim=True)
        t = t ** self.focusing
        return t / (torch.linalg.vector_norm(t, dim=-1, keepdim=True) + 1e-6) * norm

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        n, hd = h * w, c // self.nh
        t = x.flatten(2).transpose(1, 2)  # (B, N, C)
        k, v = self.kv(t).chunk(2, -1)
        scale = F.softplus(self.scale)
        q, k = self._focus(self.q(t), scale), self._focus(k + self.pos, scale)

        def heads(z):  # (B, nh, N, hd)
            return z.reshape(b, n, self.nh, hd).transpose(1, 2)

        q, k, vh = heads(q), heads(k), heads(v)
        z = 1.0 / (torch.einsum("bhnd,bhd->bhn", q, k.sum(2)) + 1e-6)
        kv_ctx = torch.einsum("bhnd,bhne->bhde", k, vh)
        out = torch.einsum("bhnd,bhde->bhne", q, kv_ctx) * z[..., None]
        out = out.transpose(1, 2).reshape(b, n, c)
        out = out + self.dwc(v.transpose(1, 2).reshape(b, c, h, w)).flatten(2).transpose(1, 2)
        return self.proj(out).transpose(1, 2).reshape(b, c, h, w)


class BottleneckTransformer(nn.Module):
    """A 1x1 Conv (`cv1`) then MHSA (`mhsa`), with the residual where c1 == c2."""

    def __init__(self, c1: int, c2: int, heads: int = 4):
        super().__init__()
        self.cv1 = Conv(c1, c2, 1)
        self.mhsa = MHSA(c2, heads)
        self.add = c1 == c2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.mhsa(self.cv1(x))
        return x + y if self.add else y


class BoT3(nn.Module):
    """C3 over n BottleneckTransformers (`m`): `cv1` through them beside
    `cv2`, both 1x1 to c2 e, concatenated into `cv3`."""

    def __init__(self, c1: int, c2: int, n: int = 1, e: float = 0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, 1)
        self.cv2 = Conv(c1, c_, 1)
        self.m = nn.Sequential(*(BottleneckTransformer(c_, c_) for _ in range(n)))
        self.cv3 = Conv(2 * c_, c2, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.cv3(torch.cat([self.m(self.cv1(x)), self.cv2(x)], 1))


class DCNv2(nn.Module):
    """Modulated deformable conv: a biased k x k conv (`conv_offset_mask`)
    gives 3K channels, K = k * k: the first 2K the (dy, dx) offsets, the
    rest the mask through a sigmoid; the deformable conv with the bare
    `weight` (c2, c1, k, k) and `bias`, padding (k - 1) // 2, then `bn` and
    the activation."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 1, act=True):
        super().__init__()
        self.k, self.s, self.p = k, s, (k - 1) // 2
        self.conv_offset_mask = nn.Conv2d(c1, 3 * k * k, k, s, self.p)
        self.weight = nn.Parameter(torch.empty(c2, c1, k, k))
        self.bias = nn.Parameter(torch.zeros(c2))
        nn.init.kaiming_uniform_(self.weight, a=math.sqrt(5))
        self.bn = _bn(c2)
        self.act = conv_act(act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kk = self.k * self.k
        om = self.conv_offset_mask(x)
        y = deform_conv2d(x, om[:, :2 * kk], self.weight, torch.sigmoid(om[:, 2 * kk:]), self.bias, self.s, self.p)
        return self.act(self.bn(y))


class C2f_DCN(nn.Module):
    """C2f whose n inner blocks are a 3x3 Conv (`m_i_cv1`) then DCNv2
    (`m_i_cv2`), with the residual where shortcut."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = False, e: float = 0.5):
        super().__init__()
        self.c, self.n, self.shortcut = int(c2 * e), n, shortcut
        self.cv1 = Conv(c1, 2 * self.c, 1)
        for i in range(n):
            self.add_module(f"m_{i}_cv1", Conv(self.c, self.c, 3))
            self.add_module(f"m_{i}_cv2", DCNv2(self.c, self.c, 3))
        self.cv2 = Conv((2 + n) * self.c, c2, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ys = list(self.cv1(x).chunk(2, 1))
        for i in range(self.n):
            z = self._modules[f"m_{i}_cv2"](self._modules[f"m_{i}_cv1"](ys[-1]))
            ys.append(ys[-1] + z if self.shortcut else z)
        return self.cv2(torch.cat(ys, 1))


class C3_DCN(nn.Module):
    """C3 whose n inner blocks are a 1x1 Conv (`m_i_cv1`) then DCNv2
    (`m_i_cv2`), with the residual where shortcut."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True, e: float = 0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.n, self.shortcut = n, shortcut
        self.cv1 = Conv(c1, c_, 1)
        self.cv2 = Conv(c1, c_, 1)
        for i in range(n):
            self.add_module(f"m_{i}_cv1", Conv(c_, c_, 1))
            self.add_module(f"m_{i}_cv2", DCNv2(c_, c_, 3))
        self.cv3 = Conv(2 * c_, c2, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a = self.cv1(x)
        for i in range(self.n):
            z = self._modules[f"m_{i}_cv2"](self._modules[f"m_{i}_cv1"](a))
            a = a + z if self.shortcut else z
        return self.cv3(torch.cat([a, self.cv2(x)], 1))


class DeformConvDW(nn.Module):
    """Depth-wise deformable conv: a biased k x k conv at dilation d
    (`offset_net`, padding d (k - 1) / 2) gives the (dy, dx) offsets of the
    K taps, then the deformable conv with the bare depth-wise `weight`
    (C, 1, k, k) and `bias`, at the same padding and dilation."""

    def __init__(self, c1: int, k: int = 5, d: int = 1):
        super().__init__()
        self.k, self.d, self.p = k, d, d * (k - 1) // 2
        self.offset_net = nn.Conv2d(c1, 2 * k * k, k, padding=self.p, dilation=d)
        self.weight = nn.Parameter(torch.empty(c1, 1, k, k))
        self.bias = nn.Parameter(torch.zeros(c1))
        nn.init.kaiming_uniform_(self.weight, a=math.sqrt(5))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return deform_conv2d(x, self.offset_net(x), self.weight, None, self.bias, 1, self.p, self.d, x.shape[1])


class deformable_LKA(nn.Module):  # noqa: N801 (the reference's name)
    """Deformable large-kernel attention: a 5x5 DeformConvDW (`conv0`), a 7x7
    one at dilation 3 (`conv_spatial`), a biased 1x1 conv (`conv1`), gating x."""

    def __init__(self, c1: int):
        super().__init__()
        self.conv0 = DeformConvDW(c1, 5, 1)
        self.conv_spatial = DeformConvDW(c1, 7, 3)
        self.conv1 = nn.Conv2d(c1, c1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.conv1(self.conv_spatial(self.conv0(x)))


class deformable_LKA_Attention(nn.Module):  # noqa: N801 (the reference's name)
    """A biased 1x1 conv (`proj.1`), tanh GELU, deformable_LKA
    (`spatial_gating_unit`), a biased 1x1 conv (`proj.2`), plus x."""

    def __init__(self, c1: int):
        super().__init__()
        self.proj = nn.ModuleDict({"1": nn.Conv2d(c1, c1, 1), "2": nn.Conv2d(c1, c1, 1)})
        self.spatial_gating_unit = deformable_LKA(c1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.gelu(self.proj["1"](x), approximate="tanh")
        return x + self.proj["2"](self.spatial_gating_unit(y))


class C2f_DLKA(nn.Module):
    """C2f whose n inner blocks are deformable_LKA_Attention (`m`); shortcut
    is taken and unused, as the JAX block takes it."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = False, e: float = 0.5):
        super().__init__()
        self.c = int(c2 * e)
        self.cv1 = Conv(c1, 2 * self.c, 1)
        self.m = nn.ModuleList(deformable_LKA_Attention(self.c) for _ in range(n))
        self.cv2 = Conv((2 + n) * self.c, c2, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ys = list(self.cv1(x).chunk(2, 1))
        for m in self.m:
            ys.append(m(ys[-1]))
        return self.cv2(torch.cat(ys, 1))
