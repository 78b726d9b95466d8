"""Whole backbones, tranche 1: ConvNeXt, Swin Transformer, PVTv2 and
EfficientViT, each one module that returns its 4 stage maps (strides 4, 8,
16, 32), NCHW, under the JAX package's parameter names.

Counterpart of `ultralytics_pro_tpu/nn/modules/backbones.py`
(`ConvNeXtBlock:31`, `ConvNeXt:65`, `_window_partition:93`,
`_window_reverse:99`, `_rel_pos_index:105`, `_shift_mask:114`,
`SwinBlock:129`, `SwinTransformer:188`, `PVT2Block:223`, `PVTv2:261`,
`LiteMLA:289`, `MBConv:322`, `EfficientViT:342`; the aliases of the 11/
YAMLs `BACKBONE_VARIANTS:367`). `parse_model` gives such a module 4 feature
slots (`nn/tasks.py:BACKBONES`); `width_list` holds its stage widths.

The JAX modules work on NHWC arrays; here the convolutions take NCHW and
the dense layers, LayerNorms and attention the same NHWC layout as there
(`nhwc`/`nchw` around them), so every reshape reads the JAX channel order.
Where the JAX package departs from the torch reference, the port follows it:
- a flax `nn.Conv` without padding is "SAME" (`SameConv2d`: the 4 x 4 patch
  stems and 2 x 2 downsamples pad at the end of an axis not divisible by
  the stride);
- LayerNorm takes flax's epsilon, 1e-6; GELU is the tanh form, as
  `jax.nn.gelu` computes it by default;
- Swin pads each map to a multiple of its window (7) at the bottom and the
  right after `norm1`, and the padded zeros are tokens of their windows
  (no mask hides them); every odd block shifts by -3, at every resolution,
  with the -100 mask of the padded size; patch merging pads an odd map and
  concatenates [0::2, 0::2], [1::2, 0::2], [0::2, 1::2], [1::2, 1::2];
- the flax names `down_1`, `merge_1`, `patch_0`, `out_norm_0` are children
  `down.1`, `merge.1`, `patch.0`, `out_norm.0` of lists here (the carrier's
  rule, `utils/weights.py`); ConvNeXt's `down`, `down_norm` and Swin's
  `merge`, `merge_norm` hold an `nn.Identity` at 0, where no stage 0
  downsamples.

Swin's relative-position index is a buffer built once; its shift masks are
built once a padded size and device (`SwinBlock.mask`), never a call.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ultralytics_pro_tpu_torch.nn.modules.attention import NORM_EPS, LayerNorm2d, nchw, nhwc
from ultralytics_pro_tpu_torch.nn.modules.conv import Conv


class SameConv2d(nn.Conv2d):
    """A Conv2d without padding arguments that pads as flax's "SAME" does:
    out = ceil(in / stride), the total padding split low = total // 2."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pads = []
        for size, k, s, d in zip(x.shape[:1:-1], self.kernel_size[::-1], self.stride[::-1], self.dilation[::-1]):
            total = max((math.ceil(size / s) - 1) * s + (k - 1) * d + 1 - size, 0)
            pads += [total // 2, total - total // 2]
        return super().forward(F.pad(x, pads) if any(pads) else x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.gelu`'s default, the tanh form."""
    return F.gelu(x, approximate="tanh")


def ln(c: int) -> nn.LayerNorm:
    return nn.LayerNorm(c, eps=NORM_EPS)


def lists(first: nn.Module, rest) -> nn.ModuleList:
    return nn.ModuleList([first, *rest])


# ------------------------------------------------------------- ConvNeXt ----
class ConvNeXtBlock(nn.Module):
    """Depth-wise 7 x 7 -> LayerNorm -> 4x dense -> GELU -> dense -> layer
    scale `gamma` (1e-6 at init) -> residual: the V1 block."""

    def __init__(self, dim: int, ls_init: float = 1e-6):
        super().__init__()
        self.dwconv = nn.Conv2d(dim, dim, 7, 1, 3, groups=dim)
        self.norm = ln(dim)
        self.pwconv1 = nn.Linear(dim, 4 * dim)
        self.pwconv2 = nn.Linear(4 * dim, dim)
        self.gamma = nn.Parameter(torch.full((dim,), ls_init))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.pwconv2(gelu(self.pwconv1(self.norm(nhwc(self.dwconv(x))))))
        return x + nchw(y * self.gamma)


class ConvNeXt(nn.Module):
    """ConvNeXt (tiny: depths 3/3/9/3, dims 96-768): a 4 x 4/4 stem and
    LayerNorm, a LayerNorm and 2 x 2/2 conv before stages 1-3."""

    def __init__(self, c1: int, depths=(3, 3, 9, 3), dims=(96, 192, 384, 768)):
        super().__init__()
        self.width_list = list(dims)
        self.depths = tuple(depths)
        self.stem = SameConv2d(c1, dims[0], 4, 4)
        self.stem_norm = LayerNorm2d(dims[0], eps=NORM_EPS)
        self.down_norm = lists(nn.Identity(), (LayerNorm2d(dims[s - 1], eps=NORM_EPS) for s in range(1, 4)))
        self.down = lists(nn.Identity(), (SameConv2d(dims[s - 1], dims[s], 2, 2) for s in range(1, 4)))
        for s, depth in enumerate(depths):
            for b in range(depth):
                self.add_module(f"s{s}_b{b}", ConvNeXtBlock(dims[s]))

    def forward(self, x: torch.Tensor) -> list:
        x = self.stem_norm(self.stem(x))
        outs = []
        for s, depth in enumerate(self.depths):
            if s > 0:
                x = self.down[s](self.down_norm[s](x))
            for b in range(depth):
                x = getattr(self, f"s{s}_b{b}")(x)
            outs.append(x.contiguous())
        return outs


# ----------------------------------------------------------------- Swin ----
def _window_partition(x: torch.Tensor, w: int) -> torch.Tensor:
    b, h, wd, c = x.shape
    x = x.reshape(b, h // w, w, wd // w, w, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, w * w, c)


def _window_reverse(win: torch.Tensor, w: int, h: int, wd: int) -> torch.Tensor:
    b = win.shape[0] // ((h // w) * (wd // w))
    x = win.reshape(b, h // w, wd // w, w, w, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, wd, -1)


def _rel_pos_index(w: int) -> np.ndarray:
    """Relative position index of a w x w window, (w*w, w*w)."""
    coords = np.stack(np.meshgrid(np.arange(w), np.arange(w), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0) + (w - 1)
    return (rel[..., 0] * (2 * w - 1) + rel[..., 1]).astype(np.int64)


def _shift_mask(h: int, wd: int, w: int, shift: int) -> np.ndarray:
    """(windows, w*w, w*w): -100 between tokens of different sub-regions of
    the shifted h x wd map, else 0."""
    img = np.zeros((1, h, wd, 1), np.float32)
    cnt = 0
    for hs in (slice(0, -w), slice(-w, -shift), slice(-shift, None)):
        for ws in (slice(0, -w), slice(-w, -shift), slice(-shift, None)):
            img[:, hs, ws, :] = cnt
            cnt += 1
    win = img.reshape(1, h // w, w, wd // w, w, 1).transpose(0, 1, 3, 2, 4, 5).reshape(-1, w * w)
    mask = win[:, None, :] - win[:, :, None]
    return np.where(mask != 0, -100.0, 0.0).astype(np.float32)


class SwinBlock(nn.Module):
    """Window attention (shifted when `shift`) with a relative-position bias
    table `rel_bias` ((2w-1)^2, heads), then an MLP; NHWC in and out."""

    def __init__(self, dim: int, heads: int, window: int = 7, shift: int = 0, mlp_ratio: float = 4.0):
        super().__init__()
        self.heads, self.window, self.shift = heads, window, shift
        self.norm1 = ln(dim)
        self.qkv = nn.Linear(dim, 3 * dim)
        self.rel_bias = nn.Parameter(torch.zeros((2 * window - 1) ** 2, heads))
        self.proj = nn.Linear(dim, dim)
        self.norm2 = ln(dim)
        self.fc1 = nn.Linear(dim, int(dim * mlp_ratio))
        self.fc2 = nn.Linear(int(dim * mlp_ratio), dim)
        self.register_buffer("rel_index", torch.from_numpy(_rel_pos_index(window).reshape(-1)), persistent=False)
        self.masks = {}

    def seed_params(self, generator: torch.Generator) -> None:
        """`rel_bias` N(0, 0.02), as flax initialises it."""
        with torch.no_grad():
            self.rel_bias.copy_(0.02 * torch.empty(self.rel_bias.shape).normal_(generator=generator))

    def mask(self, hp: int, wp: int, device) -> torch.Tensor:
        key = (hp, wp, str(device))
        if key not in self.masks:
            self.masks[key] = torch.from_numpy(_shift_mask(hp, wp, self.window, self.shift)).to(device)
        return self.masks[key]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, wd, c = x.shape
        w, nh, shift = self.window, self.heads, self.shift
        ph, pw = (w - h % w) % w, (w - wd % w) % w
        y = F.pad(self.norm1(x), (0, 0, 0, pw, 0, ph))
        hp, wp = h + ph, wd + pw
        if shift:
            y = torch.roll(y, (-shift, -shift), dims=(1, 2))
        qkv = self.qkv(_window_partition(y, w)).reshape(-1, w * w, 3, nh, c // nh)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))  # (B * windows, heads, w*w, hd)
        attn = (q @ k.transpose(-2, -1)) * (c // nh) ** -0.5
        bias = self.rel_bias[self.rel_index].reshape(w * w, w * w, nh).permute(2, 0, 1)
        attn = attn + bias[None]
        if shift:
            mask = self.mask(hp, wp, x.device)
            attn = attn.reshape(-1, mask.shape[0], nh, w * w, w * w) + mask[None, :, None]
            attn = attn.reshape(-1, nh, w * w, w * w)
        o = (attn.softmax(-1) @ v).transpose(1, 2).reshape(-1, w * w, c)
        o = _window_reverse(self.proj(o), w, hp, wp)
        if shift:
            o = torch.roll(o, (shift, shift), dims=(1, 2))
        x = x + o[:, :h, :wd]
        return x + self.fc2(gelu(self.fc1(self.norm2(x))))


class SwinTransformer(nn.Module):
    """Swin-T: a 4 x 4/4 patch stem and LayerNorm, patch merging before
    stages 1-3, depths 2/2/6/2, dims 96-768, heads 3/6/12/24, window 7;
    each stage's output through its own LayerNorm (`out_norm`)."""

    def __init__(self, c1: int, depths=(2, 2, 6, 2), dims=(96, 192, 384, 768), heads=(3, 6, 12, 24),
                 window: int = 7):
        super().__init__()
        self.width_list = list(dims)
        self.depths = tuple(depths)
        self.patch_embed = SameConv2d(c1, dims[0], 4, 4)
        self.patch_norm = ln(dims[0])
        self.merge_norm = lists(nn.Identity(), (ln(4 * dims[s - 1]) for s in range(1, 4)))
        self.merge = lists(nn.Identity(), (nn.Linear(4 * dims[s - 1], dims[s], bias=False) for s in range(1, 4)))
        for s, depth in enumerate(depths):
            for b in range(depth):
                self.add_module(f"s{s}_b{b}", SwinBlock(dims[s], heads[s], window, 0 if b % 2 == 0 else window // 2))
        self.out_norm = nn.ModuleList(ln(d) for d in dims)

    def forward(self, x: torch.Tensor) -> list:
        x = self.patch_norm(nhwc(self.patch_embed(x)))
        outs = []
        for s, depth in enumerate(self.depths):
            if s > 0:
                if x.shape[1] % 2 or x.shape[2] % 2:
                    x = F.pad(x, (0, 0, 0, x.shape[2] % 2, 0, x.shape[1] % 2))
                x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]], -1)
                x = self.merge[s](self.merge_norm[s](x))
            for b in range(depth):
                x = getattr(self, f"s{s}_b{b}")(x)
            outs.append(nchw(self.out_norm[s](x)).contiguous())
        return outs


# ---------------------------------------------------------------- PVTv2 ----
class PVT2Block(nn.Module):
    """Spatial-reduction attention (keys and values from an sr x sr/sr conv
    and LayerNorm of the map) and an MLP with a depth-wise 3 x 3; NHWC."""

    def __init__(self, dim: int, heads: int, sr: int, mlp_ratio: float):
        super().__init__()
        self.heads, self.sr_ratio = heads, sr
        hid = int(dim * mlp_ratio)
        self.norm1 = ln(dim)
        self.q = nn.Linear(dim, dim)
        if sr > 1:
            self.sr = SameConv2d(dim, dim, sr, sr)
            self.sr_norm = ln(dim)
        self.kv = nn.Linear(dim, 2 * dim)
        self.proj = nn.Linear(dim, dim)
        self.norm2 = ln(dim)
        self.fc1 = nn.Linear(dim, hid)
        self.dw = nn.Conv2d(hid, hid, 3, 1, 1, groups=hid)
        self.fc2 = nn.Linear(hid, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        nh = self.heads
        y = self.norm1(x)
        q = self.q(y).reshape(b, h * w, nh, c // nh)
        kv_in = self.sr_norm(nhwc(self.sr(nchw(y)))) if self.sr_ratio > 1 else y
        kv = self.kv(kv_in).reshape(b, -1, 2, nh, c // nh)
        k, v = kv[:, :, 0], kv[:, :, 1]
        attn = (torch.einsum("bqhd,bkhd->bhqk", q, k) * (c // nh) ** -0.5).softmax(-1)
        x = x + self.proj(torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(b, h, w, c))
        m = nhwc(self.dw(nchw(self.fc1(self.norm2(x)))))
        return x + self.fc2(gelu(m))


class PVTv2(nn.Module):
    """PVTv2-b0: overlapping patch embeddings (7 x 7/4, then 3 x 3/2) with a
    LayerNorm, dims 32/64/160/256, depths 2/2/2/2, heads 1/2/5/8, sr
    8/4/2/1, MLP ratios 8/8/4/4; each stage's output through `out_norm`."""

    def __init__(self, c1: int, dims=(32, 64, 160, 256), depths=(2, 2, 2, 2), heads=(1, 2, 5, 8), srs=(8, 4, 2, 1),
                 mlp_ratios=(8.0, 8.0, 4.0, 4.0)):
        super().__init__()
        self.width_list = list(dims)
        self.depths = tuple(depths)
        self.patch = nn.ModuleList(
            nn.Conv2d(c1 if s == 0 else dims[s - 1], dims[s], 7 if s == 0 else 3, 4 if s == 0 else 2,
                      3 if s == 0 else 1) for s in range(4))
        self.patch_norm = nn.ModuleList(ln(d) for d in dims)
        for s, depth in enumerate(depths):
            for b in range(depth):
                self.add_module(f"s{s}_b{b}", PVT2Block(dims[s], heads[s], srs[s], mlp_ratios[s]))
        self.out_norm = nn.ModuleList(ln(d) for d in dims)

    def forward(self, x: torch.Tensor) -> list:
        outs = []
        for s, depth in enumerate(self.depths):
            x = self.patch_norm[s](nhwc(self.patch[s](x)))
            for b in range(depth):
                x = getattr(self, f"s{s}_b{b}")(x)
            x = nchw(self.out_norm[s](x)).contiguous()
            outs.append(x)
        return outs


# ---------------------------------------------------------- EfficientViT ----
class LiteMLA(nn.Module):
    """ReLU linear attention over `qkv` and its 3 x 3 depth-wise aggregate
    (`aggreg`), heads of 16 channels: q (k^T v) / (q k^T 1 + 1e-6), the two
    results concatenated per head, then a 1x1 `proj`."""

    def __init__(self, dim: int, heads_dim: int = 16):
        super().__init__()
        self.heads = max(dim // heads_dim, 1)
        self.qkv = nn.Conv2d(dim, 3 * dim, 1, bias=False)
        self.aggreg = nn.Conv2d(3 * dim, 3 * dim, 3, 1, 1, groups=3 * dim, bias=False)
        self.proj = nn.Conv2d(2 * dim, dim, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        nh = self.heads
        qkv = self.qkv(x)
        outs = []
        for src in (qkv, self.aggreg(qkv)):
            t = nhwc(src).reshape(b, h * w, 3, nh, c // nh)
            q, k, v = F.relu(t[:, :, 0]), F.relu(t[:, :, 1]), t[:, :, 2]
            kv = torch.einsum("bnhd,bnhe->bhde", k, v)
            num = torch.einsum("bnhd,bhde->bnhe", q, kv)
            den = torch.einsum("bnhd,bhd->bnh", q, k.sum(1)) + 1e-6
            outs.append(num / den[..., None])
        return self.proj(nchw(torch.cat(outs, -1).reshape(b, h, w, 2 * c)))


class MBConv(nn.Module):
    """Inverted residual: 1x1 expand, depth-wise 3 x 3 (stride s), both
    hard-swish YOLO Convs, then a 1x1 projection; residual where the shape
    stays."""

    def __init__(self, c1: int, c2: int, s: int = 1, e: float = 4.0):
        super().__init__()
        mid = int(c1 * e)
        self.add = s == 1 and c1 == c2
        self.pw = Conv(c1, mid, 1, act=nn.Hardswish())
        self.dw = Conv(mid, mid, 3, s, g=mid, act=nn.Hardswish())
        self.pw2 = Conv(mid, c2, 1, act=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.pw2(self.dw(self.pw(x)))
        return x + y if self.add else y


class EfficientViT(nn.Module):
    """EfficientViT-b0: a hard-swish 3 x 3/2 stem, then in each stage an
    MBConv at stride 2 and `depths` MBConvs, the last two stages with a
    residual LiteMLA (`s{s}_attn.{b}`) before each; dims 16/32/64/128."""

    def __init__(self, c1: int, dims=(16, 32, 64, 128), depths=(2, 2, 3, 3)):
        super().__init__()
        self.width_list = list(dims)
        self.depths = tuple(depths)
        self.stem = Conv(c1, dims[0] // 2, 3, 2, act=nn.Hardswish())
        for s, depth in enumerate(depths):
            self.add_module(f"s{s}_down", MBConv(dims[0] // 2 if s == 0 else dims[s - 1], dims[s], s=2))
            if s >= 2:
                self.add_module(f"s{s}_attn", nn.ModuleList(LiteMLA(dims[s]) for _ in range(depth)))
            for b in range(depth):
                self.add_module(f"s{s}_b{b}", MBConv(dims[s], dims[s]))

    def forward(self, x: torch.Tensor) -> list:
        x = self.stem(x)
        outs = []
        for s, depth in enumerate(self.depths):
            x = getattr(self, f"s{s}_down")(x)
            for b in range(depth):
                if s >= 2:
                    x = x + getattr(self, f"s{s}_attn")[b](x)
                x = getattr(self, f"s{s}_b{b}")(x)
            outs.append(x)
        return outs
