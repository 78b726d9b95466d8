"""GhostNetV2 as one module that returns 4 maps, NCHW, under the JAX
package's parameter names.

Counterpart of `ultralytics_pro_tpu/nn/modules/backbones5.py`
(`GHOSTNETV2_CFGS:307`, `_mkdiv:323`, `_GhostModuleV2:330`,
`_GhostBottleneckV2:376`, `GhostNetV2Backbone:424`, `_bn5:890`; the 11/
YAML's `ghostnetv2`). As there:
- BatchNorm has torch's defaults: eps 1e-5, momentum 0.1 (flax 0.9);
- from block 2 on, the first ghost module is gated by the DFC branch: a
  2 x 2/2 average pool (floor), 1x1, 1 x 5 and 5 x 1 depth-wise convs, each
  with its BatchNorm, a sigmoid, and a nearest resize to the module's output
  size. `jax.image.resize(..., "nearest")` samples at the half pixel, which
  is torch's "nearest-exact" (its "nearest" differs where the size is not a
  multiple, as a 2 x 2 gate on a 5 x 5 map);
- the SE gate is relu6(s + 3) / 6 over `_mkdiv(mid * ratio)` channels;
- the outputs are the last 4 maps of distinct resolution, the final 1x1
  conv's map taking the place of the last stage's (a dict keyed by the map
  size, as the reference's forward keeps them).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ultralytics_pro_tpu_torch.nn.modules.conv import BatchNorm2d

# k, exp, out, se_ratio, stride of each block, in groups (reference GhostNetv2.py:236)
GHOSTNETV2_CFGS = (
    ((3, 16, 16, 0.0, 1),),
    ((3, 48, 24, 0.0, 2),),
    ((3, 72, 24, 0.0, 1),),
    ((5, 72, 40, 0.25, 2),),
    ((5, 120, 40, 0.25, 1),),
    ((3, 240, 80, 0.0, 2),),
    ((3, 200, 80, 0.0, 1), (3, 184, 80, 0.0, 1), (3, 184, 80, 0.0, 1),
     (3, 480, 112, 0.25, 1), (3, 672, 112, 0.25, 1)),
    ((5, 672, 160, 0.25, 2),),
    ((5, 960, 160, 0.0, 1), (5, 960, 160, 0.25, 1), (5, 960, 160, 0.0, 1),
     (5, 960, 160, 0.25, 1)),
)


def _mkdiv(v, divisor: int = 4) -> int:
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def bn5(c: int) -> BatchNorm2d:
    """torch's BatchNorm2d defaults: eps 1e-5, momentum 0.1."""
    return BatchNorm2d(c, eps=1e-5, momentum=0.1)


class _GhostModuleV2(nn.Module):
    """A 1x1 primary conv and a depth-wise 3 x 3 cheap conv of it, each with
    BatchNorm (and ReLU where `relu`), concatenated and cut to `oup`; with
    `attn`, times the DFC gate."""

    def __init__(self, c1: int, oup: int, relu: bool = True, attn: bool = False):
        super().__init__()
        init_c = math.ceil(oup / 2)
        self.oup, self.relu, self.attn = oup, relu, attn
        self.primary_conv = nn.Conv2d(c1, init_c, 1, bias=False)
        self.primary_bn = bn5(init_c)
        self.cheap_conv = nn.Conv2d(init_c, init_c, 3, 1, 1, groups=init_c, bias=False)
        self.cheap_bn = bn5(init_c)
        if attn:
            self.short_conv0 = nn.Conv2d(c1, oup, 1, bias=False)
            self.short_bn0 = bn5(oup)
            self.short_conv1 = nn.Conv2d(oup, oup, (1, 5), 1, (0, 2), groups=oup, bias=False)
            self.short_bn1 = bn5(oup)
            self.short_conv2 = nn.Conv2d(oup, oup, (5, 1), 1, (2, 0), groups=oup, bias=False)
            self.short_bn2 = bn5(oup)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        act = F.relu if self.relu else (lambda t: t)
        y1 = act(self.primary_bn(self.primary_conv(x)))
        y2 = act(self.cheap_bn(self.cheap_conv(y1)))
        out = torch.cat([y1, y2], 1)[:, :self.oup]
        if not self.attn:
            return out
        r = self.short_bn0(self.short_conv0(F.avg_pool2d(x, 2, 2)))
        r = self.short_bn2(self.short_conv2(self.short_bn1(self.short_conv1(r))))
        return out * F.interpolate(torch.sigmoid(r), size=out.shape[-2:], mode="nearest-exact")


class _GhostBottleneckV2(nn.Module):
    """Ghost module (DFC-gated where `attn`), a depth-wise k x k at the
    stride where it is above 1, an SE gate where `se_ratio`, a second ghost
    module without ReLU; the shortcut a depth-wise k x k and a 1x1 conv with
    BatchNorms unless the shape stays."""

    def __init__(self, c1: int, mid: int, out: int, k: int = 3, stride: int = 1, se_ratio: float = 0.0,
                 attn: bool = False):
        super().__init__()
        p = (k - 1) // 2
        self.stride, self.se_ratio, self.identity = stride, se_ratio, c1 == out and stride == 1
        self.ghost1 = _GhostModuleV2(c1, mid, relu=True, attn=attn)
        if stride > 1:
            self.conv_dw = nn.Conv2d(mid, mid, k, stride, p, groups=mid, bias=False)
            self.bn_dw = bn5(mid)
        if se_ratio > 0:
            red = _mkdiv(mid * se_ratio)
            self.se_reduce = nn.Conv2d(mid, red, 1)
            self.se_expand = nn.Conv2d(red, mid, 1)
        self.ghost2 = _GhostModuleV2(mid, out, relu=False)
        if not self.identity:
            self.short_dw = nn.Conv2d(c1, c1, k, stride, p, groups=c1, bias=False)
            self.short_dw_bn = bn5(c1)
            self.short_pw = nn.Conv2d(c1, out, 1, bias=False)
            self.short_pw_bn = bn5(out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.ghost1(x)
        if self.stride > 1:
            y = self.bn_dw(self.conv_dw(y))
        if self.se_ratio > 0:
            s = self.se_expand(F.relu(self.se_reduce(y.mean((2, 3), keepdim=True))))
            y = y * (F.relu6(s + 3.0) / 6.0)
        y = self.ghost2(y)
        if self.identity:
            return y + x
        return y + self.short_pw_bn(self.short_pw(self.short_dw_bn(self.short_dw(x))))


class GhostNetV2Backbone(nn.Module):
    """GhostNetV2 1.0: a 3 x 3/2 stem (BatchNorm, ReLU), the ghost
    bottlenecks of GHOSTNETV2_CFGS (`b{i}`, DFC-gated from block 2), a final
    1x1 conv to 960 (BatchNorm, ReLU); the last 4 maps of distinct
    resolution: widths 24, 40, 112, 960 on a map of 32 px or more."""

    def __init__(self, c1: int, width: float = 1.0):
        super().__init__()
        c = _mkdiv(16 * width)
        self.stem_conv = nn.Conv2d(c1, c, 3, 2, 1, bias=False)
        self.stem_bn = bn5(c)
        self.n_blocks, stride, widths, ends = 0, 2, {}, []  # widths: the last width at each stride
        for group in GHOSTNETV2_CFGS:
            for k, exp, out, se_ratio, s in group:
                stride *= s
                lid = self.n_blocks
                self.add_module(f"b{lid}", _GhostBottleneckV2(c, _mkdiv(exp * width), _mkdiv(out * width), k, s,
                                                              se_ratio, attn=lid > 1))
                c = _mkdiv(out * width)
                self.n_blocks += 1
            widths[stride] = c
            ends.append(self.n_blocks)
        self.group_ends = tuple(ends)
        self.final_conv = nn.Conv2d(c, _mkdiv(960 * width), 1, bias=False)
        self.final_bn = bn5(_mkdiv(960 * width))
        widths[stride] = _mkdiv(960 * width)
        self.width_list = list(widths.values())[-4:]

    def forward(self, x: torch.Tensor) -> list:
        x = F.relu(self.stem_bn(self.stem_conv(x)))
        uniq = {}
        for lid in range(self.n_blocks):
            x = getattr(self, f"b{lid}")(x)
            if lid + 1 in self.group_ends:
                uniq[tuple(x.shape[-2:])] = x
        x = F.relu(self.final_bn(self.final_conv(x)))
        uniq[tuple(x.shape[-2:])] = x  # the last scale's entry, replaced in place
        return list(uniq.values())[-4:]
