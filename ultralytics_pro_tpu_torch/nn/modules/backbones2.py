"""Whole backbones, tranche 2: FasterNet, RepViT, StarNet, LSKNet,
MobileNetV4 and EfficientNetV2, each one module that returns its 4 stage
maps, NCHW, under the JAX package's parameter names.

Counterpart of `ultralytics_pro_tpu/nn/modules/backbones2.py` (`_bn:22`,
`_se:31`, `PConvBlock:130`, `FasterNet:154`, `RepViTBlock:181`,
`RepViT:210`, `StarBlock:233`, `StarNet:253`, `LSKBlock:271`,
`LSKNet:307`, `UIB:328`, `MobileNetV4:354`, `FusedMBConv:374`,
`MBConvV2:388`, `EfficientNetV2:404`; the aliases of the 11/ YAMLs
`BACKBONE_VARIANTS2:477`).

As there:
- the community blocks' own BatchNorm (`bn`) has torch's epsilon, 1e-5,
  and the YOLO momentum (flax 0.97, torch 0.03); the YOLO `Conv`s inside
  RepViT, StarNet, MobileNetV4 and EfficientNetV2 keep eps 1e-3 and SiLU;
- FasterNet uses the exact GELU (every alias of the JAX package), RepViT
  and LSKNet the tanh form;
  FasterNet's partial conv covers the first quarter of the channels and
  each stage output has its own BatchNorm (`out_bn{s}`);
- the squeeze-excitation (`se_fc0`, `se_fc1`: dense layers on the map's
  mean) is `max(c // r, 8)` wide; RepViT gates it with a sigmoid, as
  EfficientNetV2's MBConvV2 does (r = int(4 e) there);
- StarNet's star is relu6(f1(y)) * f2(y); LSKNet's large kernel is a
  depth-wise 7 x 7 at dilation 3 (padding 9) after a depth-wise 5 x 5, its
  gate a 7 x 7 conv of the channel mean and max.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ultralytics_pro_tpu_torch.nn.modules.attention import NORM_EPS, LayerNorm2d
from ultralytics_pro_tpu_torch.nn.modules.backbones import SameConv2d, gelu
from ultralytics_pro_tpu_torch.nn.modules.conv import BN_MOMENTUM, BatchNorm2d, Conv, DWConv


def bn(c: int) -> BatchNorm2d:
    """torch's BatchNorm2d epsilon (1e-5) at the YOLO momentum."""
    return BatchNorm2d(c, eps=1e-5, momentum=BN_MOMENTUM)


def se(x: torch.Tensor, fc0: nn.Linear, fc1: nn.Linear, gate=torch.sigmoid) -> torch.Tensor:
    """Squeeze-excitation by dense layers fc0 (ReLU) and fc1 (gate) on the map's mean."""
    return x * gate(fc1(F.relu(fc0(x.mean((2, 3))))))[:, :, None, None]


def se_layers(c: int, r: int = 4):
    return nn.Linear(c, max(c // r, 8)), nn.Linear(max(c // r, 8), c)


def stages(module: nn.Module, x: torch.Tensor, depths, before=None, after=None) -> list:
    """Run the blocks `s{s}_b{b}` of each stage, `before(s, x)` ahead of
    them and `after(s, x)` on the stage's output; the 4 outputs."""
    outs = []
    for s, depth in enumerate(depths):
        if before is not None:
            x = before(s, x)
        for b in range(depth):
            x = getattr(module, f"s{s}_b{b}")(x)
        outs.append(after(s, x) if after is not None else x)
    return outs


# -------------------------------------------------------------- FasterNet --
class PConvBlock(nn.Module):
    """Partial 3 x 3 conv on the first quarter of the channels, then a 1x1
    expand (BatchNorm, exact GELU) and a 1x1 projection; residual."""

    def __init__(self, dim: int, e: float = 2.0):
        super().__init__()
        self.dp, h = dim // 4, int(dim * e)
        self.pconv = nn.Conv2d(self.dp, self.dp, 3, 1, 1, bias=False)
        self.fc1 = nn.Conv2d(dim, h, 1, bias=False)
        self.bn = bn(h)
        self.fc2 = nn.Conv2d(h, dim, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.bn(self.fc1(torch.cat([self.pconv(x[:, :self.dp]), x[:, self.dp:]], 1)))
        return x + self.fc2(F.gelu(y))


class FasterNet(nn.Module):
    """FasterNet-t0: a 4 x 4/4 stem, 2 x 2/2 merges, depths 1/2/8/2, dims
    40-320, the exact GELU."""

    def __init__(self, c1: int, depths=(1, 2, 8, 2), dims=(40, 80, 160, 320)):
        super().__init__()
        self.width_list, self.depths = list(dims), tuple(depths)
        self.stem = SameConv2d(c1, dims[0], 4, 4, bias=False)
        self.stem_bn = bn(dims[0])
        for s, depth in enumerate(depths):
            if s > 0:
                self.add_module(f"merge{s}", SameConv2d(dims[s - 1], dims[s], 2, 2, bias=False))
                self.add_module(f"merge{s}_bn", bn(dims[s]))
            for b in range(depth):
                self.add_module(f"s{s}_b{b}", PConvBlock(dims[s]))
            self.add_module(f"out_bn{s}", bn(dims[s]))

    def forward(self, x: torch.Tensor) -> list:
        def merge(s, x):
            return getattr(self, f"merge{s}_bn")(getattr(self, f"merge{s}")(x)) if s > 0 else x

        return stages(self, self.stem_bn(self.stem(x)), self.depths, merge,
                      lambda s, x: getattr(self, f"out_bn{s}")(x))


# ---------------------------------------------------------------- RepViT --
class RepViTBlock(nn.Module):
    """Token mixer: x + BN(dw 3 x 3) + BN(dw 1x1), then a sigmoid SE on the
    even blocks; channel mixer: 1x1 expand (BN, GELU), 1x1 project (BN);
    residual."""

    def __init__(self, dim: int, use_se: bool = False, e: float = 2.0):
        super().__init__()
        h = int(dim * e)
        self.use_se = use_se
        self.dw3 = nn.Conv2d(dim, dim, 3, 1, 1, groups=dim, bias=False)
        self.dw3_bn = bn(dim)
        self.dw1 = nn.Conv2d(dim, dim, 1, groups=dim, bias=False)
        self.dw1_bn = bn(dim)
        if use_se:
            self.se_fc0, self.se_fc1 = se_layers(dim)
        self.fc1 = nn.Conv2d(dim, h, 1, bias=False)
        self.fc1_bn = bn(h)
        self.fc2 = nn.Conv2d(h, dim, 1, bias=False)
        self.fc2_bn = bn(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.dw3_bn(self.dw3(x)) + self.dw1_bn(self.dw1(x))
        if self.use_se:
            x = se(x, self.se_fc0, self.se_fc1)
        return x + self.fc2_bn(self.fc2(gelu(self.fc1_bn(self.fc1(x)))))


class RepViT(nn.Module):
    """RepViT-m0.9: two 3 x 3/2 YOLO Conv stems, a depth-wise 3 x 3/2 and a
    1x1 Conv between stages, depths 2/2/6/2, dims 48-384."""

    def __init__(self, c1: int, depths=(2, 2, 6, 2), dims=(48, 96, 192, 384)):
        super().__init__()
        self.width_list, self.depths = list(dims), tuple(depths)
        self.stem1 = Conv(c1, dims[0] // 2, 3, 2)
        self.stem2 = Conv(dims[0] // 2, dims[0], 3, 2)
        for s, depth in enumerate(depths):
            if s > 0:
                self.add_module(f"down{s}_dw", DWConv(dims[s - 1], dims[s - 1], 3, 2))
                self.add_module(f"down{s}_pw", Conv(dims[s - 1], dims[s], 1))
            for b in range(depth):
                self.add_module(f"s{s}_b{b}", RepViTBlock(dims[s], use_se=b % 2 == 0))

    def forward(self, x: torch.Tensor) -> list:
        def down(s, x):
            return getattr(self, f"down{s}_pw")(getattr(self, f"down{s}_dw")(x)) if s > 0 else x

        return stages(self, self.stem2(self.stem1(x)), self.depths, down)


# ---------------------------------------------------------------- StarNet --
class StarBlock(nn.Module):
    """Depth-wise 7 x 7, two 1x1 expands multiplied (relu6(f1) * f2), a 1x1
    projection `g` and a depth-wise 7 x 7; residual."""

    def __init__(self, dim: int, e: float = 3.0):
        super().__init__()
        h = int(dim * e)
        self.dw1 = DWConv(dim, dim, 7, act=False)
        self.f1 = nn.Conv2d(dim, h, 1, bias=False)
        self.f2 = nn.Conv2d(dim, h, 1, bias=False)
        self.g = nn.Conv2d(h, dim, 1, bias=False)
        self.dw2 = DWConv(dim, dim, 7, act=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.dw1(x)
        return x + self.dw2(self.g(F.relu6(self.f1(y)) * self.f2(y)))


class StarNet(nn.Module):
    """StarNet-s1: a 3 x 3/2 YOLO Conv stem and one before each stage,
    depths 1/2/6/2, dims 32-256."""

    def __init__(self, c1: int, depths=(1, 2, 6, 2), dims=(32, 64, 128, 256)):
        super().__init__()
        self.width_list, self.depths = list(dims), tuple(depths)
        self.stem = Conv(c1, dims[0], 3, 2)
        for s, depth in enumerate(depths):
            self.add_module(f"down{s}", Conv(dims[0] if s == 0 else dims[s - 1], dims[s], 3, 2))
            for b in range(depth):
                self.add_module(f"s{s}_b{b}", StarBlock(dims[s]))

    def forward(self, x: torch.Tensor) -> list:
        return stages(self, self.stem(x), self.depths, lambda s, x: getattr(self, f"down{s}")(x))


# ----------------------------------------------------------------- LSKNet --
class LSKBlock(nn.Module):
    """Large selective kernel attention (LayerNorm, 1x1, GELU, the two
    depth-wise branches, their 1x1 halves gated by a 7 x 7 conv of the
    channel mean and max, 1x1 out, times the input, 1x1) and an MLP
    (LayerNorm, 1x1 4x, GELU, 1x1); both residual."""

    def __init__(self, dim: int, e: float = 4.0):
        super().__init__()
        self.norm1 = LayerNorm2d(dim, eps=NORM_EPS)
        self.proj1 = nn.Conv2d(dim, dim, 1)
        self.lsk_dw5 = nn.Conv2d(dim, dim, 5, 1, 2, groups=dim)
        self.lsk_dw7d3 = nn.Conv2d(dim, dim, 7, 1, 9, dilation=3, groups=dim)
        self.lsk_f0 = nn.Conv2d(dim, dim // 2, 1)
        self.lsk_f1 = nn.Conv2d(dim, dim // 2, 1)
        self.lsk_gate = nn.Conv2d(2, 2, 7, 1, 3)
        self.lsk_out = nn.Conv2d(dim // 2, dim, 1)
        self.proj2 = nn.Conv2d(dim, dim, 1)
        self.norm2 = LayerNorm2d(dim, eps=NORM_EPS)
        self.fc1 = nn.Conv2d(dim, int(dim * e), 1)
        self.fc2 = nn.Conv2d(int(dim * e), dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a = gelu(self.proj1(self.norm1(x)))
        u0 = self.lsk_dw5(a)
        v0, v1 = self.lsk_f0(u0), self.lsk_f1(self.lsk_dw7d3(u0))
        cat = torch.cat([v0, v1], 1)
        gate = torch.sigmoid(self.lsk_gate(torch.cat([cat.mean(1, keepdim=True), cat.amax(1, keepdim=True)], 1)))
        mix = self.lsk_out(v0 * gate[:, :1] + v1 * gate[:, 1:])
        x = x + self.proj2(a * mix)
        return x + self.fc2(gelu(self.fc1(self.norm2(x))))


class LSKNet(nn.Module):
    """LSKNet-t: overlapping patch embeddings (7 x 7/4, then 3 x 3/2) with a
    BatchNorm, depths 2/2/4/2, dims 32/64/160/256."""

    def __init__(self, c1: int, depths=(2, 2, 4, 2), dims=(32, 64, 160, 256)):
        super().__init__()
        self.width_list, self.depths = list(dims), tuple(depths)
        for s, depth in enumerate(depths):
            k, st = (7, 4) if s == 0 else (3, 2)
            self.add_module(f"embed{s}", nn.Conv2d(c1 if s == 0 else dims[s - 1], dims[s], k, st, k // 2))
            self.add_module(f"embed{s}_bn", bn(dims[s]))
            for b in range(depth):
                self.add_module(f"s{s}_b{b}", LSKBlock(dims[s]))

    def forward(self, x: torch.Tensor) -> list:
        return stages(self, x, self.depths,
                      lambda s, x: getattr(self, f"embed{s}_bn")(getattr(self, f"embed{s}")(x)))


# ------------------------------------------------------------ MobileNetV4 --
class UIB(nn.Module):
    """Universal inverted bottleneck: an optional depth-wise `front` (no
    activation), a 1x1 `expand`, a depth-wise `mid` at stride s, a 1x1
    `project` (no activation); residual where the shape stays. (The JAX
    UIB's mid-less form, a 2 x 2 average pool, is built by no alias.)"""

    def __init__(self, c1: int, c2: int, e: float = 4.0, front_k: int = 3, mid_k: int = 3, s: int = 1):
        super().__init__()
        h = int(c1 * e)
        self.add = c1 == c2 and s == 1
        self.front = DWConv(c1, c1, front_k, act=False) if front_k else nn.Identity()
        self.expand = Conv(c1, h, 1)
        self.mid = DWConv(h, h, mid_k, s)
        self.project = Conv(h, c2, 1, act=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.project(self.mid(self.expand(self.front(x))))
        return x + y if self.add else y


class MobileNetV4(nn.Module):
    """MobileNetV4-conv-small as the JAX package builds it: a 3 x 3/2 stem,
    then UIBs, the first of each stage at stride 2 with a 5 x 5 mid, a front
    depth-wise on the even blocks; depths 1/2/4/3, dims 32-128."""

    def __init__(self, c1: int, dims=(32, 64, 96, 128), depths=(1, 2, 4, 3)):
        super().__init__()
        self.width_list, self.depths = list(dims), tuple(depths)
        self.stem = Conv(c1, dims[0], 3, 2)
        for s, depth in enumerate(depths):
            for b in range(depth):
                cin = dims[s] if b else dims[max(s - 1, 0)]
                self.add_module(f"s{s}_b{b}", UIB(cin, dims[s], s=2 if b == 0 else 1, front_k=3 if b % 2 == 0 else 0,
                                                  mid_k=5 if b == 0 else 3))

    def forward(self, x: torch.Tensor) -> list:
        return stages(self, self.stem(x), self.depths)


# --------------------------------------------------------- EfficientNetV2 --
class FusedMBConv(nn.Module):
    """A 3 x 3 expand Conv at stride s and a 1x1 projection; residual where the shape stays."""

    def __init__(self, c1: int, c2: int, e: float = 4.0, s: int = 1):
        super().__init__()
        self.add = c1 == c2 and s == 1
        self.fused = Conv(c1, int(c1 * e), 3, s)
        self.project = Conv(int(c1 * e), c2, 1, act=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.project(self.fused(x))
        return x + y if self.add else y


class MBConvV2(nn.Module):
    """1x1 expand, depth-wise 3 x 3 at stride s, a sigmoid SE max(h // int(4 e), 8) wide, 1x1 projection."""

    def __init__(self, c1: int, c2: int, e: float = 4.0, s: int = 1):
        super().__init__()
        h = int(c1 * e)
        self.add = c1 == c2 and s == 1
        self.expand = Conv(c1, h, 1)
        self.dw = DWConv(h, h, 3, s)
        self.se_fc0, self.se_fc1 = se_layers(h, int(4 * e))
        self.project = Conv(h, c2, 1, act=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.project(se(self.dw(self.expand(x)), self.se_fc0, self.se_fc1))
        return x + y if self.add else y


class EfficientNetV2(nn.Module):
    """EfficientNetV2-S as the JAX package builds it: a 3 x 3/2 stem of 24,
    fused MBConvs in stages 0-1 and MBConvV2 in 2-3, the first block of
    each at stride 2; depths 2/2/4/4, dims 48/64/128/256."""

    def __init__(self, c1: int, dims=(48, 64, 128, 256), depths=(2, 2, 4, 4)):
        super().__init__()
        self.width_list, self.depths = list(dims), tuple(depths)
        self.stem = Conv(c1, 24, 3, 2)
        for s, depth in enumerate(depths):
            blk = FusedMBConv if s < 2 else MBConvV2
            for b in range(depth):
                cin = dims[s] if b else (24 if s == 0 else dims[s - 1])
                self.add_module(f"s{s}_b{b}", blk(cin, dims[s], s=2 if b == 0 else 1))

    def forward(self, x: torch.Tensor) -> list:
        return stages(self, self.stem(x), self.depths)
