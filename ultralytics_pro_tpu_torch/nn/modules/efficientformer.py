"""EfficientFormerV2 as one module that returns its 4 stage maps, NCHW,
under the JAX package's parameter names.

Counterpart of `ultralytics_pro_tpu/nn/modules/efficientformer.py`
(`EFV2_*:35-57`, `_conv:60`, `_rpe_table:68`, `Attention4D:84`,
`LGQuery:147`, `Attention4DDownsample:165`, `EFV2Mlp:217`,
`EFV2AttnFFN:233`, `EFV2FFN:253`, `EfficientFormerV2:268`; the 11/ YAML's
`efficientformerv2_s0`). As there:
- BatchNorm is `backbones2.bn` (eps 1e-5, the YOLO momentum), every conv
  has a bias and padding k // 2;
- Attention4D: q, k, v by 1x1 convs with BatchNorm, scaled q.k plus a
  learned bias per head and grid offset (`attention_biases`, indexed by the
  first-occurrence table of |dy|, |dx|), talking heads before and after the
  softmax (`talking_head{1,2}_{w,b}`), plus a depth-wise local v; with a
  stride, on the grid of a depth-wise 3 x 3/2 conv, the result resized back
  bilinearly (torch's align_corners=False meets `jax.image.resize` there);
- Attention4DDownsample: queries from `LGQuery` (a depth-wise 3 x 3/2 conv
  plus a 2 x 2 average pool, padded to its grid) over the full grid's keys,
  offsets scaled by h / hq; the stage-2 -> 3 embedding adds it to the
  strided conv.

`attention_biases` holds one column per offset of the grid the module sees,
so its shape depends on the image size, as the JAX model's variables are
made at `init_params(imgsz)`. The modules are unbound until `bind(h, w)`
with their input map's size (`BaseModel` binds them at its `imgsz`, as it
binds MHSA); a map of another size raises, as flax raises a
ScopeParamShapeError there. The offset table is built once a binding
(`rpe_table`, vectorised; the JAX one is a Python loop over the pairs) and
kept as a buffer that the state_dict leaves out.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ultralytics_pro_tpu_torch.nn.modules.backbones2 import bn

EFV2_WIDTH = {"l": (40, 80, 192, 384), "s2": (32, 64, 144, 288), "s1": (32, 48, 120, 224), "s0": (32, 48, 96, 176)}
EFV2_DEPTH = {"l": (5, 5, 15, 10), "s2": (4, 4, 12, 8), "s1": (3, 3, 9, 6), "s0": (2, 2, 6, 4)}
EFV2_ERATIOS = {  # each stage's blocks' MLP ratios (reference :32-61)
    "l": {0: [4] * 5, 1: [4] * 5, 2: [4, 4, 4, 4, 3, 3, 3, 3, 3, 3, 3, 4, 4, 4, 4], 3: [4, 4, 4, 3, 3, 3, 3, 4, 4, 4]},
    "s2": {0: [4] * 4, 1: [4] * 4, 2: [4, 4, 3, 3, 3, 3, 3, 3, 4, 4, 4, 4], 3: [4, 4, 3, 3, 3, 3, 4, 4]},
    "s1": {0: [4] * 3, 1: [4] * 3, 2: [4, 4, 3, 3, 3, 3, 4, 4, 4], 3: [4, 4, 3, 3, 4, 4]},
    "s0": {0: [4] * 2, 1: [4] * 2, 2: [4, 3, 3, 3, 4, 4], 3: [4, 3, 3, 4]},
}
EFV2_VIT_NUM = {"s0": 2, "s1": 2, "s2": 4, "l": 6}
EFV2_ACT = {"s0": F.relu, "s1": F.relu, "s2": F.relu, "l": lambda x: F.gelu(x, approximate="tanh")}


def _conv(c1: int, c2: int, k: int, s: int, groups: int = 1) -> nn.Conv2d:
    return nn.Conv2d(c1, c2, k, s, k // 2, groups=groups)


def rpe_table(hq: int, wq: int, h: int, w: int, scale_y: float = 1.0, scale_x: float = 1.0):
    """(idx (hq*wq, h*w) int64, offsets) of the hq x wq query grid against
    the h x w key grid: offset (floor|qy*scale_y - ky|, floor|qx*scale_x - kx|)
    numbered in the order the pairs first show it, row-major over queries
    then keys, as the JAX `_rpe_table` loop numbers it."""
    qy, qx = np.divmod(np.arange(hq * wq), wq)
    ky, kx = np.divmod(np.arange(h * w), w)
    dy = np.floor(np.abs(qy[:, None] * scale_y - ky[None, :])).astype(np.int64)
    dx = np.floor(np.abs(qx[:, None] * scale_x - kx[None, :])).astype(np.int64)
    _, first, inv = np.unique((dy * (int(dx.max()) + 1) + dx).reshape(-1), return_index=True, return_inverse=True)
    rank = np.empty(len(first), np.int64)
    rank[np.argsort(first)] = np.arange(len(first))
    return rank[inv.reshape(-1)].reshape(hq * wq, h * w), len(first)


class SizeBound(nn.Module):
    """A module whose `attention_biases` (heads, offsets) is sized by its
    grid: `bind(h, w)` with its input map's size makes it (zeros)."""

    size_params = ("attention_biases",)

    def __init__(self, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.attention_biases = None
        self.grid = None
        self.register_buffer("bias_idx", None, persistent=False)

    def grids(self, h: int, w: int):
        """(query grid, key grid) of an h x w input map."""
        raise NotImplementedError

    def bind(self, h: int, w: int) -> None:
        (hq, wq), (hk, wk) = self.grids(h, w)
        idx, n = rpe_table(hq, wq, hk, wk, hk / hq, wk / wq)
        self.grid = (h, w)
        self.bias_idx = torch.from_numpy(idx)
        self.attention_biases = nn.Parameter(torch.zeros(self.num_heads, n))

    def check(self, h: int, w: int) -> None:
        if self.grid != (h, w):
            got = None if self.attention_biases is None else tuple(self.attention_biases.shape)
            raise ValueError(f"{type(self).__name__} parameter 'attention_biases' has shape {got}, made for a "
                             f"{self.grid} input map, not {h} x {w}: the module is bound to the map size of the "
                             "image size it was built for")

    def biased(self, attn: torch.Tensor) -> torch.Tensor:
        return attn + self.attention_biases[:, self.bias_idx]


class Attention4D(SizeBound):
    """Attention over the map's grid (`stride` 2: the grid of a depth-wise
    3 x 3/2 conv, resized back), key_dim 32, 8 heads, attn_ratio 4."""

    def __init__(self, dim: int, key_dim: int = 32, num_heads: int = 8, attn_ratio: int = 4, stride: int = 0):
        super().__init__(num_heads)
        self.key_dim, self.d, self.stride = key_dim, attn_ratio * key_dim, stride
        nh_kd, dh = key_dim * num_heads, attn_ratio * key_dim * num_heads
        if stride:
            self.stride_conv = _conv(dim, dim, 3, stride, groups=dim)
            self.stride_bn = bn(dim)
        self.q, self.q_bn = _conv(dim, nh_kd, 1, 1), bn(nh_kd)
        self.k, self.k_bn = _conv(dim, nh_kd, 1, 1), bn(nh_kd)
        self.v, self.v_bn = _conv(dim, dh, 1, 1), bn(dh)
        self.v_local, self.v_local_bn = _conv(dh, dh, 3, 1, groups=dh), bn(dh)
        for i in (1, 2):
            setattr(self, f"talking_head{i}_w", nn.Parameter(torch.zeros(num_heads, num_heads)))
            setattr(self, f"talking_head{i}_b", nn.Parameter(torch.zeros(num_heads)))
        self.proj, self.proj_bn = _conv(dh, dim, 1, 1), bn(dim)

    def grids(self, h: int, w: int):
        g = (math.ceil(h / self.stride), math.ceil(w / self.stride)) if self.stride else (h, w)
        return g, g

    def seed_params(self, generator: torch.Generator) -> None:
        """The talking heads' `_w` N(0, 0.02), as flax initialises them."""
        with torch.no_grad():
            for p in (self.talking_head1_w, self.talking_head2_w):
                p.copy_(0.02 * torch.empty(p.shape).normal_(generator=generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, _, h0, w0 = x.shape
        self.check(h0, w0)
        if self.stride:
            x = self.stride_bn(self.stride_conv(x))
        _, _, h, w = x.shape
        nh, n = self.num_heads, h * w
        q = self.q_bn(self.q(x)).reshape(b, nh, self.key_dim, n).transpose(-2, -1)
        k = self.k_bn(self.k(x)).reshape(b, nh, self.key_dim, n).transpose(-2, -1)
        v = self.v_bn(self.v(x))
        v_local = self.v_local_bn(self.v_local(v))
        attn = self.biased(torch.einsum("bhnk,bhmk->bhnm", q, k) * self.key_dim ** -0.5)
        attn = torch.einsum("bhnm,gh->bgnm", attn, self.talking_head1_w) + self.talking_head1_b[:, None, None]
        attn = attn.softmax(-1)
        attn = torch.einsum("bhnm,gh->bgnm", attn, self.talking_head2_w) + self.talking_head2_b[:, None, None]
        out = torch.einsum("bhnm,bhmd->bhnd", attn, v.reshape(b, nh, self.d, n).transpose(-2, -1))
        out = self.proj_bn(self.proj(out.transpose(-2, -1).reshape(b, nh * self.d, h, w) + v_local))
        if self.stride:
            out = F.interpolate(out, size=(h0, w0), mode="bilinear", align_corners=False)
        return out


class LGQuery(nn.Module):
    """Local (depth-wise 3 x 3/2) plus global (2 x 2 average pool, padded
    at the end to the local grid) queries, 1x1 `proj` with BatchNorm."""

    def __init__(self, c: int, out_dim: int):
        super().__init__()
        self.local = _conv(c, c, 3, 2, groups=c)
        self.proj, self.proj_bn = _conv(c, out_dim, 1, 1), bn(out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        local_q = self.local(x)
        pool_q = F.avg_pool2d(x, 2, 2)
        ph, pw = local_q.shape[2] - pool_q.shape[2], local_q.shape[3] - pool_q.shape[3]
        if ph or pw:
            pool_q = F.pad(pool_q, (0, pw, 0, ph))
        return self.proj_bn(self.proj(local_q + pool_q))


class Attention4DDownsample(SizeBound):
    """Queries on the half grid (LGQuery) over the full grid's keys and
    values, plus a depth-wise 3 x 3/2 local v, the activation, 1x1 `proj`;
    key_dim 16, 8 heads, attn_ratio 4."""

    def __init__(self, dim: int, out_dim: int, key_dim: int = 16, num_heads: int = 8, attn_ratio: int = 4,
                 act=F.relu):
        super().__init__(num_heads)
        self.key_dim, self.d, self.act = key_dim, attn_ratio * key_dim, act
        nh_kd, dh = key_dim * num_heads, attn_ratio * key_dim * num_heads
        self.q = LGQuery(dim, nh_kd)
        self.k, self.k_bn = _conv(dim, nh_kd, 1, 1), bn(nh_kd)
        self.v, self.v_bn = _conv(dim, dh, 1, 1), bn(dh)
        self.v_local, self.v_local_bn = _conv(dh, dh, 3, 2, groups=dh), bn(dh)
        self.proj, self.proj_bn = _conv(dh, out_dim, 1, 1), bn(out_dim)

    def grids(self, h: int, w: int):
        return (math.ceil(h / 2), math.ceil(w / 2)), (h, w)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, _, h, w = x.shape
        self.check(h, w)
        nh = self.num_heads
        q4 = self.q(x)
        hq, wq = q4.shape[2:]
        q = q4.reshape(b, nh, self.key_dim, hq * wq).transpose(-2, -1)
        k = self.k_bn(self.k(x)).reshape(b, nh, self.key_dim, h * w).transpose(-2, -1)
        v = self.v_bn(self.v(x))
        v_local = self.v_local_bn(self.v_local(v))
        attn = self.biased(torch.einsum("bhnk,bhmk->bhnm", q, k) * self.key_dim ** -0.5).softmax(-1)
        out = torch.einsum("bhnm,bhmd->bhnd", attn, v.reshape(b, nh, self.d, h * w).transpose(-2, -1))
        out = out.transpose(-2, -1).reshape(b, nh * self.d, hq, wq)
        ph, pw = hq - v_local.shape[2], wq - v_local.shape[3]
        if ph or pw:
            v_local = F.pad(v_local, (0, pw, 0, ph))
        return self.proj_bn(self.proj(self.act(out + v_local)))


class EFV2Mlp(nn.Module):
    """1x1 (BN, act), depth-wise 3 x 3 `mid` (BN, act), 1x1 (BN)."""

    def __init__(self, c: int, hidden: int, out: int, act=F.relu):
        super().__init__()
        self.act = act
        self.fc1, self.norm1 = _conv(c, hidden, 1, 1), bn(hidden)
        self.mid, self.mid_norm = _conv(hidden, hidden, 3, 1, groups=hidden), bn(hidden)
        self.fc2, self.norm2 = _conv(hidden, out, 1, 1), bn(out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.act(self.norm1(self.fc1(x)))
        return self.norm2(self.fc2(self.act(self.mid_norm(self.mid(x)))))


class EFV2AttnFFN(nn.Module):
    """x + layer_scale_1 * Attention4D(x), then x + layer_scale_2 * Mlp(x); the scales 1e-5 at init."""

    def __init__(self, dim: int, mlp_ratio: int = 4, stride: int = 0, act=F.relu):
        super().__init__()
        self.layer_scale_1 = nn.Parameter(torch.full((dim,), 1e-5))
        self.layer_scale_2 = nn.Parameter(torch.full((dim,), 1e-5))
        self.token_mixer = Attention4D(dim, stride=stride)
        self.mlp = EFV2Mlp(dim, dim * mlp_ratio, dim, act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.layer_scale_1[:, None, None] * self.token_mixer(x)
        return x + self.layer_scale_2[:, None, None] * self.mlp(x)


class EFV2FFN(nn.Module):
    """x + layer_scale_2 * Mlp(x)."""

    def __init__(self, dim: int, mlp_ratio: int = 4, act=F.relu):
        super().__init__()
        self.layer_scale_2 = nn.Parameter(torch.full((dim,), 1e-5))
        self.mlp = EFV2Mlp(dim, dim * mlp_ratio, dim, act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.layer_scale_2[:, None, None] * self.mlp(x)


class EfficientFormerV2(nn.Module):
    """EfficientFormerV2 (s0: dims 32/48/96/176, depths 2/2/6/4): a stem of
    two 3 x 3/2 convs, FFN blocks, the last `vit_num` blocks of stages 2-3
    with attention (the first of stage 2's strided), a BatchNorm on each
    output (`norm{s}`), 3 x 3/2 conv embeddings between stages (2 -> 3 plus
    Attention4DDownsample)."""

    def __init__(self, c1: int, variant: str = "s0"):
        super().__init__()
        dims, depths, ratios, vit_num = EFV2_WIDTH[variant], EFV2_DEPTH[variant], EFV2_ERATIOS[variant], \
            EFV2_VIT_NUM[variant]
        self.act, self.depths, self.width_list = EFV2_ACT[variant], depths, list(dims)
        self.stem0, self.stem_bn0 = _conv(c1, dims[0] // 2, 3, 2), bn(dims[0] // 2)
        self.stem1, self.stem_bn1 = _conv(dims[0] // 2, dims[0], 3, 2), bn(dims[0])
        for s, depth in enumerate(depths):
            for b in range(depth):
                if s >= 2 and b >= depth - vit_num:
                    stride = 2 if s == 2 and b == depth - vit_num else 0
                    blk = EFV2AttnFFN(dims[s], ratios[s][b], stride, self.act)
                else:
                    blk = EFV2FFN(dims[s], ratios[s][b], self.act)
                self.add_module(f"s{s}_b{b}", blk)
            self.add_module(f"norm{s}", bn(dims[s]))
            if s < 3:
                if s == 2:
                    self.emb2_attn = Attention4DDownsample(dims[s], dims[s + 1], act=self.act)
                self.add_module(f"emb{s}", _conv(dims[s], dims[s + 1], 3, 2))
                self.add_module(f"emb{s}_bn", bn(dims[s + 1]))

    def forward(self, x: torch.Tensor) -> list:
        x = self.stem_bn1(self.stem1(self.act(self.stem_bn0(self.stem0(x)))))
        outs = []
        for s, depth in enumerate(self.depths):
            for b in range(depth):
                x = getattr(self, f"s{s}_b{b}")(x)
            outs.append(getattr(self, f"norm{s}")(x))
            if s < 3:
                c = getattr(self, f"emb{s}_bn")(getattr(self, f"emb{s}")(x))
                x = self.emb2_attn(x) + c if s == 2 else c
        return outs
