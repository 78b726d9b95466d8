"""RT-DETR's transformer modules, on (B, tokens, C) tensors, with the torch
reference's module names.

Counterpart of `ultralytics_pro_tpu/nn/modules/transformer.py` (`MLP:24`,
`TransformerEncoderLayer:39`, `sincos_pos_embed_2d:60`, `AIFI:75`,
`MSDeformAttn:175`, `DeformableTransformerDecoderLayer:228`; the JAX
`multi_scale_bilinear_sample:95` is `kernels/msda_cuda.py:msda_sample_fused`
here). The numerics follow the JAX
package where it differs from the torch reference: LayerNorm eps 1e-6
(flax's default), GELU in its tanh form (`jax.nn.gelu`), and attention as
flax's `MultiHeadDotProductAttention` computes it. The deformable sampling
goes through kernel K2 (`kernels/msda_cuda.py:msda_sample_fused`): the CUDA
kernel for tensors on the card, its plain version for tensors on the CPU.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ultralytics_pro_tpu_torch.kernels.msda_cuda import msda_sample_fused

LN_EPS = 1e-6  # flax nn.LayerNorm's default


class MLP(nn.Module):
    """num_layers Linear layers with ReLU between them."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int, num_layers: int):
        super().__init__()
        h = [hidden_dim] * (num_layers - 1)
        self.layers = nn.ModuleList(nn.Linear(n, k) for n, k in zip([input_dim, *h], [*h, output_dim]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x) if i == len(self.layers) - 1 else F.relu(layer(x))
        return x


class MultiheadAttention(nn.Module):
    """Multi-head attention with `nn.MultiheadAttention`'s parameter names
    (`in_proj_weight` (3C, C) packing q, k, v; `in_proj_bias`; `out_proj`),
    computed as flax's `MultiHeadDotProductAttention` does: per-head
    projections with biases, the query divided by sqrt(head dim), softmax
    over the keys, then the output projection. No mask: predict passes none."""

    def __init__(self, c: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * c, c))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * c))
        self.out_proj = nn.Linear(c, c)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        b, nq, c = q.shape
        nh = self.num_heads
        hd = c // nh
        wq, wk, wv = self.in_proj_weight.chunk(3)
        bq, bk, bv = self.in_proj_bias.chunk(3)
        q = F.linear(q, wq, bq).view(b, nq, nh, hd).transpose(1, 2) / math.sqrt(hd)
        k = F.linear(k, wk, bk).view(b, -1, nh, hd).transpose(1, 2)
        v = F.linear(v, wv, bv).view(b, -1, nh, hd).transpose(1, 2)
        a = (q @ k.transpose(-2, -1)).softmax(-1)
        return self.out_proj((a @ v).transpose(1, 2).reshape(b, nq, c))


class TransformerEncoderLayer(nn.Module):
    """Post-norm encoder layer: attention, add & norm, GELU FFN, add & norm."""

    def __init__(self, c1: int, cm: int = 2048, num_heads: int = 8):
        super().__init__()
        self.ma = MultiheadAttention(c1, num_heads)
        self.fc1 = nn.Linear(c1, cm)
        self.fc2 = nn.Linear(cm, c1)
        self.norm1 = nn.LayerNorm(c1, eps=LN_EPS)
        self.norm2 = nn.LayerNorm(c1, eps=LN_EPS)

    def forward(self, x: torch.Tensor, pos=None) -> torch.Tensor:
        q = k = x if pos is None else x + pos
        x = self.norm1(x + self.ma(q, k, x))
        return self.norm2(x + self.fc2(F.gelu(self.fc1(x), approximate="tanh")))


def sincos_pos_embed_2d(w: int, h: int, dim: int, temperature: float = 10000.0, device=None):
    """2-D sine-cosine position embedding, (1, w*h, dim). The grid is meshed
    with indexing="ij" over (w, h), so row t is (x = t // h, y = t % h), as
    in the JAX package and the torch reference."""
    grid_w = torch.arange(w, dtype=torch.float32, device=device)
    grid_h = torch.arange(h, dtype=torch.float32, device=device)
    gw, gh = torch.meshgrid(grid_w, grid_h, indexing="ij")
    pos_dim = dim // 4
    omega = torch.arange(pos_dim, dtype=torch.float32, device=device) / pos_dim
    omega = 1.0 / (temperature ** omega)
    out_w = gw.reshape(-1)[:, None] * omega[None]
    out_h = gh.reshape(-1)[:, None] * omega[None]
    return torch.cat([out_w.sin(), out_w.cos(), out_h.sin(), out_h.cos()], 1)[None]


class AIFI(TransformerEncoderLayer):
    """Intra-scale feature interaction: the encoder layer over the tokens of
    an NCHW map, in row-major (h, w) order, with the 2-D position embedding."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        pos = sincos_pos_embed_2d(w, h, c, device=x.device).to(x.dtype)
        tokens = super().forward(x.flatten(2).transpose(1, 2), pos)
        return tokens.transpose(1, 2).reshape(b, c, h, w)


class MSDeformAttn(nn.Module):
    """Multiscale deformable attention."""

    def __init__(self, d_model: int = 256, n_levels: int = 4, n_heads: int = 8, n_points: int = 4):
        super().__init__()
        self.d_model, self.n_levels, self.n_heads, self.n_points = d_model, n_levels, n_heads, n_points
        self.sampling_offsets = nn.Linear(d_model, n_heads * n_levels * n_points * 2)
        self.attention_weights = nn.Linear(d_model, n_heads * n_levels * n_points)
        self.value_proj = nn.Linear(d_model, d_model)
        self.output_proj = nn.Linear(d_model, d_model)
        self.reset_parameters()

    def reset_parameters(self) -> None:
        """Zero offset and attention kernels, the grid prior as the offsets'
        bias (`transformer.py:193-205` of the JAX package)."""
        nh, nl, npt = self.n_heads, self.n_levels, self.n_points
        thetas = torch.arange(nh, dtype=torch.float32) * (2.0 * math.pi / nh)
        grid = torch.stack([thetas.cos(), thetas.sin()], -1)
        grid = grid / grid.abs().max(-1, keepdim=True).values
        grid = grid[:, None, None, :].repeat(1, nl, npt, 1)
        scale = torch.arange(1, npt + 1, dtype=torch.float32)[None, None, :, None]
        with torch.no_grad():
            self.sampling_offsets.weight.zero_()
            self.sampling_offsets.bias.copy_((grid * scale).reshape(-1))
            self.attention_weights.weight.zero_()
            self.attention_weights.bias.zero_()

    def forward(self, query: torch.Tensor, refer_bbox: torch.Tensor, value: torch.Tensor,
                shapes) -> torch.Tensor:
        """query (B, Q, C); refer_bbox (B, Q, 4) cxcywh in [0, 1]; value the
        level-concatenated (B, V, C) tokens; shapes [(H_l, W_l)]."""
        b, q, c = query.shape
        nh, nl, npt = self.n_heads, self.n_levels, self.n_points
        offsets = self.sampling_offsets(query).view(b, q, nh, nl, npt, 2)
        attn = self.attention_weights(query).view(b, q, nh, nl * npt).softmax(-1).view(b, q, nh, nl, npt)
        v = self.value_proj(value).view(b, -1, nh, c // nh)
        cxcy = refer_bbox[:, :, None, None, None, :2]
        wh = refer_bbox[:, :, None, None, None, 2:4]
        locs = cxcy + offsets / npt * wh * 0.5
        return self.output_proj(msda_sample_fused(v, shapes, locs, attn))


class DeformableTransformerDecoderLayer(nn.Module):
    """Self-attention, deformable cross-attention and a ReLU FFN, each
    followed by add & norm. The query position is added to the
    self-attention's q and k and to the cross-attention's query, not to v."""

    def __init__(self, d_model: int = 256, n_heads: int = 8, d_ffn: int = 1024, n_levels: int = 4,
                 n_points: int = 4):
        super().__init__()
        self.self_attn = MultiheadAttention(d_model, n_heads)
        self.norm1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.cross_attn = MSDeformAttn(d_model, n_levels, n_heads, n_points)
        self.norm2 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.linear1 = nn.Linear(d_model, d_ffn)
        self.linear2 = nn.Linear(d_ffn, d_model)
        self.norm3 = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, embed, refer_bbox, value, shapes, query_pos=None):
        q = k = embed if query_pos is None else embed + query_pos
        embed = self.norm1(embed + self.self_attn(q, k, embed))
        ca = self.cross_attn(embed if query_pos is None else embed + query_pos, refer_bbox, value, shapes)
        embed = self.norm2(embed + ca)
        return self.norm3(embed + self.linear2(F.relu(self.linear1(embed))))
