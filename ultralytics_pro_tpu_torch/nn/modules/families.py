"""BiFormer's bi-level routing attention, NCHW outside, under the JAX
package's parameter names.

Counterpart of `ultralytics_pro_tpu/nn/modules/families.py`
(`BiLevelRoutingAttention:895`). The routing's top-k is a stable descending
sort, so ties go to the lower region index as `lax.top_k` breaks them.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ultralytics_pro_tpu_torch.nn.modules.attention import nchw, nhwc


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
