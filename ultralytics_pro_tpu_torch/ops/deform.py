"""Deformable convolution v1/v2 in plain torch, NCHW.

Counterpart of `ultralytics_pro_tpu/ops/deform.py` (`deform_conv2d:19`), which
is plain XLA there, not a Pallas kernel: each output pixel's K = kh * kw taps
are sampled bilinearly at the base grid plus the learned offsets, the samples
are multiplied by the modulation mask (DCNv2), then contracted with the kernel.
The semantics are the JAX function's:

- offsets are (dy, dx) interleaved per tap: channel 2t is tap t's dy, 2t + 1
  its dx;
- tap t = (i, j) of output pixel (oy, ox) sits at
  (oy * stride - padding + dilation * i, ox * stride - padding + dilation * j);
- the corners are floor(y), floor(y) + 1 (and the same in x); a corner adds
  only where 0 <= ix <= w - 1 and 0 <= iy <= h - 1, zero elsewhere;
- three contractions: groups == 1 (one matmul over taps and channels),
  depth-wise (groups == C, one input channel a group; it needs C out
  channels and raises otherwise), and grouped.

The four corner gathers read a flat (B * H * W, C) view of the map with
`index_select`, one row index a sample, each batch's rows offset by b * H * W,
so the index is (B, Ho, Wo, K) and not expanded to the channels.
torchvision's `deform_conv2d` is not used: the card's machine has no
torchvision.
"""

from __future__ import annotations

from typing import Optional

import torch


def bilinear_taps(x: torch.Tensor, offsets: torch.Tensor, kh: int, kw: int, stride: int = 1, padding: int = 0,
                  dilation: int = 1) -> torch.Tensor:
    """x (B, C, H, W), offsets (B, 2 * kh * kw, Ho, Wo) -> the bilinear samples
    (B, Ho, Wo, K, C) of every output pixel's K taps, zeros outside the map."""
    b, c, h, w = x.shape
    k = kh * kw
    ho, wo = offsets.shape[2:]
    dt, dev = offsets.dtype, offsets.device
    oy = torch.arange(ho, dtype=dt, device=dev) * stride - padding
    ox = torch.arange(wo, dtype=dt, device=dev) * stride - padding
    ty = torch.arange(kh, dtype=dt, device=dev) * dilation
    tx = torch.arange(kw, dtype=dt, device=dev) * dilation
    base_y = (oy[:, None, None, None] + ty[None, None, :, None]).expand(ho, wo, kh, kw).reshape(ho, wo, k)
    base_x = (ox[None, :, None, None] + tx[None, None, None, :]).expand(ho, wo, kh, kw).reshape(ho, wo, k)
    off = offsets.reshape(b, k, 2, ho, wo).permute(0, 3, 4, 1, 2)  # (B, Ho, Wo, K, (dy, dx))
    sy = base_y[None] + off[..., 0]
    sx = base_x[None] + off[..., 1]
    y0, x0 = torch.floor(sy), torch.floor(sx)
    dy, dx = sy - y0, sx - x0
    flat = x.permute(0, 2, 3, 1).reshape(b * h * w, c)
    first_row = (torch.arange(b, device=dev) * (h * w)).view(b, 1, 1, 1)

    def take(ix, iy):
        ok = (ix >= 0) & (ix <= w - 1) & (iy >= 0) & (iy <= h - 1)
        row = iy.clamp(0, h - 1).long() * w + ix.clamp(0, w - 1).long() + first_row
        v = flat.index_select(0, row.reshape(-1)).reshape(b, ho, wo, k, c)
        return v * ok[..., None].to(v.dtype)

    wx0, wx1 = (1 - dx)[..., None], dx[..., None]
    wy0, wy1 = (1 - dy)[..., None], dy[..., None]
    return (take(x0, y0) * wx0 * wy0 + take(x0 + 1, y0) * wx1 * wy0 + take(x0, y0 + 1) * wx0 * wy1
            + take(x0 + 1, y0 + 1) * wx1 * wy1)


def deform_conv2d(x: torch.Tensor, offsets: torch.Tensor, weight: torch.Tensor, mask: Optional[torch.Tensor] = None,
                  bias: Optional[torch.Tensor] = None, stride: int = 1, padding: int = 1, dilation: int = 1,
                  groups: int = 1) -> torch.Tensor:
    """Deformable conv v1 (mask None) or v2.

    x (B, C, H, W); offsets (B, 2 * K, Ho, Wo), (dy, dx) per tap; weight
    (Co, C // groups, kh, kw), torch's layout; mask (B, K, Ho, Wo), already
    through its sigmoid; bias (Co,). Returns (B, Co, Ho, Wo)."""
    b, c = x.shape[:2]
    co, cin_g, kh, kw = weight.shape
    k = kh * kw
    ho, wo = offsets.shape[2:]
    cols = bilinear_taps(x, offsets, kh, kw, stride, padding, dilation)  # (B, Ho, Wo, K, C)
    if mask is not None:
        cols = cols * mask.permute(0, 2, 3, 1)[..., None]
    if groups == 1:
        out = cols.reshape(b, ho, wo, k * c) @ weight.permute(2, 3, 1, 0).reshape(k * c, co)
    elif groups == c and cin_g == 1:
        if co != c:
            raise ValueError(f"depth-wise deform conv requires as many output as input channels, got {co} and {c}")
        out = (cols * weight.reshape(co, k).t()).sum(3)
    else:
        og = co // groups
        cols_g = cols.reshape(b, ho, wo, k, groups, c // groups)
        w_g = weight.permute(2, 3, 1, 0).reshape(k, cin_g, groups, og)
        out = torch.einsum("bhwkgc,kcgo->bhwgo", cols_g, w_g).reshape(b, ho, wo, co)
    if bias is not None:
        out = out + bias
    return out.permute(0, 3, 1, 2)
