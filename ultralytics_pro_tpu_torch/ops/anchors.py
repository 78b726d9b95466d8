"""Anchor-free geometry: grid anchor centres and distances to boxes.

Counterpart of `ultralytics_pro_tpu/ops/anchors.py` (`make_anchors:13`,
`dist2bbox:34`, `bbox2dist:46`, `dist2rbox:56`).
"""

from __future__ import annotations

import torch


def make_anchors(feat_shapes, strides, grid_cell_offset: float = 0.5,
                 dtype=torch.float32, device=None):
    """Anchor centres for feature maps of the given (h, w) shapes.

    Returns anchor_points (A, 2) in grid units as (x, y), stride_tensor (A, 1).
    """
    anchor_points, stride_tensor = [], []
    for (h, w), stride in zip(feat_shapes, strides):
        sx = torch.arange(w, dtype=dtype, device=device) + grid_cell_offset
        sy = torch.arange(h, dtype=dtype, device=device) + grid_cell_offset
        sy, sx = torch.meshgrid(sy, sx, indexing="ij")
        anchor_points.append(torch.stack([sx, sy], -1).reshape(-1, 2))
        stride_tensor.append(torch.full((h * w, 1), stride, dtype=dtype, device=device))
    return torch.cat(anchor_points), torch.cat(stride_tensor)


def dist2bbox(distance: torch.Tensor, anchor_points: torch.Tensor, xywh: bool = True,
              dim: int = -1) -> torch.Tensor:
    """(l, t, r, b) distances around anchor points -> xywh (or xyxy) boxes."""
    lt, rb = distance.chunk(2, dim)
    x1y1 = anchor_points - lt
    x2y2 = anchor_points + rb
    if xywh:
        return torch.cat([(x1y1 + x2y2) / 2, x2y2 - x1y1], dim)
    return torch.cat([x1y1, x2y2], dim)


def bbox2dist(anchor_points: torch.Tensor, bbox: torch.Tensor, reg_max: float) -> torch.Tensor:
    """xyxy boxes -> (l, t, r, b) distances from the anchor points, clamped
    to [0, reg_max - 0.01] (the JAX package's bound; the loss passes
    reg_max = 16)."""
    x1y1, x2y2 = bbox.chunk(2, -1)
    return torch.cat([anchor_points - x1y1, x2y2 - anchor_points], -1).clamp(0, reg_max - 0.01)


def dist2rbox(pred_dist: torch.Tensor, pred_angle: torch.Tensor, anchor_points: torch.Tensor,
              dim: int = -1) -> torch.Tensor:
    """(l, t, r, b) distances and an angle -> rotated (cx, cy, w, h): the
    offset midpoint (r - l, b - t) / 2 turned by the angle, added to the anchor."""
    lt, rb = pred_dist.chunk(2, dim)
    cos, sin = torch.cos(pred_angle), torch.sin(pred_angle)
    xf, yf = ((rb - lt) / 2).chunk(2, dim)
    x, y = xf * cos - yf * sin, xf * sin + yf * cos
    return torch.cat([torch.cat([x, y], dim) + anchor_points, lt + rb], dim)
