"""Elementwise IoU of axis-aligned boxes, with the GIoU, DIoU and CIoU forms,
and the probabilistic IoU of rotated boxes.

Counterpart of `ultralytics_pro_tpu/ops/iou.py` (`bbox_iou:27`,
`_get_covariance_matrix:71`, `probiou:81`, `batch_probiou:110`), the same
formulas term by term. CIoU's `alpha` is taken without gradient (`:63`
`stop_gradient`; here `.detach()`). `probiou` is the non-CIoU form; its CIoU
term belongs to the rotated-box loss, which is not ported yet.
"""

from __future__ import annotations

import math

import torch


def bbox_iou(box1: torch.Tensor, box2: torch.Tensor, xywh: bool = True, GIoU: bool = False,
             DIoU: bool = False, CIoU: bool = False, eps: float = 1e-7) -> torch.Tensor:
    """IoU of broadcasting (..., 4) boxes -> (..., 1)."""
    if xywh:
        x1, y1, w1, h1 = box1.chunk(4, -1)
        x2, y2, w2, h2 = box2.chunk(4, -1)
        w1_, h1_, w2_, h2_ = w1 / 2, h1 / 2, w2 / 2, h2 / 2
        b1_x1, b1_x2, b1_y1, b1_y2 = x1 - w1_, x1 + w1_, y1 - h1_, y1 + h1_
        b2_x1, b2_x2, b2_y1, b2_y2 = x2 - w2_, x2 + w2_, y2 - h2_, y2 + h2_
    else:
        b1_x1, b1_y1, b1_x2, b1_y2 = box1.chunk(4, -1)
        b2_x1, b2_y1, b2_x2, b2_y2 = box2.chunk(4, -1)
        w1, h1 = b1_x2 - b1_x1, b1_y2 - b1_y1 + eps
        w2, h2 = b2_x2 - b2_x1, b2_y2 - b2_y1 + eps

    inter = ((torch.minimum(b1_x2, b2_x2) - torch.maximum(b1_x1, b2_x1)).clamp(min=0)
             * (torch.minimum(b1_y2, b2_y2) - torch.maximum(b1_y1, b2_y1)).clamp(min=0))
    union = w1 * h1 + w2 * h2 - inter + eps
    iou = inter / union

    if CIoU or DIoU or GIoU:
        cw = torch.maximum(b1_x2, b2_x2) - torch.minimum(b1_x1, b2_x1)  # convex width
        ch = torch.maximum(b1_y2, b2_y2) - torch.minimum(b1_y1, b2_y1)  # convex height
        if CIoU or DIoU:
            c2 = cw**2 + ch**2 + eps
            rho2 = ((b2_x1 + b2_x2 - b1_x1 - b1_x2) ** 2 + (b2_y1 + b2_y2 - b1_y1 - b1_y2) ** 2) / 4
            if CIoU:
                v = (4 / math.pi**2) * (torch.atan(w2 / h2) - torch.atan(w1 / h1)) ** 2
                alpha = (v / (v - iou + (1 + eps))).detach()
                return iou - (rho2 / c2 + v * alpha)
            return iou - rho2 / c2
        c_area = cw * ch + eps
        return iou - (c_area - union) / c_area
    return iou


def _get_covariance_matrix(boxes: torch.Tensor):
    """The Gaussian covariance terms (a, b, c) of (..., 5) xywhr boxes, each (...)."""
    a, b, angle = boxes[..., 2] ** 2 / 12, boxes[..., 3] ** 2 / 12, boxes[..., 4]
    cos, sin = torch.cos(angle), torch.sin(angle)
    cos2, sin2 = cos**2, sin**2
    return a * cos2 + b * sin2, a * sin2 + b * cos2, (a - b) * cos * sin


def probiou(obb1: torch.Tensor, obb2: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Probabilistic IoU (1 - Hellinger distance of the boxes' Gaussians) of
    broadcasting (..., 5) xywhr boxes -> (...). The covariance terms are
    taken on each input's own shape before the pairwise terms broadcast."""
    x1, y1 = obb1[..., 0], obb1[..., 1]
    x2, y2 = obb2[..., 0], obb2[..., 1]
    a1, b1, c1 = _get_covariance_matrix(obb1)
    a2, b2, c2 = _get_covariance_matrix(obb2)

    denom = (a1 + a2) * (b1 + b2) - (c1 + c2) ** 2 + eps
    t1 = ((a1 + a2) * (y1 - y2) ** 2 + (b1 + b2) * (x1 - x2) ** 2) / denom * 0.25
    t2 = ((c1 + c2) * (x2 - x1) * (y1 - y2)) / denom * 0.5
    t3 = torch.log(
        ((a1 + a2) * (b1 + b2) - (c1 + c2) ** 2)
        / (4 * torch.sqrt((a1 * b1 - c1**2).clamp(min=0) * (a2 * b2 - c2**2).clamp(min=0)) + eps)
        + eps
    ) * 0.5
    bd = (t1 + t2 + t3).clamp(eps, 100.0)
    hd = torch.sqrt(1.0 - torch.exp(-bd) + eps)
    return 1 - hd


def batch_probiou(obb1: torch.Tensor, obb2: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Pairwise probiou: (N, 5) x (M, 5) -> (N, M)."""
    return probiou(obb1[:, None, :], obb2[None, :, :], eps=eps)
