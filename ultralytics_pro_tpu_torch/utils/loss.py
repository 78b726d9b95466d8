"""The YOLOv8 detection loss: task-aligned assignment, BCE on classes,
CIoU and distribution focal loss on boxes.

Counterpart of `ultralytics_pro_tpu/utils/loss.py` (`bce_logits:27`,
`df_loss:76`, `v8DetectionLoss:94`). Batches carry padded ground truth:
cls (B, G), bboxes (B, G, 4) normalised xywh, mask_gt (B, G). The head's
maps come NCHW, one per level, and flatten anchor-major (level, row, column)
as the JAX package's NHWC maps do. The two-bin select of the DFL is a
`gather` here (a one-hot product there, for the TPU).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from ultralytics_pro_tpu_torch.ops.anchors import bbox2dist, dist2bbox, make_anchors
from ultralytics_pro_tpu_torch.ops.boxes import xywh2xyxy
from ultralytics_pro_tpu_torch.ops.iou import bbox_iou
from ultralytics_pro_tpu_torch.utils.tal import TaskAlignedAssigner


def bce_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Elementwise binary cross-entropy with logits (no reduction), the JAX
    package's form."""
    return logits.clamp(min=0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))


def df_loss(pred_dist: torch.Tensor, target: torch.Tensor, reg_max: int) -> torch.Tensor:
    """Distribution focal loss: cross-entropy to the two integer bins around
    target, linearly weighted. pred_dist (..., 4, reg_max) logits, target
    (..., 4) in [0, reg_max - 1]; returns (..., 1), the mean over the 4 sides."""
    tl = target.floor().long()
    tr = tl + 1
    wl = tr.to(target.dtype) - target
    wr = 1.0 - wl
    logp = F.log_softmax(pred_dist, -1)
    ce_l = -logp.gather(-1, tl[..., None])[..., 0]
    ce_r = -logp.gather(-1, tr.clamp(max=reg_max - 1)[..., None])[..., 0]
    return (ce_l * wl + ce_r * wr).mean(-1, keepdim=True)


class v8DetectionLoss:
    """TAL + BCE + CIoU + DFL. `__call__` returns (total, parts): the parts
    are per-image means times their gains, and total is their sum times the
    batch size, as the JAX criterion returns them."""

    def __init__(self, nc: int, reg_max: int, strides, hyp: Dict | None = None, tal_topk: int = 10):
        hyp = hyp or {}
        self.nc = nc
        self.reg_max = reg_max
        self.strides = tuple(float(s) for s in strides)
        self.use_dfl = reg_max > 1
        self.box_gain = hyp.get("box", 7.5)
        self.cls_gain = hyp.get("cls", 0.5)
        self.dfl_gain = hyp.get("dfl", 1.5)
        self.assigner = TaskAlignedAssigner(topk=tal_topk, num_classes=nc, alpha=0.5, beta=6.0)

    def flatten_preds(self, feats: List[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        """Per-level (B, no, H, W) -> (B, A, 4*reg_max), (B, A, nc)."""
        b, no = feats[0].shape[:2]
        flat = torch.cat([f.reshape(b, no, -1) for f in feats], 2).transpose(1, 2)
        return flat.split((4 * self.reg_max, self.nc), -1)

    def bbox_decode(self, anchor_points: torch.Tensor, pred_dist: torch.Tensor) -> torch.Tensor:
        """(A, 2), (B, A, 4*reg_max) -> (B, A, 4) xyxy in grid units."""
        if self.use_dfl:
            b, a, _ = pred_dist.shape
            bins = torch.arange(self.reg_max, dtype=pred_dist.dtype, device=pred_dist.device)
            pred_dist = pred_dist.reshape(b, a, 4, self.reg_max).softmax(-1) @ bins
        return dist2bbox(pred_dist, anchor_points, xywh=False)

    @staticmethod
    def gt_to_pixels(batch: Dict, imgsz_hw) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Normalised xywh boxes -> pixel xyxy; labels and the slot mask."""
        h, w = imgsz_hw
        scale = torch.tensor([w, h, w, h], dtype=torch.float32, device=batch["bboxes"].device)
        return batch["cls"].long(), xywh2xyxy(batch["bboxes"] * scale), batch["mask_gt"].bool()

    def __call__(self, feats: List[torch.Tensor], batch: Dict, imgsz_hw) -> Tuple[torch.Tensor, Dict]:
        pred_distri, pred_scores = self.flatten_preds(feats)
        anchor_points, stride_tensor = make_anchors([f.shape[2:] for f in feats], self.strides, 0.5,
                                                    device=feats[0].device)
        gt_labels, gt_bboxes, mask_gt = self.gt_to_pixels(batch, imgsz_hw)
        mask_gt = mask_gt & (gt_bboxes.sum(-1) > 0)  # degenerate (all-pad) boxes too

        pred_bboxes = self.bbox_decode(anchor_points, pred_distri)  # grid units
        assign = self.assigner(pred_scores.detach().sigmoid(), (pred_bboxes.detach() * stride_tensor),
                               anchor_points * stride_tensor, gt_labels, gt_bboxes, mask_gt)
        target_scores = assign.target_scores
        target_scores_sum = target_scores.sum().clamp(min=1.0)

        loss_cls = bce_logits(pred_scores, target_scores).sum() / target_scores_sum
        loss_box, loss_dfl = self.bbox_loss(pred_distri, pred_bboxes, anchor_points,
                                            assign.target_bboxes / stride_tensor, target_scores,
                                            target_scores_sum, assign.fg_mask)
        parts = {"box": loss_box * self.box_gain, "cls": loss_cls * self.cls_gain,
                 "dfl": loss_dfl * self.dfl_gain}
        return sum(parts.values()) * pred_scores.shape[0], parts

    def bbox_loss(self, pred_dist, pred_bboxes, anchor_points, target_bboxes, target_scores,
                  target_scores_sum, fg_mask):
        """CIoU and DFL over the foreground anchors, as masked sums."""
        weight = target_scores.sum(-1) * fg_mask  # (B, A)
        iou = bbox_iou(pred_bboxes, target_bboxes, xywh=False, CIoU=True)[..., 0]
        loss_iou = ((1.0 - iou) * weight).sum() / target_scores_sum
        if not self.use_dfl:
            return loss_iou, torch.zeros((), device=pred_dist.device)
        target_ltrb = bbox2dist(anchor_points, target_bboxes, self.reg_max)  # (B, A, 4)
        b, a, _ = target_ltrb.shape
        dfl = df_loss(pred_dist.reshape(b, a, 4, self.reg_max), target_ltrb, self.reg_max)[..., 0]
        return loss_iou, (dfl * weight).sum() / target_scores_sum
