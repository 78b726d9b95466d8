"""Task-aligned assigner: which anchors learn which ground-truth box.

Counterpart of `ultralytics_pro_tpu/utils/tal.py` (`TaskAlignedAssigner:45`,
`RotatedTaskAlignedAssigner:156`), dense over a padded (B, G) ground-truth
axis as there: align metric score^alpha * CIoU^beta, candidates strictly
inside a box, the top-k anchors per box (ties to the lowest index, as
`lax.top_k` and the JAX package's argmax passes give them), an anchor
claimed by several boxes kept by the box it overlaps most, target scores
normalised per box. The rotated form
takes probiou for the overlap and tests anchors against the boxes' corners;
its boxes are (B, G, 5) xywhr and its targets keep the angle.

The JAX module expresses its gathers as one-hot matmuls, which only serve
the TPU; here they are `torch.gather`. All coordinates are in the same units
for predictions and boxes (the loss passes pixels).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ultralytics_pro_tpu_torch.ops.boxes import xywhr2xyxyxyxy
from ultralytics_pro_tpu_torch.ops.iou import bbox_iou, probiou


class AssignResult(NamedTuple):
    target_labels: torch.Tensor  # (B, A) int64
    target_bboxes: torch.Tensor  # (B, A, 4), or (B, A, 5) xywhr from the rotated assigner
    target_scores: torch.Tensor  # (B, A, nc)
    fg_mask: torch.Tensor  # (B, A) bool
    target_gt_idx: torch.Tensor  # (B, A) int64


class TaskAlignedAssigner:
    """Assign ground-truth boxes to anchors by the task-aligned metric."""

    def __init__(self, topk: int = 13, num_classes: int = 80, alpha: float = 1.0,
                 beta: float = 6.0, eps: float = 1e-9):
        self.topk = topk
        self.num_classes = num_classes
        self.alpha = alpha
        self.beta = beta
        self.eps = eps

    def iou_calculation(self, gt_bboxes, pd_bboxes):
        """(B, G, 1, 4) x (B, 1, A, 4) -> (B, G, A) CIoU clamped at 0."""
        return bbox_iou(gt_bboxes, pd_bboxes, xywh=False, CIoU=True)[..., 0].clamp(min=0)

    def select_candidates_in_gts(self, xy_centers, gt_bboxes):
        """(A, 2), (B, G, 4) -> (B, G, A): anchors strictly inside each box."""
        lt, rb = gt_bboxes[..., None, :2], gt_bboxes[..., None, 2:4]  # (B, G, 1, 2)
        deltas = torch.cat([xy_centers[None, None] - lt, rb - xy_centers[None, None]], -1)
        return deltas.amin(-1) > self.eps

    def get_box_metrics(self, pd_scores, pd_bboxes, gt_labels, gt_bboxes, mask):
        """Align metric and overlaps (B, G, A), zeroed outside mask."""
        a = pd_scores.shape[1]
        # the score of each anchor for its box's class: (B, nc, A) gathered at (B, G)
        bbox_scores = pd_scores.transpose(1, 2).gather(1, gt_labels[..., None].expand(-1, -1, a))
        overlaps = self.iou_calculation(gt_bboxes[:, :, None, :], pd_bboxes[:, None, :, :])
        bbox_scores = torch.where(mask, bbox_scores, 0.0)
        overlaps = torch.where(mask, overlaps, 0.0)
        return bbox_scores.pow(self.alpha) * overlaps.pow(self.beta), overlaps

    def select_topk_candidates(self, metrics, mask_gt):
        """(B, G, A) -> 0/1 mask of each box's top-k anchors, zero for padded
        boxes: topk argmax passes, each taking the first of equal maxima and
        ruling its pick out, as the JAX package does (never `torch.topk`,
        whose order among ties is not specified)."""
        m = metrics.clone()
        mask_topk = torch.zeros_like(metrics)
        for _ in range(self.topk):
            idx = m.argmax(-1, keepdim=True)
            mask_topk.scatter_add_(-1, idx, torch.ones_like(idx, dtype=metrics.dtype))
            m.scatter_(-1, idx, -torch.inf)
        return torch.where(mask_gt, mask_topk, 0.0)

    def select_highest_overlaps(self, mask_pos, overlaps):
        """An anchor claimed by several boxes keeps the box of largest IoU."""
        g = mask_pos.shape[1]
        mask_multi = (mask_pos.sum(-2) > 1)[:, None, :]  # (B, 1, A)
        is_max = torch.nn.functional.one_hot(overlaps.argmax(1), g).transpose(1, 2).to(mask_pos.dtype)
        mask_pos = torch.where(mask_multi, is_max, mask_pos)
        return mask_pos.argmax(-2), mask_pos.sum(-2), mask_pos

    def get_targets(self, gt_labels, gt_bboxes, target_gt_idx, fg_mask):
        """Each anchor's box (all of its columns), label and one-hot class
        target (zero off the foreground)."""
        target_bboxes = gt_bboxes.gather(1, target_gt_idx[..., None].expand(-1, -1, gt_bboxes.shape[-1]))
        target_labels = gt_labels.clamp(min=0).gather(1, target_gt_idx)
        target_scores = torch.zeros((*target_labels.shape, self.num_classes), dtype=gt_bboxes.dtype,
                                    device=gt_bboxes.device)
        target_scores.scatter_(-1, target_labels[..., None], 1.0)
        target_scores = torch.where(fg_mask[..., None] > 0, target_scores, 0.0)
        return target_labels, target_bboxes, target_scores

    @torch.no_grad()
    def __call__(self, pd_scores, pd_bboxes, anc_points, gt_labels, gt_bboxes, mask_gt) -> AssignResult:
        """pd_scores (B, A, nc) after the sigmoid; pd_bboxes (B, A, 4) xyxy
        (xywhr (B, A, 5) for the rotated form); anc_points (A, 2); gt_labels
        (B, G) int; gt_bboxes (B, G, 4) xyxy (xywhr (B, G, 5));
        mask_gt (B, G) bool, False for padded slots."""
        gt_labels = gt_labels.long()
        mask_gt_b = mask_gt.bool()[:, :, None]  # (B, G, 1)
        mask_in_gts = self.select_candidates_in_gts(anc_points, gt_bboxes)
        align_metric, overlaps = self.get_box_metrics(pd_scores, pd_bboxes, gt_labels, gt_bboxes,
                                                      mask_in_gts & mask_gt_b)
        mask_topk = self.select_topk_candidates(align_metric, mask_gt_b)
        mask_pos = mask_topk * mask_in_gts.to(align_metric.dtype) * mask_gt_b.to(align_metric.dtype)

        target_gt_idx, fg_mask, mask_pos = self.select_highest_overlaps(mask_pos, overlaps)
        target_labels, target_bboxes, target_scores = self.get_targets(gt_labels, gt_bboxes,
                                                                       target_gt_idx, fg_mask)

        # normalise the target scores by each box's best alignment
        align_metric = align_metric * mask_pos
        pos_align_metrics = align_metric.amax(-1, keepdim=True)  # (B, G, 1)
        pos_overlaps = (overlaps * mask_pos).amax(-1, keepdim=True)
        norm_align_metric = (align_metric * pos_overlaps / (pos_align_metrics + self.eps)).amax(-2)[..., None]
        return AssignResult(target_labels, target_bboxes, target_scores * norm_align_metric,
                            fg_mask.bool(), target_gt_idx)


class RotatedTaskAlignedAssigner(TaskAlignedAssigner):
    """The assigner for rotated boxes: probiou as the overlap, and an anchor
    is a candidate when it lies in the box's rectangle (edges included)."""

    def iou_calculation(self, gt_bboxes, pd_bboxes):
        """(B, G, 1, 5) x (B, 1, A, 5) -> (B, G, A) probiou clamped at 0."""
        return probiou(gt_bboxes, pd_bboxes).clamp(min=0)

    def select_candidates_in_gts(self, xy_centers, gt_bboxes):
        """(A, 2), (B, G, 5) -> (B, G, A): the anchor's offset from corner a,
        projected on the sides ab and ad, lies within their lengths."""
        corners = xywhr2xyxyxyxy(gt_bboxes)  # (B, G, 4, 2)
        a, b, _, d = corners.unbind(-2)
        ab, ad = b - a, d - a  # (B, G, 2)
        ap = xy_centers[None, None] - a[..., None, :]  # (B, G, A, 2)
        norm_ab = (ab * ab).sum(-1)[..., None]
        norm_ad = (ad * ad).sum(-1)[..., None]
        ap_dot_ab = (ap * ab[..., None, :]).sum(-1)
        ap_dot_ad = (ap * ad[..., None, :]).sum(-1)
        return (ap_dot_ab >= 0) & (ap_dot_ab <= norm_ab) & (ap_dot_ad >= 0) & (ap_dot_ad <= norm_ad)
