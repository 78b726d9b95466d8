"""Static-shape batched class-aware NMS on tensors.

Counterpart of `ultralytics_pro_tpu/ops/nms.py` (`non_max_suppression:89`,
`non_max_suppression_fused:187`, `nms_indices:318`), with the same semantics:
candidates are the top-k of the masked scores capped at `max_nms` (invalid
rows carry -1), boxes are shifted by `cls * max_wh` unless agnostic, greedy
suppression keeps `iou > iou_thres` with a `+1e-7` denominator, and the
outputs are fixed (B, max_det) tensors plus a `valid` mask.

The greedy loop is kernel K1 (`kernels/nms_cuda.py:greedy_nms`): the CUDA
kernel for tensors on the card, its plain version for tensors on the CPU.
The candidates that `_topk` selects are already sorted by score, so they go
to K1 as `presorted` rows; `nms_indices` lets K1 sort its row.
"""

from __future__ import annotations

import torch

from ultralytics_pro_tpu_torch.kernels.nms_cuda import greedy_nms
from ultralytics_pro_tpu_torch.ops.boxes import xywh2xyxy


def _topk(masked: torch.Tensor, k: int):
    """Top-k along the last dim with ties in index order, as `lax.top_k` gives them."""
    vals, idx = torch.sort(masked, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _suppress_and_gather(cand_boxes, top_scores, cls_idx, anchor_idx, extra, iou_thres,
                         max_det, max_wh, agnostic):
    """Class-offset greedy NMS over (B, K) candidates sorted by `_topk`, then
    the fixed-shape gather."""
    offset = cls_idx.to(cand_boxes.dtype)[..., None] * (0.0 if agnostic else max_wh)
    keep, valid = greedy_nms((cand_boxes + offset).contiguous(), top_scores.contiguous(),
                             max_det=max_det, iou_thres=iou_thres, presorted=True)
    keep = keep.long()
    out = {
        "boxes": torch.gather(cand_boxes, 1, keep[..., None].expand(-1, -1, 4)),
        "scores": torch.where(valid, torch.gather(top_scores, 1, keep), 0.0),
        "cls": torch.where(valid, torch.gather(cls_idx, 1, keep), 0).to(torch.int32),
        "valid": valid,
    }
    if extra is not None:
        src = torch.gather(anchor_idx, 1, keep)
        out["extra"] = torch.gather(extra, 1, src[..., None].expand(-1, -1, extra.shape[-1]))
    return out


def _classes_mask(classes, device) -> torch.Tensor:
    return torch.as_tensor(classes, dtype=torch.bool, device=device)


def non_max_suppression(boxes: torch.Tensor, scores: torch.Tensor, extra=None,
                        conf_thres: float = 0.25, iou_thres: float = 0.45, max_det: int = 300,
                        max_nms: int = 30000, max_wh: float = 7680.0, agnostic: bool = False,
                        multi_label: bool = False, classes=None):
    """Batched class-aware NMS with fixed output shapes.

    Args:
        boxes: (B, A, 4) xywh pixel boxes.
        scores: (B, A, nc) class scores (post-sigmoid).
        extra: optional (B, A, E) per-anchor payload.
        classes: optional (nc,) bool mask of allowed classes.

    Returns:
        dict with 'boxes' (B, max_det, 4) xyxy, 'scores' (B, max_det), 'cls'
        (B, max_det) int32, 'valid' (B, max_det) bool, and 'extra' if given.
    """
    b, a, nc = scores.shape
    if multi_label and nc > 1:
        if classes is not None:
            scores = torch.where(_classes_mask(classes, scores.device), scores, 0.0)
        flat = scores.reshape(b, -1)  # every (anchor, class) pair is a candidate
        masked = torch.where(flat > conf_thres, flat, -1.0)
        top_scores, top_flat = _topk(masked, min(max_nms, flat.shape[1]))
        anchor_idx = top_flat // nc
        cls_idx = (top_flat % nc).to(torch.int32)
    else:
        conf = scores.amax(-1)
        cls_all = scores.argmax(-1).to(torch.int32)
        if classes is not None:
            # a row keeps its argmax over all classes and is dropped if not allowed
            conf = torch.where(_classes_mask(classes, scores.device)[cls_all.long()], conf, 0.0)
        masked = torch.where(conf > conf_thres, conf, -1.0)
        top_scores, anchor_idx = _topk(masked, min(max_nms, a))
        cls_idx = torch.gather(cls_all, 1, anchor_idx)
    cand_boxes = xywh2xyxy(torch.gather(boxes, 1, anchor_idx[..., None].expand(-1, -1, 4)))
    return _suppress_and_gather(cand_boxes, top_scores, cls_idx, anchor_idx, extra, iou_thres,
                                max_det, max_wh, agnostic)


def non_max_suppression_fused(boxes: torch.Tensor, conf: torch.Tensor, cls: torch.Tensor,
                              extra=None, conf_thres: float = 0.25, iou_thres: float = 0.45,
                              max_det: int = 300, max_nms: int = 30000, max_wh: float = 7680.0,
                              agnostic: bool = False, classes=None):
    """Single-label NMS on per-anchor (conf, cls) from `decode_single_label`.

    boxes (B, A, 4) xywh, conf (B, A) best-class score, cls (B, A) int32 best
    class. Rows whose best class is not in `classes` are dropped. Same outputs
    as `non_max_suppression`.
    """
    if classes is not None:
        conf = torch.where(_classes_mask(classes, conf.device)[cls.long()], conf, 0.0)
    masked = torch.where(conf > conf_thres, conf, -1.0)
    top_scores, anchor_idx = _topk(masked, min(max_nms, conf.shape[1]))
    cand_boxes = xywh2xyxy(torch.gather(boxes, 1, anchor_idx[..., None].expand(-1, -1, 4)))
    cls_idx = torch.gather(cls, 1, anchor_idx)
    return _suppress_and_gather(cand_boxes, top_scores, cls_idx, anchor_idx, extra, iou_thres,
                                max_det, max_wh, agnostic)


def nms_indices(boxes: torch.Tensor, scores: torch.Tensor, iou_thres: float = 0.45,
                max_det: int = 300):
    """Single-class NMS on (K, 4) xyxy boxes and (K,) scores -> (keep (max_det,), valid)."""
    masked = torch.where(scores > 0, scores, -1.0)
    keep, valid = greedy_nms(boxes[None].contiguous(), masked[None].contiguous(),
                             max_det=max_det, iou_thres=iou_thres)
    return keep[0], valid[0]
