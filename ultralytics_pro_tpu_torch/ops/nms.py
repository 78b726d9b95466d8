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

`non_max_suppression_rotated` (`:264`, the OBB task's NMS) is plain PyTorch
on the model's device, as the JAX function is plain XLA: the `probiou` of
every pair of the K candidates in one batched pass (row j with j as `obb1`,
as the JAX loop computes it), then its `max_det` greedy steps, each a max,
a row gather and a masked fill on the device with no host sync.
"""

from __future__ import annotations

import torch

from ultralytics_pro_tpu_torch.kernels.nms_cuda import greedy_nms
from ultralytics_pro_tpu_torch.ops.boxes import xywh2xyxy
from ultralytics_pro_tpu_torch.ops.iou import probiou

ROTATED_PAIRS = 1 << 26  # probiou pairs a pass: (rows, K, K) f32 temporaries of 256 MB


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


def _suppression_matrix(cand: torch.Tensor, iou_thres: float) -> torch.Tensor:
    """(B, K, 5) xywhr -> (B, K, K) bool, [b, j, k] = probiou(cand[b, j],
    cand[b, k]) > iou_thres, over as many rows a pass as ROTATED_PAIRS allows."""
    b, k, _ = cand.shape
    sup = torch.empty((b, k, k), dtype=torch.bool, device=cand.device)
    step = max(1, ROTATED_PAIRS // (k * k))
    for lo in range(0, b, step):
        c = cand[lo:lo + step]
        torch.gt(probiou(c[:, :, None], c[:, None, :]), iou_thres, out=sup[lo:lo + step])
    return sup


def non_max_suppression_rotated(rboxes: torch.Tensor, scores: torch.Tensor, conf_thres: float = 0.25,
                                iou_thres: float = 0.45, max_det: int = 300, max_nms: int = 4096,
                                max_wh: float = 7680.0, agnostic: bool = False):
    """Batched rotated NMS with fixed output shapes, greedy on `probiou`.

    Candidates are the top-k of the best-class scores (-1 below conf_thres)
    capped at max_nms; their centres are offset by cls * max_wh unless
    agnostic. Each of exactly max_det steps takes the first maximum of the
    scores left, records it (valid if its score is > 0) and sets to -1 every
    candidate whose probiou with it exceeds iou_thres, itself included.
    A slot past the last valid one holds candidate 0 with score 0 and cls 0.

    Args:
        rboxes: (B, A, 5) xywhr boxes in pixels.
        scores: (B, A, nc) class scores (post-sigmoid).

    Returns:
        dict with 'rboxes' (B, max_det, 5), 'scores' (B, max_det), 'cls'
        (B, max_det) int32 and 'valid' (B, max_det) bool.
    """
    with torch.profiler.record_function("nms_rotated"):
        b, a, _ = scores.shape
        conf, cls_all = scores.max(-1)
        masked = torch.where(conf > conf_thres, conf, -1.0)
        top_scores, anchor_idx = _topk(masked, min(max_nms, a))
        cand = torch.gather(rboxes, 1, anchor_idx[..., None].expand(-1, -1, 5))
        cls_idx = torch.gather(cls_all, 1, anchor_idx).to(torch.int32)
        cand_sup = cand
        if not agnostic:
            off = cls_idx.to(cand.dtype)[..., None] * max_wh
            cand_sup = torch.cat([cand[..., :2] + off, cand[..., 2:]], -1)
        sup = _suppression_matrix(cand_sup, iou_thres)

        k = top_scores.shape[1]
        s = top_scores.clone()
        picks, picked = [], []
        for _ in range(max_det):
            v, j = s.max(-1)  # the first maximum, as argmax takes it
            picks.append(v)
            picked.append(j)
            s.masked_fill_(torch.gather(sup, 1, j.view(b, 1, 1).expand(b, 1, k)).view(b, k), -1.0)
        keep = torch.stack(picked, 1)
        valid = torch.stack(picks, 1) > 0
        return {
            "rboxes": torch.gather(cand, 1, keep[..., None].expand(-1, -1, 5)),
            "scores": torch.where(valid, torch.gather(top_scores, 1, keep), 0.0),
            "cls": torch.where(valid, torch.gather(cls_idx, 1, keep), 0),
            "valid": valid,
        }


def nms_indices(boxes: torch.Tensor, scores: torch.Tensor, iou_thres: float = 0.45,
                max_det: int = 300):
    """Single-class NMS on (K, 4) xyxy boxes and (K,) scores -> (keep (max_det,), valid)."""
    masked = torch.where(scores > 0, scores, -1.0)
    keep, valid = greedy_nms(boxes[None].contiguous(), masked[None].contiguous(),
                             max_det=max_det, iou_thres=iou_thres)
    return keep[0], valid[0]
