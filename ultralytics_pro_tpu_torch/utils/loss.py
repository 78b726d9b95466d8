"""The YOLOv8 training criteria: task-aligned assignment, BCE on classes,
CIoU and distribution focal loss on boxes, and the segment, pose and OBB
terms on top; YOLOv10's dual-assignment criterion over its two branches;
YOLOv5's anchor-based criterion.

Counterpart of `ultralytics_pro_tpu/utils/loss.py` (`bce_logits:27`,
`df_loss:76`, `v8DetectionLoss:94`, `v8SegmentationLoss:190`,
`v8PoseLoss:270` with `OKS_SIGMA:265`, `v8OBBLoss:375`,
`E2EDetectLoss:447`, `v5AnchorLoss:502`). Batches carry padded
ground truth: cls (B, G), bboxes (B, G, 4) normalised xywh (obb: (B, G, 5)
xywhr), mask_gt (B, G), and segment's masks (B, G, H/4, W/4) or pose's
keypoints (B, G, K, 3) normalised. The head's maps come NCHW, one per level,
and flatten anchor-major (level, row, column) as the JAX package's NHWC maps
do; segment's prototypes are NCHW (B, nm, H/4, W/4) where the JAX package's
are channel-last. The two-bin select of the DFL and the selections of a
target's keypoints and mask are gathers here (one-hot products there, for
the TPU). The mask loss is computed for the foreground anchors only, image
by image: the JAX criterion forms every anchor's (H/4 x W/4) logits and
weights the background's by 0, which is the same sum, and at 640 px, batch
16, would take 13.8 GB a tensor.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from ultralytics_pro_tpu_torch.ops.anchors import bbox2dist, dist2bbox, dist2rbox, make_anchors
from ultralytics_pro_tpu_torch.ops.boxes import xywh2xyxy
from ultralytics_pro_tpu_torch.ops.iou import bbox_iou, probiou
from ultralytics_pro_tpu_torch.ops.masks import crop_mask
from ultralytics_pro_tpu_torch.utils.metrics import OKS_SIGMA
from ultralytics_pro_tpu_torch.utils.tal import AssignResult, RotatedTaskAlignedAssigner, TaskAlignedAssigner


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


class DetectTerms(NamedTuple):
    """What the detect part of a criterion leaves for the task's own terms."""
    anchor_points: torch.Tensor  # (A, 2) grid units
    stride_tensor: torch.Tensor  # (A, 1)
    assign: AssignResult  # in pixels
    parts: Dict[str, torch.Tensor]  # box, cls, dfl, before their gains


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

    def dfl_expectation(self, pred_dist: torch.Tensor) -> torch.Tensor:
        """(B, A, 4*reg_max) logits -> (B, A, 4) expected distances."""
        b, a, _ = pred_dist.shape
        bins = torch.arange(self.reg_max, dtype=pred_dist.dtype, device=pred_dist.device)
        return pred_dist.reshape(b, a, 4, self.reg_max).softmax(-1) @ bins

    def bbox_decode(self, anchor_points: torch.Tensor, pred_dist: torch.Tensor) -> torch.Tensor:
        """(A, 2), (B, A, 4*reg_max) -> (B, A, 4) xyxy in grid units."""
        if self.use_dfl:
            pred_dist = self.dfl_expectation(pred_dist)
        return dist2bbox(pred_dist, anchor_points, xywh=False)

    @staticmethod
    def gt_to_pixels(batch: Dict, imgsz_hw) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Normalised xywh boxes -> pixel xyxy; labels and the slot mask."""
        h, w = imgsz_hw
        scale = torch.tensor([w, h, w, h], dtype=torch.float32, device=batch["bboxes"].device)
        return batch["cls"].long(), xywh2xyxy(batch["bboxes"] * scale), batch["mask_gt"].bool()

    def detect_terms(self, feats: List[torch.Tensor], batch: Dict, imgsz_hw) -> DetectTerms:
        """The assignment and the box, cls and dfl terms, shared by the detect,
        segment and pose criteria."""
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
        return DetectTerms(anchor_points, stride_tensor, assign, {"box": loss_box, "cls": loss_cls, "dfl": loss_dfl})

    def total(self, parts: Dict[str, torch.Tensor], batch_size: int) -> Tuple[torch.Tensor, Dict]:
        """The gained parts' sum times the batch size, and the parts."""
        return sum(parts.values()) * batch_size, parts

    def __call__(self, feats: List[torch.Tensor], batch: Dict, imgsz_hw) -> Tuple[torch.Tensor, Dict]:
        t = self.detect_terms(feats, batch, imgsz_hw)
        return self.total({"box": t.parts["box"] * self.box_gain, "cls": t.parts["cls"] * self.cls_gain,
                           "dfl": t.parts["dfl"] * self.dfl_gain}, feats[0].shape[0])

    def bbox_loss(self, pred_dist, pred_bboxes, anchor_points, target_bboxes, target_scores,
                  target_scores_sum, fg_mask):
        """CIoU and DFL over the foreground anchors, as masked sums."""
        weight = target_scores.sum(-1) * fg_mask  # (B, A)
        iou = bbox_iou(pred_bboxes, target_bboxes, xywh=False, CIoU=True)[..., 0]
        loss_iou = ((1.0 - iou) * weight).sum() / target_scores_sum
        if not self.use_dfl:
            return loss_iou, torch.zeros((), device=pred_dist.device)
        return loss_iou, self.dfl_term(pred_dist, anchor_points, target_bboxes, weight, target_scores_sum)

    def dfl_term(self, pred_dist, anchor_points, target_xyxy, weight, target_scores_sum):
        """DFL to the distances of the target boxes (xyxy, grid units) from the anchors."""
        target_ltrb = bbox2dist(anchor_points, target_xyxy, self.reg_max)  # (B, A, 4)
        b, a, _ = target_ltrb.shape
        dfl = df_loss(pred_dist.reshape(b, a, 4, self.reg_max), target_ltrb, self.reg_max)[..., 0]
        return (dfl * weight).sum() / target_scores_sum


class v8SegmentationLoss(v8DetectionLoss):
    """Detect's terms plus a per-anchor mask BCE: each foreground anchor's
    logits (its coefficients times its image's prototypes) against its box's
    GT mask, cropped to that box on the mask grid and divided by the box's
    area there; the sum over the foreground anchors divided by their count,
    and weighted by the box gain (the JAX criterion's choice).

    `overlap_mask` is stored and read by nothing, as in the JAX criterion:
    the collate always gives overlapping pixels to the smaller instance."""

    def __init__(self, *args, overlap_mask: bool = True, **kwargs):
        super().__init__(*args, **kwargs)
        self.overlap = overlap_mask

    def __call__(self, preds: Dict, batch: Dict, imgsz_hw) -> Tuple[torch.Tensor, Dict]:
        t = self.detect_terms(preds["feats"], batch, imgsz_hw)
        loss_seg = self.mask_loss(preds["mc"], preds["protos"], batch["masks"], t.assign, imgsz_hw)
        return self.total({"box": t.parts["box"] * self.box_gain, "seg": loss_seg * self.box_gain,
                           "cls": t.parts["cls"] * self.cls_gain, "dfl": t.parts["dfl"] * self.dfl_gain},
                          preds["mc"].shape[0])

    @staticmethod
    def mask_loss(mc, protos, gt_masks, assign: AssignResult, imgsz_hw) -> torch.Tensor:
        """mc (B, A, nm), protos (B, nm, mh, mw), gt_masks (B, G, mh, mw)."""
        b, nm, mh, mw = protos.shape
        h, w = imgsz_hw
        scale = torch.tensor([mw / w, mh / h, mw / w, mh / h], dtype=torch.float32, device=protos.device)
        tb_mask = assign.target_bboxes * scale  # (B, A, 4) on the mask grid
        area = ((tb_mask[..., 2] - tb_mask[..., 0]) * (tb_mask[..., 3] - tb_mask[..., 1])).clamp(min=1.0)
        fg_mask = assign.fg_mask
        counts = fg_mask.sum(1).tolist()  # one host sync a batch, for the per-image row counts
        anchors = fg_mask.nonzero()[:, 1].split(counts)
        total = (mc.sum() + protos.sum()) * 0.0  # every head parameter gets a gradient, as with jax.grad
        for i, a in enumerate(anchors):
            if not len(a):
                continue
            pred = (mc[i, a] @ protos[i].reshape(nm, -1)).reshape(-1, mh, mw)  # (n, mh, mw) logits
            target = gt_masks[i, assign.target_gt_idx[i, a]]
            loss = crop_mask(bce_logits(pred, target), tb_mask[i, a])
            total = total + (loss.sum((1, 2)) / area[i, a]).sum()
        return total / fg_mask.sum().clamp(min=1)


class v8PoseLoss(v8DetectionLoss):
    """Detect's terms plus the keypoints': an OKS-shaped location loss over
    the visible keypoints of each foreground anchor's box (sigmas from
    OKS_SIGMA for 17x3 keypoints, else 1/K), scaled by K over the visible
    count, and for 3-wide keypoints a BCE of the visibility logit against
    the GT's visibility. Gains `pose` (12.0) and `kobj` (1.0)."""

    def __init__(self, *args, kpt_shape=(17, 3), **kwargs):
        super().__init__(*args, **kwargs)
        hyp = kwargs.get("hyp") or {}
        self.kpt_shape = tuple(kpt_shape)
        self.pose_gain = hyp.get("pose", 12.0)
        self.kobj_gain = hyp.get("kobj", 1.0)
        k = self.kpt_shape[0]
        self.sigmas = torch.from_numpy(OKS_SIGMA) if self.kpt_shape == (17, 3) else torch.ones(k) / k

    @staticmethod
    def kpts_decode(anchor_points: torch.Tensor, pred_kpts: torch.Tensor) -> torch.Tensor:
        """(A, 2), (B, A, K, ndim) -> grid-unit keypoints, the rest as it is."""
        xy = pred_kpts[..., :2] * 2.0 + (anchor_points[None, :, None, :] - 0.5)
        return torch.cat([xy, pred_kpts[..., 2:]], -1)

    def __call__(self, preds: Dict, batch: Dict, imgsz_hw) -> Tuple[torch.Tensor, Dict]:
        t = self.detect_terms(preds["feats"], batch, imgsz_hw)
        b, a = preds["kpt"].shape[:2]
        k, nd = self.kpt_shape
        pred_kpts = self.kpts_decode(t.anchor_points, preds["kpt"].reshape(b, a, k, nd))
        fg_mask = t.assign.fg_mask

        h, w = imgsz_hw
        gt_kpts = batch["keypoints"]  # (B, G, K, ndim) normalised
        gt_kpts = torch.cat([gt_kpts[..., :2] * torch.tensor([w, h], dtype=torch.float32, device=gt_kpts.device),
                             gt_kpts[..., 2:]], -1)
        idx = t.assign.target_gt_idx[:, :, None, None].expand(-1, -1, k, gt_kpts.shape[-1])
        sel = gt_kpts.gather(1, idx)  # (B, A, K, ndim): each anchor's box's keypoints
        sel = torch.cat([sel[..., :2] / t.stride_tensor[None, :, None, :], sel[..., 2:]], -1)

        tb = t.assign.target_bboxes / t.stride_tensor
        area = ((tb[..., 2] - tb[..., 0]) * (tb[..., 3] - tb[..., 1]))[..., None]  # (B, A, 1) grid units
        d = (pred_kpts[..., 0] - sel[..., 0]) ** 2 + (pred_kpts[..., 1] - sel[..., 1]) ** 2
        kpt_mask = (sel[..., 2] != 0) if nd == 3 else torch.ones_like(sel[..., 0], dtype=torch.bool)
        kpt_loss_factor = k / (kpt_mask.sum(-1, keepdim=True) + 1e-9)  # (B, A, 1)
        e = d / ((2 * self.sigmas.to(d.device)) ** 2) / (area + 1e-9) / 2
        per_elem = kpt_loss_factor * (1 - torch.exp(-e)) * kpt_mask
        n_fg = fg_mask.sum().clamp(min=1)
        loss_pose = (per_elem * fg_mask[..., None]).sum() / (n_fg * k)
        if nd == 3:
            kobj = bce_logits(pred_kpts[..., 2], kpt_mask.float())
            loss_kobj = (kobj * fg_mask[..., None]).sum() / (n_fg * k)
        else:
            loss_kobj = torch.zeros((), device=d.device)
        return self.total({"box": t.parts["box"] * self.box_gain, "pose": loss_pose * self.pose_gain,
                           "kobj": loss_kobj * self.kobj_gain, "cls": t.parts["cls"] * self.cls_gain,
                           "dfl": t.parts["dfl"] * self.dfl_gain}, b)


class v8OBBLoss(v8DetectionLoss):
    """Rotated boxes: the rotated assigner (probiou, corner test) in pixels,
    BCE on classes, 1 - probiou (clamped at 0) on the boxes, and DFL to the
    axis-aligned distances of the target's (x, y, w, h). GTs under 2 px wide
    or high drop out before the assignment. Unlike the JAX criterion, an
    image without objects gives finite gradients."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.assigner = RotatedTaskAlignedAssigner(topk=10, num_classes=self.nc, alpha=0.5, beta=6.0)

    def __call__(self, preds: Dict, batch: Dict, imgsz_hw) -> Tuple[torch.Tensor, Dict]:
        feats, pred_angle = preds["feats"], preds["angle"]  # angle (B, A, 1), in radians
        pred_distri, pred_scores = self.flatten_preds(feats)
        anchor_points, stride_tensor = make_anchors([f.shape[2:] for f in feats], self.strides, 0.5,
                                                    device=feats[0].device)
        h, w = imgsz_hw
        scale = torch.tensor([w, h, w, h, 1.0], dtype=torch.float32, device=pred_angle.device)
        gt_rboxes = batch["bboxes"] * scale  # (B, G, 5) xywhr pixels
        mask_gt = batch["mask_gt"].bool() & (gt_rboxes[..., 2] >= 2.0) & (gt_rboxes[..., 3] >= 2.0)

        dist = self.dfl_expectation(pred_distri)
        pred_rboxes = torch.cat([dist2rbox(dist, pred_angle, anchor_points[None]), pred_angle], -1)  # grid units
        pd_pixel = torch.cat([pred_rboxes[..., :4] * stride_tensor, pred_rboxes[..., 4:5]], -1)
        assign = self.assigner(pred_scores.detach().sigmoid(), pd_pixel.detach(), anchor_points * stride_tensor,
                               batch["cls"].long(), gt_rboxes, mask_gt)
        target_scores = assign.target_scores
        target_scores_sum = target_scores.sum().clamp(min=1.0)
        loss_cls = bce_logits(pred_scores, target_scores).sum() / target_scores_sum

        tb = assign.target_bboxes
        tb = torch.cat([tb[..., :4] / stride_tensor, tb[..., 4:5]], -1)
        weight = target_scores.sum(-1) * assign.fg_mask
        # a background anchor's target may be an empty slot's zero box, whose
        # probiou has an infinite derivative (sqrt at 0): 0 weight times that
        # is NaN. It takes its own prediction there instead, which leaves the
        # loss as it is and its gradient 0 (the JAX criterion gives NaN).
        iou = probiou(pred_rboxes, torch.where(assign.fg_mask[..., None], tb, pred_rboxes.detach())).clamp(min=0)
        loss_iou = ((1.0 - iou) * weight).sum() / target_scores_sum
        loss_dfl = self.dfl_term(pred_distri, anchor_points, xywh2xyxy(tb[..., :4]), weight, target_scores_sum)
        return self.total({"box": loss_iou * self.box_gain, "cls": loss_cls * self.cls_gain,
                           "dfl": loss_dfl * self.dfl_gain}, pred_scores.shape[0])


class E2EDetectLoss:
    """YOLOv10's dual assignment: v8DetectionLoss with tal_topk = 10 on the
    one-to-many maps plus tal_topk = 1 on the one-to-one maps; the total is
    their sum, the parts `o2m_*` and `o2o_*`."""

    def __init__(self, nc: int, reg_max: int, strides, hyp: Dict | None = None):
        self.one2many = v8DetectionLoss(nc, reg_max, strides, hyp, tal_topk=10)
        self.one2one = v8DetectionLoss(nc, reg_max, strides, hyp, tal_topk=1)

    def __call__(self, preds: Dict[str, List[torch.Tensor]], batch: Dict, imgsz_hw) -> Tuple[torch.Tensor, Dict]:
        t1, p1 = self.one2many(preds["feats"], batch, imgsz_hw)
        t2, p2 = self.one2one(preds["one2one"], batch, imgsz_hw)
        return t1 + t2, {**{f"o2m_{k}": v for k, v in p1.items()}, **{f"o2o_{k}": v for k, v in p2.items()}}


class v5AnchorLoss:
    """YOLOv5's anchor-based criterion over AnchorDetect's raw maps (B, na *
    (5 + nc), H, W), with static shapes as the JAX criterion has them: every
    (GT, anchor, cell offset) candidate is scored and masked.

    A candidate is a real GT slot (a padded one's CIoU would be NaN, so it is
    scored against a unit box and masked), an anchor whose width and height ratios to the
    GT's are all under `anchor_t`, and one of five cells: the GT's own, and
    the left, right, upper or lower neighbour when the centre lies in that
    half of its cell and the neighbour is inside the map. Its box is
    (2 sig - 0.5 + cell, (2 sig)^2 * anchor) in grid units; the box term is
    the mean of 1 - CIoU over the candidates. The objectness target of each
    (cell, anchor) is the largest detached IoU, clamped at 0, of the
    candidates there (a scatter-max, so the order of writes does not matter),
    and its BCE is averaged over the map with the per-level balance (4.0,
    1.0, 0.4). The class term (one-hot BCE over the candidates) exists only
    when nc > 1. The parts are the box, obj and cls terms times their gains
    (box 0.05, obj 1.0, cls 0.5 by default), the total their sum times the
    batch size."""

    BALANCE = (4.0, 1.0, 0.4)
    # cell offsets, times 0.5: floor(gxy - off) is the GT's cell, then its left,
    # right, upper and lower neighbour (the left one needs +0.5: floor(gx - 0.5)
    # is cell - 1 when the centre lies in the left half)
    OFFSETS = ((0.0, 0.0), (0.5, 0.0), (-0.5, 0.0), (0.0, 0.5), (0.0, -0.5))

    def __init__(self, nc: int, anchors, strides, hyp: Dict | None = None, anchor_t: float = 4.0):
        hyp = hyp or {}
        self.nc = int(nc)
        self.anchors = [torch.tensor(a, dtype=torch.float32) for a in anchors]  # pixels
        self.strides = tuple(float(s) for s in strides)
        self.na = len(self.anchors[0])
        self.box_gain = hyp.get("box", 0.05)
        self.cls_gain = hyp.get("cls", 0.5)
        self.obj_gain = hyp.get("obj", 1.0)
        self.anchor_t = anchor_t

    def __call__(self, preds, batch: Dict, imgsz_hw) -> Tuple[torch.Tensor, Dict]:
        feats = preds["anchor_feats"] if isinstance(preds, dict) else preds
        dev = feats[0].device
        bboxes = batch["bboxes"].float()  # (B, G, 4) normalised xywh
        gt = batch["mask_gt"].float() > 0  # (B, G)
        bsz = gt.shape[0]
        cls = batch["cls"].long().reshape(bsz, -1)
        offsets = torch.tensor(self.OFFSETS, device=dev)
        classes = torch.arange(self.nc, device=dev)
        lbox = lobj = lcls = torch.zeros((), device=dev)
        for li, y in enumerate(feats):
            b, _, h, w = y.shape
            t = y.float().view(b, self.na, 5 + self.nc, h, w).permute(0, 3, 4, 1, 2)  # (B, H, W, na, no)
            anc = self.anchors[li].to(dev) / self.strides[li]  # grid units
            size = torch.tensor([w, h], dtype=torch.float32, device=dev)
            gxy, gwh = bboxes[..., :2] * size, bboxes[..., 2:] * size
            r = gwh[:, :, None, :] / (anc[None, None] + 1e-9)
            ratio_ok = torch.maximum(r, 1.0 / (r + 1e-9)).amax(-1) < self.anchor_t  # (B, G, na)
            gx, gy = gxy[..., 0], gxy[..., 1]
            fx, fy = gx % 1.0, gy % 1.0
            off_ok = torch.stack([torch.ones_like(gt), (fx < 0.5) & (gx > 1.0), (fx >= 0.5) & (gx < w - 1.0),
                                  (fy < 0.5) & (gy > 1.0), (fy >= 0.5) & (gy < h - 1.0)], -1)  # (B, G, 5)
            cell = torch.floor(gxy[:, :, None, :] - offsets)
            cx, cy = cell[..., 0].clamp(0, w - 1).long(), cell[..., 1].clamp(0, h - 1).long()
            m = gt[:, :, None, None] & ratio_ok[..., None] & off_ok[:, :, None, :]  # (B, G, na, 5)

            idx = cy * w + cx  # (B, G, 5)
            flat = t.reshape(b, h * w, self.na, 5 + self.nc)
            pred = flat[torch.arange(b, device=dev)[:, None, None], idx].permute(0, 1, 3, 2, 4)  # (B, G, na, 5, no)
            sig = pred.sigmoid()
            pxy = sig[..., :2] * 2.0 - 0.5 + torch.stack([cx, cy], -1)[:, :, None].float()
            pwh = (sig[..., 2:4] * 2.0) ** 2 * anc[None, None, :, None, :]
            pbox = torch.cat([pxy, pwh], -1)
            tbox = torch.where(gt[..., None], torch.cat([gxy, gwh], -1), 1.0)  # a padded slot's 0 x 0 box: NaN
            iou = bbox_iou(pbox, tbox[:, :, None, None, :].expand_as(pbox), xywh=True, CIoU=True)[..., 0]
            mf = m.float()
            npos = mf.sum() + 1e-6
            lbox = lbox + ((1.0 - iou) * mf).sum() / npos

            slot = ((torch.arange(b, device=dev)[:, None, None, None] * (h * w) + idx[:, :, None, :]) * self.na
                    + torch.arange(self.na, device=dev)[None, None, :, None])  # (B, G, na, 5) into (B, H*W, na)
            tobj = torch.zeros(b * h * w * self.na, device=dev).scatter_reduce(
                0, slot.reshape(-1), (iou.detach().clamp(min=0.0) * mf).reshape(-1), "amax", include_self=True)
            balance = self.BALANCE[li] if li < len(self.BALANCE) else 0.4
            lobj = lobj + balance * bce_logits(t[..., 4].reshape(-1), tobj).mean()

            if self.nc > 1:
                tcls = (cls[:, :, None, None, None] == classes).float().expand(-1, -1, self.na, 5, -1)
                lcls = lcls + (bce_logits(pred[..., 5:], tcls) * mf[..., None]).sum() / (npos * self.nc)

        parts = {"box": self.box_gain * lbox, "obj": self.obj_gain * lobj, "cls": self.cls_gain * lcls}
        return sum(parts.values()) * bsz, parts
