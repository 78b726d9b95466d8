"""DETR-family losses: Hungarian matching, VFL-weighted BCE, L1 and GIoU over
every decoder layer and the encoder, and the contrastive-denoising queries.

Counterpart of `ultralytics_pro_tpu/utils/detr_loss.py` (`HungarianMatcher:27`,
`DETRLoss:69`, `RTDETRDetectionLoss:133` with `_denoising_loss:159`,
`make_cdn_batch:186`), the same formulas term by term, with two departures
of form:

- The matching. The JAX matcher solves `optax.assignment.hungarian_algorithm`
  on each image's (G, Q) cost inside the jitted loss, with padded ground
  truths at cost BIG. For the real ground truths that assignment is the
  linear-sum assignment over the real columns alone (ties aside), so the port
  builds the same costs on the device, for every decoder layer and the
  encoder at once, copies them to the host in one transfer a step, and solves
  each image with `scipy.optimize.linear_sum_assignment` on its real columns.
  A padded slot takes one of the queries left over (the lowest-numbered
  ones); the loss masks it, so which one does not change the loss. A solver
  on the device is later work (ROADMAP.md queue 2).
- Matched predictions are gathered (`torch.gather`, a scatter-add for the
  class target) where the JAX loss multiplies by one-hot matrices for the
  TPU; both are exact.

Gradients flow where they flow in the JAX loss: the VFL target's IoU is not
detached. Batches carry padded ground truth: cls (B, G), bboxes (B, G, 4)
normalised cxcywh, mask_gt (B, G).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ultralytics_pro_tpu_torch.ops.boxes import xywh2xyxy
from ultralytics_pro_tpu_torch.ops.iou import bbox_iou
from ultralytics_pro_tpu_torch.utils.loss import bce_logits

BIG = 1e6


class HungarianMatcher:
    """Optimal query <-> ground-truth assignment over class, L1 and GIoU costs."""

    def __init__(self, cost_gain=None, alpha: float = 0.25, gamma: float = 2.0):
        self.cost_gain = cost_gain or {"class": 2, "bbox": 5, "giou": 2}
        self.alpha = alpha
        self.gamma = gamma

    @torch.no_grad()
    def cost(self, pred_bboxes, pred_scores, gt_bboxes, gt_cls) -> torch.Tensor:
        """pred_bboxes (..., b, Q, 4) cxcywh in [0, 1]; pred_scores (..., b, Q,
        nc) logits; gt_bboxes (b, G, 4); gt_cls (b, G). Returns the (..., b,
        Q, G) cost on the predictions' device, padded columns included."""
        scores = torch.sigmoid(pred_scores)
        q, g = pred_scores.shape[-2], gt_cls.shape[-1]
        idx = gt_cls.long()[..., None, :].expand(*scores.shape[:-2], q, g)
        sc = torch.gather(scores, -1, idx)  # (..., b, Q, G): each gt's class score
        neg_cost = (1 - self.alpha) * sc**self.gamma * (-torch.log(1 - sc + 1e-8))
        pos_cost = self.alpha * (1 - sc) ** self.gamma * (-torch.log(sc + 1e-8))
        cost_class = pos_cost - neg_cost
        cost_bbox = (pred_bboxes[..., :, None, :] - gt_bboxes[..., None, :, :]).abs().sum(-1)
        giou = bbox_iou(xywh2xyxy(pred_bboxes)[..., :, None, :], xywh2xyxy(gt_bboxes)[..., None, :, :],
                        xywh=False, GIoU=True)[..., 0]
        return (self.cost_gain["class"] * cost_class + self.cost_gain["bbox"] * cost_bbox
                + self.cost_gain["giou"] * (1 - giou))

    @staticmethod
    def solve(cost: torch.Tensor, mask_gt: torch.Tensor) -> torch.Tensor:
        """(..., b, Q, G) costs -> (..., b, G) matched query of each ground
        truth, on the costs' device: one copy to the host, then one
        linear-sum assignment an image over its real columns."""
        from scipy.optimize import linear_sum_assignment

        c = cost.detach().cpu().numpy()
        real = mask_gt.detach().cpu().numpy() > 0  # (b, G)
        q, g = c.shape[-2:]
        if g > q:
            raise ValueError(f"the matcher assigns each of G = {g} ground-truth slots a query; only Q = {q}")
        flat = c.reshape(-1, *c.shape[-3:])  # (layers, b, Q, G)
        rows = np.zeros(flat.shape[:2] + (g,), np.int64)
        for li in range(flat.shape[0]):
            for i in range(flat.shape[1]):
                cols = np.flatnonzero(real[i])
                sub = np.nan_to_num(flat[li, i][:, cols], nan=BIG, posinf=BIG, neginf=-BIG)
                gi, qi = linear_sum_assignment(sub.T)  # rows = ground truths, in order
                rows[li, i, cols[gi]] = qi
                pad = np.flatnonzero(~real[i])
                rows[li, i, pad] = np.setdiff1d(np.arange(q), qi)[: len(pad)]
        return torch.from_numpy(rows.reshape(*c.shape[:-2], g)).to(cost.device)

    def __call__(self, pred_bboxes, pred_scores, gt_bboxes, gt_cls, mask_gt) -> torch.Tensor:
        """pred_bboxes (b, Q, 4), pred_scores (b, Q, nc), gt_bboxes (b, G, 4),
        gt_cls (b, G), mask_gt (b, G) -> (b, G) int64: each gt's matched query."""
        return self.solve(self.cost(pred_bboxes, pred_scores, gt_bboxes, gt_cls), mask_gt)


class DETRLoss:
    """VFL class, L1 and GIoU box losses over every decoder layer and the encoder."""

    def __init__(self, nc: int = 80, loss_gain=None, alpha: float = 0.25, gamma: float = 2.0):
        self.nc = nc
        self.loss_gain = loss_gain or {"class": 1, "bbox": 5, "giou": 2}
        self.matcher = HungarianMatcher(alpha=alpha, gamma=gamma)
        self.alpha = alpha
        self.gamma = gamma

    def _single_layer(self, pred_bboxes, pred_scores, gt_bboxes, gt_cls, mask_gt, match_rows):
        """Losses of one layer given each gt's matched query, match_rows (b, G)."""
        b, q, nc = pred_scores.shape
        rows = match_rows.long()
        pb = torch.gather(pred_bboxes, 1, rows[..., None].expand(-1, -1, 4))  # (b, G, 4)
        iou = bbox_iou(xywh2xyxy(pb), xywh2xyxy(gt_bboxes), xywh=False)[..., 0].clamp(min=0)  # (b, G)

        # VarifocalLoss-style class target: one-hot scaled by IoU at the matched queries
        one_hot = F.one_hot(gt_cls.long(), nc).to(pred_scores.dtype) * (iou * mask_gt)[..., None]
        tgt = torch.zeros_like(pred_scores).scatter_add(1, rows[..., None].expand(-1, -1, nc), one_hot)
        tgt = tgt.clamp(0.0, 1.0)

        pred_sig = torch.sigmoid(pred_scores)
        weight = self.alpha * pred_sig**self.gamma * (1 - (tgt > 0).to(tgt.dtype)) + tgt
        loss_cls = (bce_logits(pred_scores, tgt) * weight).mean(1).sum() * q
        n_gts = mask_gt.sum().clamp(min=1.0)
        loss_cls = loss_cls / n_gts / b

        l1 = ((pb - gt_bboxes).abs().sum(-1) * mask_gt).sum() / n_gts
        giou = bbox_iou(xywh2xyxy(pb), xywh2xyxy(gt_bboxes), xywh=False, GIoU=True)[..., 0]
        loss_giou = ((1 - giou) * mask_gt).sum() / n_gts
        return {"cls": loss_cls * self.loss_gain["class"], "bbox": l1 * self.loss_gain["bbox"],
                "giou": loss_giou * self.loss_gain["giou"]}

    def __call__(self, dec_bboxes, dec_scores, gt_bboxes, gt_cls, mask_gt,
                 enc_bboxes=None, enc_scores=None) -> Dict[str, torch.Tensor]:
        """dec_bboxes (L, b, Q, 4) cxcywh in [0, 1]; dec_scores (L, b, Q, nc)
        logits. Every layer's matching (and the encoder's) is solved in one
        host trip."""
        boxes, scores = dec_bboxes, dec_scores
        if enc_bboxes is not None:
            boxes, scores = torch.cat([boxes, enc_bboxes[None]]), torch.cat([scores, enc_scores[None]])
        rows = self.matcher.solve(self.matcher.cost(boxes, scores, gt_bboxes, gt_cls), mask_gt)
        total = {"cls": 0.0, "bbox": 0.0, "giou": 0.0}
        layers = [(dec_bboxes[li], dec_scores[li]) for li in range(dec_bboxes.shape[0])]
        if enc_bboxes is not None:
            layers.append((enc_bboxes, enc_scores))
        for (pb, ps), r in zip(layers, rows):
            for k, v in self._single_layer(pb, ps, gt_bboxes, gt_cls, mask_gt, r).items():
                total[k] = total[k] + v
        return total


class RTDETRDetectionLoss:
    """RT-DETR's criterion over padded batches, with the (preds, batch,
    imgsz) interface of the trainers' criteria, and the denoising queries'
    loss when the decoder emitted them."""

    def __init__(self, nc: int = 80):
        self.nc = nc
        self.detr = DETRLoss(nc=nc)

    def __call__(self, preds: Dict, batch: Dict, imgsz_hw) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        gt_bboxes = batch["bboxes"]  # (b, G, 4) normalised cxcywh
        gt_cls = batch["cls"]
        mask_gt = batch["mask_gt"].to(torch.float32) * (gt_bboxes[..., 2:4].prod(-1) > 0)

        parts = self.detr(preds["dec_bboxes"], preds["dec_scores"], gt_bboxes, gt_cls, mask_gt,
                          enc_bboxes=preds.get("enc_bboxes"), enc_scores=preds.get("enc_scores"))
        if "dn_bboxes" in preds:
            for k, v in self._denoising_loss(preds, gt_bboxes, gt_cls, mask_gt).items():
                parts[f"dn_{k}"] = v
        return sum(parts.values()) * gt_bboxes.shape[0], parts

    def _denoising_loss(self, preds, gt_bboxes, gt_cls, mask_gt):
        """The denoising queries' loss with their known matching: group g's
        positive slot j is gt j (`make_cdn_batch`'s layout, per group [pos G
        | neg G]); the negative halves get background through the zero
        class targets."""
        b, g = gt_cls.shape
        t_dn = preds["dn_bboxes"].shape[2]
        n_group = t_dn // (2 * g)
        gt_b = gt_bboxes.repeat(1, n_group, 1)
        gt_c = gt_cls.repeat(1, n_group)
        m = mask_gt.repeat(1, n_group)
        rows = (torch.arange(n_group, device=gt_cls.device)[:, None] * 2 * g
                + torch.arange(g, device=gt_cls.device)[None, :]).reshape(-1)
        rows = rows[None].expand(b, -1)
        total = {"cls": 0.0, "bbox": 0.0, "giou": 0.0}
        for li in range(preds["dn_bboxes"].shape[0]):
            parts = self.detr._single_layer(preds["dn_bboxes"][li], preds["dn_scores"][li], gt_b, gt_c, m, rows)
            for k, v in parts.items():
                total[k] = total[k] + v
        return total


def make_cdn_batch(cls_np, bboxes_np, mask_np, nc: int, num_dn: int = 100,
                   cls_noise_ratio: float = 0.5, box_noise_scale: float = 1.0, *,
                   rng: np.random.Generator):
    """Contrastive-denoising queries for a padded host batch (numpy), the JAX
    package's `make_cdn_batch` draw for draw, from the caller's generator.
    Layout (b, n_group, 2G): the positive half then the negative half of each
    group; class nc, the no-object row, marks padding slots.

    Returns {"cls": (b, n_group, 2G) int32, "bbox_logit": (b, n_group, 2G, 4) f32}.
    """
    b, G = cls_np.shape
    n_group = max(1, num_dn // max(G, 1))
    cls = np.tile(cls_np[:, None, :], (1, n_group, 2)).astype(np.int64)  # (b, ng, 2G)
    box = np.tile(bboxes_np[:, None, :, :], (1, n_group, 2, 1)).astype(np.float32)
    mask = np.tile(mask_np[:, None, :].astype(bool), (1, n_group, 2))

    # class noise: flip half*ratio of real slots to a random class
    flip = (rng.random(cls.shape) < cls_noise_ratio * 0.5) & mask
    cls = np.where(flip, rng.integers(0, nc, cls.shape), cls)
    cls = np.where(mask, cls, nc)  # padding slots -> no-object row

    # box noise: pos half inside the box, neg half pushed outside (scale 2)
    known = np.concatenate([box[..., :2] - box[..., 2:] / 2,
                            box[..., :2] + box[..., 2:] / 2], -1)  # xyxy
    diff = np.tile(box[..., 2:] / 2, (1, 1, 1, 2)) * box_noise_scale
    sign = rng.integers(0, 2, known.shape) * 2 - 1
    part = rng.random(known.shape)
    neg = np.zeros_like(part, bool)
    neg[:, :, G:] = True  # second half of each group = negatives
    part = np.where(neg, part + 1.0, part)
    known = np.clip(known + sign * part * diff, 0.0, 1.0)
    cxcy = (known[..., :2] + known[..., 2:]) / 2
    wh = np.maximum(known[..., 2:] - known[..., :2], 1e-4)
    noised = np.concatenate([cxcy, wh], -1)
    logit = np.log(noised / (1 - noised + 1e-6) + 1e-6)
    logit = np.where(mask[..., None], logit, 0.0)
    return {"cls": cls.astype(np.int32), "bbox_logit": logit.astype(np.float32)}
