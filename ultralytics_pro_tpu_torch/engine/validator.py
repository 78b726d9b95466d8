"""Validator: dataloader -> device function (forward + NMS) -> TP matching -> metrics.

Counterpart of `ultralytics_pro_tpu/engine/validator.py` (`DetectionValidator:25`,
`SegmentationValidator:216`, `PoseValidator:308`, `OBBValidator:388`,
`ClassificationValidator:497`). The jitted device function
of the JAX package (`_build_jit:105`) is a plain device function here,
`run(img_u8)`: uint8 BGR batch -> RGB/255 -> forward -> generic decode ->
multi-label NMS (kernel K1 on the card), in full f32 with TF32 off
(`utils.full_f32`). Segment and pose pass the head's extra columns through
NMS as each candidate's payload (mask coefficients, decoded keypoints).
The DDetect and AnchorDetect heads decode to Detect's rows and DSegment to
Segment's, so their models take the same device function. Matching and AP
run on the host in numpy (`utils/metrics.py`): boxes in the original image
frame for detect and segment, masks in the letterbox frame
(the predicted masks made on the model's device by `process_mask`, only
their > 0.5 bits brought back), and pose's boxes and OKS in the letterbox
frame, as the JAX validators match them. OBB's device function ends in the
rotated NMS (`ops.nms.non_max_suppression_rotated`) and its rboxes are
matched by `batch_probiou` in the letterbox frame; with `save_json` it
writes DOTA Task1 files (`save_dota:431`). Classify's device function is
RGB/255 and the forward; its (B, nc) probabilities come to the host, where
a stable descending sort gives each image's top 5. Every validator skips
the `pad_count` copies that fill a short last batch (the JAX
ClassificationValidator scores them again). The three `Profile`s synchronise
the model's device: preprocess is the batch's copy to the device, inference
the device function and the copy back, postprocess the matching.

A v10Detect head is end-to-end (`:115-128`): its (B, 300, 6) rows go to the
matching without NMS, boxes `xywh2xyxy`, valid where conf > `conf`
(`predictor.end2end_outputs`).

With `save_json` the detect validator (the JAX `pred_to_json:50`,
`save_predictions_json:68`) keeps each image's valid detections in the
original frame as COCO records (top-left xywh rounded to 3 decimals, the
score to 5, the class index as `category_id`, a numeric file stem as an int
`image_id`) and writes them to `predictions.json` in `save_dir` (default
`project`/`name`, `runs/val`); the RT-DETR validator writes the file too,
empty, as the JAX one does (its matching keeps no records). The segment,
pose and classify validators write none, as the JAX ones do; OBB writes its
DOTA files. `coco_evaluate(anno_json, pred_json)` scores such a file against
a COCO-format ground truth with the numpy `utils.cocoeval.COCOEvalNp`, the
JAX package's branch when pycocotools is missing (it is on neither machine).
`plots` raises NotImplementedError.
"""

from __future__ import annotations

import json
from collections import defaultdict
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from ultralytics_pro_tpu_torch.engine.predictor import end2end_outputs, rgb01
from ultralytics_pro_tpu_torch.nn.modules.head import OBB, AnchorDetect, Classify, Detect, Pose, Segment
from ultralytics_pro_tpu_torch.ops.boxes import scale_boxes, xywhr2xyxyxyxy
from ultralytics_pro_tpu_torch.ops.iou import batch_probiou
from ultralytics_pro_tpu_torch.ops.masks import process_mask
from ultralytics_pro_tpu_torch.ops.nms import non_max_suppression, non_max_suppression_rotated
from ultralytics_pro_tpu_torch.utils import LOGGER, Profile, full_f32
from ultralytics_pro_tpu_torch.utils.metrics import (
    OKS_SIGMA,
    ClassifyMetrics,
    ConfusionMatrix,
    DetMetrics,
    OBBMetrics,
    PoseMetrics,
    SegmentMetrics,
    box_iou_np,
    kpt_iou,
    mask_iou_np,
    match_predictions,
)


def xywhn_to_xyxy_px(xywhn: np.ndarray, h: int, w: int) -> np.ndarray:
    """Normalised xywh boxes (n, 4) -> pixel xyxy in an (h, w) frame (the letterbox's)."""
    if not len(xywhn):
        return np.zeros((0, 4))
    cx, cy, bw, bh = xywhn[:, 0] * w, xywhn[:, 1] * h, xywhn[:, 2] * w, xywhn[:, 3] * h
    return np.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2], 1)


class DetectionValidator:
    """Evaluate a detection model over a dataloader."""

    head_types = (Detect, AnchorDetect)  # the heads (or their subclasses) whose outputs run reads
    metrics_class = DetMetrics
    writes_json = True  # with save_json, predictions.json (pred_to_json's records) in save_dir

    def __init__(self, args: Dict | None = None):
        self.args = dict(args or {})
        self.conf = float(self.args.get("conf") or 0.001)
        self.iou = float(self.args.get("iou", 0.7))
        self.max_det = int(self.args.get("max_det", 300))
        self.single_cls = bool(self.args.get("single_cls", False))
        self.save_json = bool(self.args.get("save_json", False))
        if self.args.get("plots"):
            raise NotImplementedError("val with plots=True is not implemented in ultralytics_pro_tpu_torch yet; "
                                      "pass plots=False")
        self.jdict = []
        self.model = None

    @staticmethod
    def _to_original_frame(boxes: np.ndarray, imgsz, ori_shape, ratio_pad):
        """Rescale letterbox-frame xyxy boxes to the original image frame and
        clip: predictions and ground truth are matched there."""
        if ori_shape is None or not len(boxes):
            return boxes
        return scale_boxes(imgsz, torch.from_numpy(boxes), ori_shape, ratio_pad=ratio_pad).numpy()

    def pred_to_json(self, boxes_xyxy: np.ndarray, conf: np.ndarray, cls: np.ndarray, im_file) -> None:
        """Append an image's detections (original frame) as COCO records."""
        stem = Path(im_file or "0").stem
        image_id = int(stem) if stem.isnumeric() else stem
        b = boxes_xyxy.copy()
        b[:, 2:] -= b[:, :2]  # xyxy -> top-left xywh
        for j in range(len(b)):
            self.jdict.append({"image_id": image_id, "category_id": int(cls[j]),
                               "bbox": [round(float(x), 3) for x in b[j]], "score": round(float(conf[j]), 5)})

    def save_predictions_json(self, save_dir) -> Path:
        """Write the records to save_dir/predictions.json; returns its path."""
        path = Path(save_dir) / "predictions.json"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(self.jdict))
        LOGGER.info(f"saved {len(self.jdict)} predictions to {path}")
        return path

    def coco_evaluate(self, anno_json, pred_json) -> Dict[str, float]:
        """COCO evaluation of a predictions file against a COCO-format ground
        truth (dicts or paths), by `COCOEvalNp`: map50-95, map50, map75 and
        the small, medium and large mAPs."""
        from ultralytics_pro_tpu_torch.utils.cocoeval import COCOEvalNp

        stats = COCOEvalNp(*(str(x) if isinstance(x, Path) else x for x in (anno_json, pred_json))).run()
        LOGGER.info(f"COCO eval (numpy): mAP50-95 {stats['map50-95']:.4f} mAP50 {stats['map50']:.4f}")
        return stats

    @torch.no_grad()
    def run(self, img_u8: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The device function: (B, H, W, 3) uint8 BGR on the model's device ->
        dict of (B, max_det) 'boxes' xyxy, 'scores', 'cls', 'valid'."""
        return self._run(img_u8)[0]

    def _run(self, img_u8: torch.Tensor, payload: bool = False):
        """Forward and multi-label NMS, with the columns after the class scores
        as 'extra' when payload. Returns (NMS dict, the head's second output);
        an end-to-end head's rows skip NMS (dict None)."""
        nc = self.model.nc
        with full_f32():
            if self.model.model[-1].end2end:
                return end2end_outputs(self.model(rgb01(img_u8), aux=False)[0], self.conf), None
            y, aux = self.model(rgb01(img_u8))
            out = non_max_suppression(y[..., :4], y[..., 4:4 + nc], extra=y[..., 4 + nc:] if payload else None,
                                      conf_thres=self.conf, iou_thres=self.iou, max_det=self.max_det,
                                      multi_label=True)
        return out, aux

    def to_host(self, out: Dict[str, torch.Tensor], batch: Dict) -> Dict[str, np.ndarray]:
        """run's outputs as host arrays."""
        return {k: v.cpu().numpy() for k, v in out.items()}

    def __call__(self, model, dataloader, names: Optional[Dict] = None) -> DetMetrics:
        """model: a task model on its device whose head is one of `head_types`."""
        if not isinstance(model.model[-1], self.head_types):
            want = " or ".join(t.__name__ for t in self.head_types)
            raise NotImplementedError(f"{type(self).__name__} needs a {want} head, "
                                      f"got {type(model.model[-1]).__name__}")
        self.model = model
        self.jdict = []
        device = next(model.parameters()).device
        names = names or model.names
        metrics = self.metrics_class(names)
        confusion = ConfusionMatrix(nc=len(names))
        profilers = (Profile(device=device), Profile(device=device), Profile(device=device))
        for batch in dataloader:
            with profilers[0]:
                img = torch.from_numpy(batch["img"]).to(device)
            with profilers[1]:
                out = self.to_host(self.run(img), batch)
            with profilers[2]:
                self.update_metrics(out, batch, metrics, confusion)

        metrics.process()
        metrics.speed = {
            "preprocess": profilers[0].t, "inference": profilers[1].t, "postprocess": profilers[2].t,
        }
        self.print_results(metrics, names)
        self.confusion = confusion
        if self.save_json and self.writes_json:  # to save_dir, else project/name (runs/val by default)
            self.save_predictions_json(self.args.get("save_dir") or
                                       Path(self.args.get("project") or "runs/val") / (self.args.get("name") or ""))
        return metrics

    def update_metrics(self, out: Dict[str, np.ndarray], batch: Dict, metrics: DetMetrics,
                       confusion: ConfusionMatrix):
        b = out["boxes"].shape[0] - int(batch.get("pad_count", 0))
        imgsz = batch["img"].shape[1:3]
        h, w = imgsz
        ori_shapes = batch.get("ori_shapes") or [None] * b
        ratio_pads = batch.get("ratio_pads") or [None] * b
        im_files = batch.get("im_files") or [None] * b
        for i in range(b):
            valid = out["valid"][i]
            n = int(valid.sum())
            pred_boxes = out["boxes"][i][:n]
            pred_conf = out["scores"][i][:n]
            pred_cls = out["cls"][i][:n].astype(np.float32)
            if self.single_cls:
                pred_cls = np.zeros_like(pred_cls)

            gmask = batch["mask_gt"][i]
            gt_boxes = xywhn_to_xyxy_px(batch["bboxes"][i][gmask], h, w)  # normalized xywh in letterbox frame
            gt_cls = batch["cls"][i][gmask]

            # evaluate in the original image frame: scale_boxes clips to the
            # original bounds, which letterbox-frame matching would miss
            if ori_shapes[i] is not None:
                pred_boxes = self._to_original_frame(pred_boxes, imgsz, ori_shapes[i], ratio_pads[i])
                gt_boxes = self._to_original_frame(gt_boxes, imgsz, ori_shapes[i], ratio_pads[i])
            if self.save_json and n:
                self.pred_to_json(pred_boxes, pred_conf, pred_cls, im_files[i])

            iou = box_iou_np(gt_boxes, pred_boxes) if n and len(gt_boxes) else np.zeros((len(gt_boxes), n))
            tp = match_predictions(pred_cls, gt_cls, iou)
            metrics.update_stats(tp, pred_conf, pred_cls, gt_cls)

    def print_results(self, metrics: DetMetrics, names):
        mp, mr, map50, map5095 = metrics.mean_results()
        LOGGER.info(f"{'all':>12}  P {mp:.3f}  R {mr:.3f}  mAP50 {map50:.3f}  mAP50-95 {map5095:.3f}")


class SegmentationValidator(DetectionValidator):
    """Box and mask matching; SegmentMetrics. Writes no predictions.json."""

    head_types = (Segment,)
    metrics_class = SegmentMetrics
    writes_json = False

    @torch.no_grad()
    def run(self, img_u8: torch.Tensor) -> Dict[str, torch.Tensor]:
        """As DetectionValidator.run, plus 'extra' (B, max_det, nm) mask
        coefficients and 'protos' (B, nm, H/4, W/4)."""
        out, aux = self._run(img_u8, payload=True)
        out["protos"] = aux["protos"]
        return out

    @torch.no_grad()
    def to_host(self, out: Dict[str, torch.Tensor], batch: Dict) -> Dict:
        """run's outputs on the host, the prototypes and coefficients replaced
        by 'pred_masks': each image's (n, H/4, W/4) > 0.5 masks, made on the
        device by `process_mask` (boxes scaled to the prototype grid, edges
        rounded)."""
        shape = batch["img"].shape[1:3]
        counts = out["valid"].sum(1).tolist()
        masks = []
        with full_f32():
            for i, n in enumerate(counts):
                n = int(n)
                m = process_mask(out["protos"][i], out["extra"][i][:n], out["boxes"][i][:n], shape) > 0.5
                masks.append(m.cpu().numpy())
        host = {k: v.cpu().numpy() for k, v in out.items() if k not in ("protos", "extra")}
        host["pred_masks"] = masks
        return host

    def update_metrics(self, out, batch, metrics, confusion):
        b = out["boxes"].shape[0] - int(batch.get("pad_count", 0))
        h, w = batch["img"].shape[1:3]
        ori_shapes = batch.get("ori_shapes") or [None] * b
        ratio_pads = batch.get("ratio_pads") or [None] * b
        for i in range(b):
            n = int(out["valid"][i].sum())
            pred_boxes = out["boxes"][i][:n]
            pred_conf = out["scores"][i][:n]
            pred_cls = out["cls"][i][:n].astype(np.float32)

            gmask = batch["mask_gt"][i]
            gt_boxes = xywhn_to_xyxy_px(batch["bboxes"][i][gmask], h, w)
            gt_cls = batch["cls"][i][gmask]

            # boxes matched in the original frame; masks stay in the letterbox
            # frame, where the prototypes and the ground-truth masks both live
            box_p, box_g = pred_boxes, gt_boxes
            if ori_shapes[i] is not None:
                box_p = self._to_original_frame(pred_boxes, (h, w), ori_shapes[i], ratio_pads[i])
                box_g = self._to_original_frame(gt_boxes, (h, w), ori_shapes[i], ratio_pads[i])
            iou = box_iou_np(box_g, box_p) if n and len(box_g) else np.zeros((len(box_g), n))
            tp = match_predictions(pred_cls, gt_cls, iou)

            tp_m = np.zeros_like(tp)
            if n and len(gt_boxes) and "masks" in batch:
                pm = out["pred_masks"][i]  # (n, mh, mw)
                gm = batch["masks"][i][gmask] > 0.5  # (m, mh, mw)
                miou = mask_iou_np(gm.reshape(len(gm), -1).astype(np.float32),
                                   pm.reshape(n, -1).astype(np.float32))
                tp_m = match_predictions(pred_cls, gt_cls, miou)
            metrics.update_stats(tp, pred_conf, pred_cls, gt_cls, tp_m=tp_m)

    def print_results(self, metrics, names):
        _, _, map50, map5095 = metrics.box.mean_results()
        sm = metrics.seg.mean_results()
        LOGGER.info(f"{'all':>12}  box mAP50 {map50:.3f} mAP {map5095:.3f} | mask mAP50 {sm[2]:.3f} mAP {sm[3]:.3f}")


class PoseValidator(DetectionValidator):
    """Box and OKS keypoint matching, both in the letterbox frame; PoseMetrics.
    Writes no predictions.json."""

    head_types = (Pose,)
    metrics_class = PoseMetrics
    writes_json = False

    @torch.no_grad()
    def run(self, img_u8: torch.Tensor) -> Dict[str, torch.Tensor]:
        """As DetectionValidator.run, plus 'extra' (B, max_det, nk) decoded keypoints."""
        return self._run(img_u8, payload=True)[0]

    def update_metrics(self, out, batch, metrics, confusion):
        b = out["boxes"].shape[0] - int(batch.get("pad_count", 0))
        h, w = batch["img"].shape[1:3]
        for i in range(b):
            n = int(out["valid"][i].sum())
            pred_boxes = out["boxes"][i][:n]
            pred_conf = out["scores"][i][:n]
            pred_cls = out["cls"][i][:n].astype(np.float32)
            gmask = batch["mask_gt"][i]
            gt_boxes = xywhn_to_xyxy_px(batch["bboxes"][i][gmask], h, w)
            gt_cls = batch["cls"][i][gmask]

            iou = box_iou_np(gt_boxes, pred_boxes) if n and len(gt_boxes) else np.zeros((len(gt_boxes), n))
            tp = match_predictions(pred_cls, gt_cls, iou)
            tp_p = np.zeros_like(tp)
            if n and len(gt_boxes) and "keypoints" in batch:
                k3 = batch["keypoints"][i][gmask].copy()  # (m, K, 3) normalized
                k3[..., 0] *= w
                k3[..., 1] *= h
                nk = k3.shape[1]
                pk = out["extra"][i][:n].reshape(n, nk, -1)
                sigma = OKS_SIGMA if nk == 17 else np.ones(nk, np.float32) / nk
                area = (gt_boxes[:, 2] - gt_boxes[:, 0]) * (gt_boxes[:, 3] - gt_boxes[:, 1]) * 0.53
                tp_p = match_predictions(pred_cls, gt_cls, kpt_iou(k3, pk[..., :2], area, sigma))
            metrics.update_stats(tp, pred_conf, pred_cls, gt_cls, tp_p=tp_p)

    def print_results(self, metrics, names):
        _, _, map50, _ = metrics.box.mean_results()
        pm = metrics.pose.mean_results()
        LOGGER.info(f"{'all':>12}  box mAP50 {map50:.3f} | pose mAP50 {pm[2]:.3f}")


class OBBValidator(DetectionValidator):
    """Rotated boxes matched by probiou in the letterbox frame; OBBMetrics.
    With save_json, DOTA Task1 files under `save_dir`/predictions_dota."""

    head_types = (OBB,)
    metrics_class = OBBMetrics
    writes_json = False

    def __init__(self, args: Dict | None = None):
        super().__init__(args)
        self.dota = None  # with save_json, (image file, rboxes, conf, cls) of each image

    @torch.no_grad()
    def run(self, img_u8: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The device function: forward, then the rotated NMS -> dict of
        (B, max_det) 'rboxes' xywhr, 'scores', 'cls', 'valid'."""
        nc = self.model.nc
        with full_f32():
            y, _ = self.model(rgb01(img_u8))
            rb = torch.cat([y[..., :4], y[..., 4 + nc:5 + nc]], -1)
            return non_max_suppression_rotated(rb, y[..., 4:4 + nc], conf_thres=self.conf, iou_thres=self.iou,
                                               max_det=self.max_det)

    def __call__(self, model, dataloader, names: Optional[Dict] = None) -> OBBMetrics:
        self.dota = [] if self.save_json else None
        metrics = super().__call__(model, dataloader, names)
        if self.dota is not None:
            self.save_dota(self.args.get("save_dir", "."), names or model.names)
        return metrics

    def update_metrics(self, out, batch, metrics, confusion):
        b = out["rboxes"].shape[0] - int(batch.get("pad_count", 0))
        h, w = batch["img"].shape[1:3]
        for i in range(b):
            n = int(out["valid"][i].sum())
            pred_rb = out["rboxes"][i][:n]
            pred_conf = out["scores"][i][:n]
            pred_cls = out["cls"][i][:n].astype(np.float32)
            gmask = batch["mask_gt"][i]
            gt_rb = batch["bboxes"][i][gmask].copy()  # (m, 5) normalised xywh, the angle in radians
            gt_cls = batch["cls"][i][gmask]
            if len(gt_rb):
                gt_rb[:, :4] *= np.array([w, h, w, h], np.float32)
            iou = (batch_probiou(torch.from_numpy(gt_rb), torch.from_numpy(pred_rb)).numpy()
                   if n and len(gt_rb) else np.zeros((len(gt_rb), n)))
            metrics.update_stats(match_predictions(pred_cls, gt_cls, iou), pred_conf, pred_cls, gt_cls)
            if self.dota is not None:
                self.dota.append(self._original_frame_rboxes(pred_rb, batch, i, h, w) + (pred_conf, pred_cls))

    @staticmethod
    def _original_frame_rboxes(pred_rb, batch, i: int, h: int, w: int):
        """(image file, rboxes in the original image's pixels): centres
        unpadded by the unrounded pad and divided by the gain, sizes divided
        by it."""
        im_files = batch.get("im_files") or [""] * (i + 1)
        ori_shapes = batch.get("ori_shapes") or [None] * (i + 1)
        rb = pred_rb.copy()
        ori = ori_shapes[i] if i < len(ori_shapes) else None
        if ori is not None and len(rb):
            h0, w0 = ori
            r = min(h / h0, w / w0)
            dw, dh = (w - w0 * r) / 2, (h - h0 * r) / 2
            rb[:, 0] = (rb[:, 0] - dw) / r
            rb[:, 1] = (rb[:, 1] - dh) / r
            rb[:, 2:4] /= r
        return im_files[i] if i < len(im_files) else "", rb

    def save_dota(self, save_dir, names) -> Path:
        """DOTA Task1 files, one per class (`Task1_<name>.txt`), each row
        `image_id conf x1 y1 x2 y2 x3 y3 x4 y4`; returns their directory."""
        per_class = defaultdict(list)
        for im_file, rb, conf, cls in self.dota:
            if not len(rb):
                continue
            polys = xywhr2xyxyxyxy(np.ascontiguousarray(rb)).reshape(len(rb), 8)
            stem = Path(im_file).stem if im_file else "image"
            for p8, cf, c in zip(polys, conf, cls):
                name = str(names.get(int(c), int(c))).replace(" ", "-")
                per_class[name].append(f"{stem} {cf:.4f} " + " ".join(f"{v:.2f}" for v in p8))
        out = Path(save_dir) / "predictions_dota"
        out.mkdir(parents=True, exist_ok=True)
        for name, rows in per_class.items():
            (out / f"Task1_{name}.txt").write_text("\n".join(rows) + "\n")
        return out


class ClassificationValidator(DetectionValidator):
    """Top-1 and top-5 accuracy; ClassifyMetrics. Writes no predictions.json."""

    head_types = (Classify,)
    metrics_class = ClassifyMetrics
    writes_json = False

    @torch.no_grad()
    def run(self, img_u8: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The device function: (B, H, W, 3) uint8 BGR -> {'probs': (B, nc)}."""
        with full_f32():
            return {"probs": self.model(rgb01(img_u8))}

    def update_metrics(self, out, batch, metrics, confusion):
        b = out["probs"].shape[0] - int(batch.get("pad_count", 0))
        top5 = np.argsort(-out["probs"][:b], axis=-1, kind="stable")[:, :5]
        metrics.update(batch["cls"][:b], top5)

    def print_results(self, metrics, names):
        LOGGER.info(f"top1 {metrics.top1:.3f}  top5 {metrics.top5:.3f}")
