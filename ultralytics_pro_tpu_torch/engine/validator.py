"""Validator: dataloader -> device function (forward + NMS) -> TP matching -> DetMetrics.

Counterpart of `ultralytics_pro_tpu/engine/validator.py:DetectionValidator:25`.
The jitted device function of the JAX package (`_build_jit:105`) is a plain
device function here, `run(img_u8)`: uint8 BGR batch -> RGB/255 -> forward ->
generic decode -> multi-label NMS (kernel K1 on the card), in full f32 with
TF32 off (`utils.full_f32`). Matching in the original image frame and AP run
on the host in numpy (`utils/metrics.py`). The three `Profile`s synchronise
the model's device: preprocess is the batch's copy to the device, inference
the device function and the copy back, postprocess the matching.

`save_json` (and so `coco_evaluate`) and `plots` raise NotImplementedError;
the v10Detect end-to-end branch waits for that head.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ultralytics_pro_tpu_torch.nn.modules.head import Detect
from ultralytics_pro_tpu_torch.ops.boxes import scale_boxes
from ultralytics_pro_tpu_torch.ops.nms import non_max_suppression
from ultralytics_pro_tpu_torch.utils import LOGGER, Profile, full_f32
from ultralytics_pro_tpu_torch.utils.metrics import (
    ConfusionMatrix,
    DetMetrics,
    box_iou_np,
    match_predictions,
)


class DetectionValidator:
    """Evaluate a detection model over a dataloader."""

    def __init__(self, args: Dict | None = None):
        self.args = dict(args or {})
        self.conf = float(self.args.get("conf") or 0.001)
        self.iou = float(self.args.get("iou", 0.7))
        self.max_det = int(self.args.get("max_det", 300))
        self.single_cls = bool(self.args.get("single_cls", False))
        for key in ("save_json", "plots"):
            if self.args.get(key):
                raise NotImplementedError(f"val with {key}=True is not implemented in "
                                          f"ultralytics_pro_tpu_torch yet; pass {key}=False")
        self.model = None

    @staticmethod
    def _to_original_frame(boxes: np.ndarray, imgsz, ori_shape, ratio_pad):
        """Rescale letterbox-frame xyxy boxes to the original image frame and
        clip: predictions and ground truth are matched there."""
        if ori_shape is None or not len(boxes):
            return boxes
        return scale_boxes(imgsz, torch.from_numpy(boxes), ori_shape, ratio_pad=ratio_pad).numpy()

    def coco_evaluate(self, anno_json, pred_json):
        raise NotImplementedError("COCO evaluation of saved predictions is not implemented in "
                                  "ultralytics_pro_tpu_torch yet")

    @torch.no_grad()
    def run(self, img_u8: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The device function: (B, H, W, 3) uint8 BGR on the model's device ->
        dict of (B, max_det) 'boxes' xyxy, 'scores', 'cls', 'valid'."""
        x = img_u8.flip(-1) if img_u8.shape[-1] == 3 else img_u8
        x = x.permute(0, 3, 1, 2).float().contiguous() / 255.0
        with full_f32():
            y, _ = self.model(x)
            return non_max_suppression(y[..., :4], y[..., 4:4 + self.model.nc], conf_thres=self.conf,
                                       iou_thres=self.iou, max_det=self.max_det, multi_label=True)

    def __call__(self, model, dataloader, names: Optional[Dict] = None) -> DetMetrics:
        """model: a DetectionModel on its device."""
        if not isinstance(model.model[-1], Detect):
            raise NotImplementedError(f"DetectionValidator needs a Detect head, got "
                                      f"{type(model.model[-1]).__name__}")
        self.model = model
        device = next(model.parameters()).device
        names = names or model.names
        metrics = DetMetrics(names)
        confusion = ConfusionMatrix(nc=len(names))
        profilers = (Profile(device=device), Profile(device=device), Profile(device=device))
        for batch in dataloader:
            with profilers[0]:
                img = torch.from_numpy(batch["img"]).to(device)
            with profilers[1]:
                out = {k: v.cpu().numpy() for k, v in self.run(img).items()}
            with profilers[2]:
                self.update_metrics(out, batch, metrics, confusion)

        metrics.process()
        metrics.speed = {
            "preprocess": profilers[0].t, "inference": profilers[1].t, "postprocess": profilers[2].t,
        }
        self.print_results(metrics, names)
        self.confusion = confusion
        return metrics

    def update_metrics(self, out: Dict[str, np.ndarray], batch: Dict, metrics: DetMetrics,
                       confusion: ConfusionMatrix):
        b = out["boxes"].shape[0] - int(batch.get("pad_count", 0))
        imgsz = batch["img"].shape[1:3]
        h, w = imgsz
        ori_shapes = batch.get("ori_shapes") or [None] * b
        ratio_pads = batch.get("ratio_pads") or [None] * b
        for i in range(b):
            valid = out["valid"][i]
            n = int(valid.sum())
            pred_boxes = out["boxes"][i][:n]
            pred_conf = out["scores"][i][:n]
            pred_cls = out["cls"][i][:n].astype(np.float32)
            if self.single_cls:
                pred_cls = np.zeros_like(pred_cls)

            gmask = batch["mask_gt"][i]
            gt_n = batch["bboxes"][i][gmask]  # normalized xywh in letterbox frame
            gt_cls = batch["cls"][i][gmask]
            # to pixel xyxy
            cx, cy, bw, bh = gt_n[:, 0] * w, gt_n[:, 1] * h, gt_n[:, 2] * w, gt_n[:, 3] * h
            gt_boxes = np.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2], 1) if len(gt_n) else np.zeros((0, 4))

            # evaluate in the original image frame: scale_boxes clips to the
            # original bounds, which letterbox-frame matching would miss
            if ori_shapes[i] is not None:
                pred_boxes = self._to_original_frame(pred_boxes, imgsz, ori_shapes[i], ratio_pads[i])
                gt_boxes = self._to_original_frame(gt_boxes, imgsz, ori_shapes[i], ratio_pads[i])

            iou = box_iou_np(gt_boxes, pred_boxes) if n and len(gt_boxes) else np.zeros((len(gt_boxes), n))
            tp = match_predictions(pred_cls, gt_cls, iou)
            metrics.update_stats(tp, pred_conf, pred_cls, gt_cls)

    def print_results(self, metrics: DetMetrics, names):
        mp, mr, map50, map5095 = metrics.mean_results()
        LOGGER.info(f"{'all':>12}  P {mp:.3f}  R {mr:.3f}  mAP50 {map50:.3f}  mAP50-95 {map5095:.3f}")
