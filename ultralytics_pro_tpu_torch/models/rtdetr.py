"""RT-DETR in the port: the trainer, the NMS-free predictor and validator,
and the facade (predict, val and train).

Counterpart of `ultralytics_pro_tpu/models/rtdetr.py` (`RTDETRTrainer:21`,
`RTDETRValidator:46`, `RTDETRPredictor:93`, `RTDETR:134`). The trainer is
the port's BaseTrainer with the DETR criterion (`utils/detr_loss.py`) and the
contrastive-denoising queries that `make_cdn_batch` draws for each batch on
the host. Where the JAX trainer draws them from an unseeded generator, the
port's trainer owns one seeded from the `seed` argument (ROADMAP.md section
3). Deformable attention runs on K2 forward and backward for tensors on the
card. The predictor's device function `run` is
the JAX package's jitted `run`:
uint8 BGR batch -> RGB / 255 -> forward -> (B, nq, 4 + nc) normalised cxcywh
boxes and scores, in full f32 with TF32 off (`utils.full_f32`); deformable
attention runs on kernel K2 for tensors on the card. The postprocess is that
of `:119-131`: conf = best score, cls = its class, keep conf > `conf`, then
letterboxed pixels -> original pixels with the same gain and pad rounding.

The validator's device function is the JAX validator's (`:49-62`): the same
forward, then each query's best score as `conf`, its class and `valid = conf
> 0`, with no NMS. Its `update_metrics` keeps `conf > self.conf` and matches
in the letterbox frame (`:64-83`), where the port's DetectionValidator
matches in the original frame. Two departures from the JAX validator, as
the port's DetectionValidator has them: the `pad_count` copies that fill a
short last batch are not scored (the JAX one scores them again), and under
`single_cls` the predicted classes are zeroed too, since the port's dataset
zeroes the ground truth's (ROADMAP.md section 3).
"""

from __future__ import annotations

import copy
from typing import Dict, List

import numpy as np
import torch

from ultralytics_pro_tpu_torch.engine.model import Model
from ultralytics_pro_tpu_torch.engine.predictor import BasePredictor, rgb01
from ultralytics_pro_tpu_torch.engine.results import Results
from ultralytics_pro_tpu_torch.engine.trainer import BaseTrainer
from ultralytics_pro_tpu_torch.engine.validator import DetectionValidator, xywhn_to_xyxy_px
from ultralytics_pro_tpu_torch.nn.modules.head import RTDETRDecoder
from ultralytics_pro_tpu_torch.utils import full_f32
from ultralytics_pro_tpu_torch.utils.detr_loss import RTDETRDetectionLoss, make_cdn_batch
from ultralytics_pro_tpu_torch.utils.metrics import box_iou_np, match_predictions


class RTDETRTrainer(BaseTrainer):
    """RT-DETR trainer: RTDETRDetectionLoss, and each batch's denoising
    queries (`dn_train`, default True; `num_dn`, default 100) passed to the
    model."""

    def __init__(self, model, args):
        super().__init__(model, args)
        self.cdn_rng = np.random.default_rng(int(args.get("seed") or 0))

    def build_criterion(self):
        return RTDETRDetectionLoss(nc=self.model.nc)

    def put_batch(self, batch: Dict) -> Dict:
        out = super().put_batch(batch)
        if self.args.get("dn_train", True):
            dn = make_cdn_batch(batch["cls"], batch["bboxes"], batch["mask_gt"], nc=self.model.nc,
                                num_dn=int(self.args.get("num_dn", 100)), rng=self.cdn_rng)
            out["dn"] = {k: torch.from_numpy(v).to(self.device) for k, v in dn.items()}
        return out

    def model_outputs(self, batch: Dict):
        return self.model(batch["img"], dn=batch.get("dn"))


class RTDETRValidator(DetectionValidator):
    """No-NMS validation: each query's best class above `conf`, matched in the
    letterbox frame."""

    head_type = RTDETRDecoder

    @torch.no_grad()
    def run(self, img_u8: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The device function: (B, H, W, 3) uint8 BGR on the model's device ->
        dict of (B, nq) 'boxes' normalised cxcywh, 'scores' (the best class
        score), 'cls' and 'valid' (score > 0). Runs in full f32."""
        with full_f32():
            y, _ = self.model(rgb01(img_u8), aux=False)
            scores = y[..., 4:]
            conf = scores.amax(-1)
            return {"boxes": y[..., :4], "scores": conf, "cls": scores.argmax(-1).int(), "valid": conf > 0}

    def update_metrics(self, out, batch, metrics, confusion):
        b = out["boxes"].shape[0] - int(batch.get("pad_count", 0))
        h, w = batch["img"].shape[1:3]
        for i in range(b):
            conf = out["scores"][i]
            keep = conf > self.conf
            n = int(keep.sum())
            pred_boxes = xywhn_to_xyxy_px(out["boxes"][i][keep], h, w)
            pred_conf = conf[keep]
            pred_cls = out["cls"][i][keep].astype(np.float32)
            if self.single_cls:
                pred_cls = np.zeros_like(pred_cls)
            gmask = batch["mask_gt"][i]
            gt_boxes = xywhn_to_xyxy_px(batch["bboxes"][i][gmask], h, w)
            gt_cls = batch["cls"][i][gmask]
            iou = box_iou_np(gt_boxes, pred_boxes) if n and len(gt_boxes) else np.zeros((len(gt_boxes), n))
            metrics.update_stats(match_predictions(pred_cls, gt_cls, iou), pred_conf, pred_cls, gt_cls)


class RTDETRPredictor(BasePredictor):
    """NMS-free predictor for an RTDETRDecoder model."""

    head_types = (RTDETRDecoder,)

    @torch.no_grad()
    def run(self, img_u8: torch.Tensor) -> torch.Tensor:
        """The device function: (B, H, W, 3) uint8 BGR on the model's device ->
        (B, nq, 4 + nc) normalised cxcywh boxes and sigmoid scores. Runs in
        full f32 (`utils.full_f32`)."""
        with full_f32():
            y, _ = self.model(rgb01(img_u8), aux=False)  # predict reads y alone
        return y

    def postprocess(self, y: torch.Tensor, batch_shape, im0s, paths) -> List[Results]:
        """Queries whose best score exceeds `conf`, in original-image pixels."""
        h1, w1 = batch_shape
        results = []
        for i, im0 in enumerate(im0s):
            yi = y[i].numpy()
            boxes, scores = yi[:, :4], yi[:, 4:]
            conf = scores.max(-1)
            cls = scores.argmax(-1)
            keep = conf > self.conf
            bx = boxes[keep]
            gain = min(h1 / im0.shape[0], w1 / im0.shape[1])
            pad_w = round((w1 - im0.shape[1] * gain) / 2 - 0.1)
            pad_h = round((h1 - im0.shape[0] * gain) / 2 - 0.1)
            x1 = ((bx[:, 0] - bx[:, 2] / 2) * w1 - pad_w) / gain
            y1 = ((bx[:, 1] - bx[:, 3] / 2) * h1 - pad_h) / gain
            x2 = ((bx[:, 0] + bx[:, 2] / 2) * w1 - pad_w) / gain
            y2 = ((bx[:, 1] + bx[:, 3] / 2) * h1 - pad_h) / gain
            data = np.stack([x1, y1, x2, y2, conf[keep], cls[keep].astype(np.float32)], 1)
            results.append(Results(im0, paths[i], self.model.names, boxes=data))
        return results


class RTDETR(Model):
    """RT-DETR entry point: `RTDETR("rtdetr-l.yaml", device="cuda").predict(images)`,
    `.val(data=...)` and `.train(data=...)`."""

    def __init__(self, model="rtdetr-l.yaml", device="cuda", seed: int = 0, verbose: bool = False):
        super().__init__(model, task="detect", device=device, seed=seed, verbose=verbose)
        if not isinstance(self.model.model[-1], RTDETRDecoder):
            raise ValueError(f"RTDETR needs a model whose head is RTDETRDecoder, got "
                             f"{type(self.model.model[-1]).__name__}")

    def val(self, data=None, **kwargs):
        """RT-DETR val (the JAX facade's, `:155-170`): the dataset's `split`
        without augmentation or rect batches, batch 16 by default, through
        RTDETRValidator; the model keeps its nc and takes the data's names.
        Returns DetMetrics."""
        from ultralytics_pro_tpu_torch.data import DataLoader, YOLODataset

        args = self._merged_args(**kwargs)
        d = self._dataset(data, args)
        self.model.names = d["names"]
        dataset = YOLODataset(d[args["split"]], imgsz=int(args["imgsz"]), augment=False, data=d,
                              single_cls=bool(args["single_cls"]))
        loader = DataLoader(dataset, batch_size=int(args["batch"]), workers=int(args["workers"]),
                            max_gt=int(args["max_gt"]))
        return RTDETRValidator(args)(self.model, loader, names=d["names"])

    def train(self, data=None, **kwargs):
        """RT-DETR training (the JAX facade's, `:172-196`): the model rebuilt
        at the dataset's nc, the train split shuffled with drop_last (augment
        as the arguments say: True raises, as YOLO's does), RTDETRTrainer,
        and no epoch-end val, as there. `data` is kept in the checkpoints'
        `train_args`, as `Model.train` keeps it. Returns None; results are on
        `self.trainer` and in its save_dir (results.csv, weights/last.ckpt)."""
        from ultralytics_pro_tpu_torch.data import DataLoader, YOLODataset

        args = self._merged_args(**kwargs)
        if data is not None:
            args["data"] = data
        d = self._dataset(data, args)
        if d["nc"] != self.model.nc:
            self.model = self._build(copy.deepcopy(self.model.yaml), nc=d["nc"])
        self.model.names = d["names"]
        train_set = YOLODataset(d["train"], imgsz=int(args["imgsz"]), augment=bool(args["augment"]), data=d)
        loader = DataLoader(train_set, batch_size=int(args["batch"]), shuffle=True, drop_last=True,
                            max_gt=int(args["max_gt"]), workers=int(args["workers"]))
        self.trainer = RTDETRTrainer(self.model, args)
        self.trainer.train(loader, val_fn=None)
