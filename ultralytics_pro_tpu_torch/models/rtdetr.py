"""RT-DETR in the port: the NMS-free predictor and the facade (predict only).

Counterpart of `ultralytics_pro_tpu/models/rtdetr.py` (`RTDETRPredictor:93`,
`RTDETR:134`). The device function `run` is the JAX package's jitted `run`:
uint8 BGR batch -> RGB / 255 -> forward -> (B, nq, 4 + nc) normalised cxcywh
boxes and scores, in full f32 with TF32 off (`utils.full_f32`); deformable
attention runs on kernel K2 for tensors on the card. The postprocess is that
of `:119-131`: conf = best score, cls = its class, keep conf > `conf`, then
letterboxed pixels -> original pixels with the same gain and pad rounding.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ultralytics_pro_tpu_torch.engine.model import Model
from ultralytics_pro_tpu_torch.engine.predictor import BasePredictor, rgb01
from ultralytics_pro_tpu_torch.engine.results import Results
from ultralytics_pro_tpu_torch.nn.modules.head import RTDETRDecoder
from ultralytics_pro_tpu_torch.utils import full_f32

_LATER = ("comes with a later slice of the port, after detect val and train (ROADMAP.md queue 1): "
          "it needs the DETR loss, the Hungarian matcher, contrastive denoising and a K2 backward")


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
    """RT-DETR entry point: `RTDETR("rtdetr-l.yaml", device="cuda").predict(images)`."""

    def __init__(self, model="rtdetr-l.yaml", device="cuda", seed: int = 0, verbose: bool = False):
        super().__init__(model, task="detect", device=device, seed=seed, verbose=verbose)
        if not isinstance(self.model.model[-1], RTDETRDecoder):
            raise ValueError(f"RTDETR needs a model whose head is RTDETRDecoder, got "
                             f"{type(self.model.model[-1]).__name__}")

    def val(self, *args, **kwargs):
        raise NotImplementedError(f"RTDETR.val is not ported yet: the RT-DETR validator {_LATER}")

    def train(self, *args, **kwargs):
        raise NotImplementedError(f"RTDETR.train is not ported yet: the RT-DETR trainer {_LATER}")
