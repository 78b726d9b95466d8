"""Streaming predictor: images -> letterbox -> device function -> Results.

Counterpart of `ultralytics_pro_tpu/engine/predictor.py` (`BasePredictor:26`,
`DetectionPredictor:219`). The jitted `run` of the JAX package (`_build_jit:45`)
is a plain device function here: uint8 BGR batch -> RGB/255 -> forward ->
fused single-label decode -> NMS (kernel K1 on the card), the branch
`:136-148` takes for a plain Detect head, in full f32 with TF32 off
(`utils.full_f32`), as the JAX package computes it. Letterboxing runs on the
model's device.

Sources are HWC uint8 BGR numpy arrays, or a list of them. Reading image
files needs OpenCV and waits for a later slice.
"""

from __future__ import annotations

from typing import Dict, Iterator, List

import numpy as np
import torch

from ultralytics_pro_tpu_torch.data.augment import LetterBox
from ultralytics_pro_tpu_torch.engine.results import Results
from ultralytics_pro_tpu_torch.nn.modules.head import Detect, decode_single_label
from ultralytics_pro_tpu_torch.ops.boxes import scale_boxes
from ultralytics_pro_tpu_torch.ops.nms import non_max_suppression_fused
from ultralytics_pro_tpu_torch.utils import Profile, full_f32


def _to_host(out):
    """The device function's output (a tensor or a dict of tensors) on the CPU."""
    return {k: v.cpu() for k, v in out.items()} if isinstance(out, dict) else out.cpu()


class BasePredictor:
    """Single-model streaming inference on the model's device."""

    head_types = (Detect,)  # the heads whose outputs this predictor's run and postprocess read

    def __init__(self, model, args: Dict | None = None):
        """model: a DetectionModel already on its device."""
        self.model = model
        self.args = dict(args or {})
        self.imgsz = int(self.args.get("imgsz", 640))
        self.conf = float(self.args.get("conf", 0.25) or 0.25)
        self.iou = float(self.args.get("iou", 0.45))
        self.max_det = int(self.args.get("max_det", 300))
        self.classes = self.args.get("classes")
        self.agnostic = bool(self.args.get("agnostic_nms", False))
        if self.args.get("augment"):
            raise NotImplementedError("test-time augmentation is not implemented in "
                                      "ultralytics_pro_tpu_torch")
        if not isinstance(model.model[-1], self.head_types):
            wanted = " or ".join(t.__name__ for t in self.head_types)
            raise NotImplementedError(f"{type(self).__name__} needs a {wanted} head, "
                                      f"got {type(model.model[-1]).__name__}")
        self.device = next(model.parameters()).device
        self.letterbox = LetterBox((self.imgsz, self.imgsz), scaleup=False)
        self.classes_mask = None
        if self.classes is not None:
            mask = np.zeros((model.nc,), bool)
            mask[np.array(self.classes, int)] = True
            self.classes_mask = tuple(mask.tolist())

    @torch.no_grad()
    def run(self, img_u8: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The device function: (B, H, W, 3) uint8 BGR on the model's device ->
        dict of (B, max_det) 'boxes' xyxy, 'scores', 'cls', 'valid'. Runs in
        full f32 (`utils.full_f32`)."""
        x = img_u8.flip(-1) if img_u8.shape[-1] == 3 else img_u8
        x = x.permute(0, 3, 1, 2).float().contiguous() / 255.0
        head = self.model.model[-1]
        with full_f32():
            raw = self.model(x, decode=False)
            boxes, conf, cls = decode_single_label(raw, head.stride.tolist(), head.nc, head.reg_max)
            return non_max_suppression_fused(boxes, conf, cls, conf_thres=self.conf,
                                             iou_thres=self.iou, max_det=self.max_det,
                                             agnostic=self.agnostic, classes=self.classes_mask)

    def preprocess(self, imgs: List[np.ndarray]) -> torch.Tensor:
        """Letterbox each image on the device; returns the (B, H, W, C) uint8 batch."""
        return torch.stack([self.letterbox(im, device=self.device) for im in imgs])

    def __call__(self, source, stream: bool = False):
        gen = self.stream_inference(source)
        return gen if stream else list(gen)

    @staticmethod
    def load_images(source) -> Iterator:
        """(name, HWC uint8 array) pairs from an array or a list of arrays."""
        imgs = source if isinstance(source, (list, tuple)) else [source]
        for i, im in enumerate(imgs):
            if not isinstance(im, np.ndarray):
                raise NotImplementedError(
                    f"source of type {type(im).__name__}: reading image files and streams needs "
                    "OpenCV (cv2), which ultralytics_pro_tpu_torch does not use yet; pass HWC "
                    "uint8 BGR numpy arrays")
            yield f"image{i}", im

    def stream_inference(self, source) -> Iterator[Results]:
        profilers = (Profile(device=self.device), Profile(device=self.device),
                     Profile(device=self.device))
        for path, im0 in self.load_images(source):
            with profilers[0]:
                batch = self.preprocess([im0])
            with profilers[1]:
                out = _to_host(self.run(batch))
            with profilers[2]:
                results = self.postprocess(out, tuple(batch.shape[1:3]), [im0], [path])
            r = results[0]
            r.speed = {"preprocess": profilers[0].dt * 1e3, "inference": profilers[1].dt * 1e3,
                       "postprocess": profilers[2].dt * 1e3}
            yield r

    def postprocess(self, out: Dict[str, torch.Tensor], batch_shape, im0s, paths) -> List[Results]:
        """Valid detections, rescaled to each original image, as Results."""
        results = []
        for i, im0 in enumerate(im0s):
            n = int(out["valid"][i].sum())
            boxes = scale_boxes(batch_shape, out["boxes"][i][:n], im0.shape[:2])
            data = torch.cat([boxes, out["scores"][i][:n, None],
                              out["cls"][i][:n, None].float()], 1)
            results.append(Results(im0, paths[i], self.model.names, boxes=data.numpy()))
        return results


class DetectionPredictor(BasePredictor):
    pass
