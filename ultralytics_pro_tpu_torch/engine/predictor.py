"""Streaming predictor: images -> letterbox -> device function -> Results.

Counterpart of `ultralytics_pro_tpu/engine/predictor.py` (`BasePredictor:26`,
`DetectionPredictor:219`, `SegmentationPredictor:223`,
`ClassificationPredictor:251`, `PosePredictor:283`, `OBBPredictor:314`).
The jitted `run` of the JAX package (`_build_jit:45`) is a plain device
function here, in full f32 with TF32 off (`utils.full_f32`), as the JAX
package computes it: uint8 BGR batch -> RGB/255 -> forward -> NMS (kernel K1
on the card). For a Detect head (the one head whose `fused_single_label`
is set) it takes the fused single-label decode (the branch `:136-148`
takes); for any other head (DDetect, AnchorDetect, IDetect, MAFDetect,
Segment, DSegment, ISegment, MAFSegment, Pose, IPose, MAFPose) the generic decode and `non_max_suppression`, with
the head's extra columns as its payload (`:149-159`): 32 mask coefficients
a candidate, or the decoded keypoints. Letterboxing runs
on the model's device. A v10Detect head is end-to-end (`:62,125-135`): no
NMS and no fused decode, its (B, 300, 6) rows taken as they come, boxes
`xywh2xyxy`, valid where conf > `conf` (`end2end_outputs`).

Segment's postprocess combines the coefficients with the prototypes, cuts the
letterbox pad off, resizes to the original image and crops by the boxes on
the model's device (the JAX postprocess runs them through `jnp`); only the
boolean masks come to the host. Pose rescales its keypoints on the host.

Classify resizes each image to an imgsz square with `resize_bilinear` on
the model's device (the JAX package's cv2 INTER_LINEAR, within a grey
level), runs RGB/255 and the forward in full f32, and brings only the
(B, nc) probabilities to the host.

A predictor takes a head by the task its class serves (`head.task`, read in
`BasePredictor.__init__` alone): the detect predictor every detect head
(Detect and its detect subclasses, AnchorDetect), the segment predictor
Segment and its subclasses, and so on; a Segment head, a Detect subclass,
still goes to the segment predictor only.

Test-time augmentation (`augment=True`, the JAX `tta_forward:76-116`) runs
on a head whose class sets `tta` (the detect heads: Detect, DDetect, IDetect,
MAFDetect, AnchorDetect) and that is not end-to-end: three
forwards at scales 1, 0.83 and 0.67 (each side `ceil(s * scale / 32) * 32`),
the second flipped left-right before its resize, the resize
`F.interpolate(bilinear, antialias=True)` as `jax.image.resize` shrinks; the
boxes descaled (and x mirrored back for the flip); the first pass's last
`(h // 32) * (w // 32)` rows and the last pass's first `(h // 8) * (w // 8)`
rows dropped (its P5 and P3 anchors at three levels; a YOLOX head's six
maps break those counts as they break the JAX package's); then the generic
NMS over the concatenation (K1 on the card), never the fused single-label
path. The JAX predictor applies it to every task's head; the port's other
predictors and heads raise on it (`tta_forward`).

Sources (`load_images`, through `data/loaders.py:load_inference_source`,
the JAX `load_images:175`): HWC uint8 BGR arrays or PIL images, an image
file, a folder, a glob or a list of paths, read one frame a call (B = 1) in
the JAX loader's order, each Results' `path` the file's; video files and
streams raise NotImplementedError naming the missing decoder.

`predict_files` (the JAX `predict_files:359`) runs real batches of `batch`
files: the loader's thread pool (`data/build.py:DataLoader`) decodes the
files, a batch ahead, the last batch padded by repeating its last file;
each image is letterboxed on the model's device as predict letterboxes it
(in the loop's thread: letterboxing inside the pool's threads on the card
took 437 host ms a batch of 16 640-px PNGs, on an NVIDIA H100 80GB HBM3 at
700 W and its host, against 24.5 ms this way; PERF.md);
then one device call (one K1 launch) a batch, the boxes rescaled to each
original image. Its Results'
`orig_img` is the decoded original, as the JAX fallback path gives it (the
JAX native loader hands back its letterboxed crop resized by cv2;
ROADMAP.md section 3). There is no per-image fallback.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, List

import numpy as np
import torch
import torch.nn.functional as F

from ultralytics_pro_tpu_torch.data.augment import LetterBox, resize_bilinear
from ultralytics_pro_tpu_torch.data.build import DataLoader
from ultralytics_pro_tpu_torch.data.image_io import imread
from ultralytics_pro_tpu_torch.data.loaders import load_inference_source
from ultralytics_pro_tpu_torch.engine.results import Results
from ultralytics_pro_tpu_torch.nn.modules.head import decode_single_label
from ultralytics_pro_tpu_torch.ops.boxes import scale_boxes, xywh2xyxy
from ultralytics_pro_tpu_torch.ops.masks import process_mask_native
from ultralytics_pro_tpu_torch.ops.nms import non_max_suppression, non_max_suppression_fused, non_max_suppression_rotated
from ultralytics_pro_tpu_torch.utils import Profile, full_f32


def _to_host(out):
    """The device function's output (a tensor or a dict of tensors) on the CPU."""
    return {k: v.cpu() for k, v in out.items()} if isinstance(out, dict) else out.cpu()


def rgb01(img_u8: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) uint8 BGR -> (B, 3, H, W) f32 RGB in [0, 1], the device
    functions' first step."""
    x = img_u8.flip(-1) if img_u8.shape[-1] == 3 else img_u8
    return x.permute(0, 3, 1, 2).float().contiguous() / 255.0


def end2end_outputs(y: torch.Tensor, conf: float) -> Dict[str, torch.Tensor]:
    """An end-to-end head's (B, k, 6) rows (xywh, conf, cls; scores
    descending) as the NMS dict: 'boxes' xyxy, 'scores', 'cls' int32 and
    'valid' = scores > conf."""
    return {"boxes": xywh2xyxy(y[..., :4]), "scores": y[..., 4], "cls": y[..., 5].to(torch.int32),
            "valid": y[..., 4] > conf}


TTA_PASSES = ((1.0, False), (0.83, True), (0.67, False))  # (scale, left-right flip) of each forward


def tta_forward(model, x: torch.Tensor) -> torch.Tensor:
    """The decoded (B, A', 4 + nc) rows of the three augmented forwards of x
    (B, 3, H, W) in [0, 1], boxes xywh in x's frame, concatenated over the
    anchors with the first pass's P5 and the last pass's P3 anchors dropped."""
    b, _, h, w = x.shape
    ys = []
    for si, (scale, flip) in enumerate(TTA_PASSES):
        sh, sw = (h, w) if scale == 1.0 else (math.ceil(h * scale / 32) * 32, math.ceil(w * scale / 32) * 32)
        xi = x.flip(-1) if flip else x
        if (sh, sw) != (h, w):
            xi = F.interpolate(xi, (sh, sw), mode="bilinear", align_corners=False, antialias=True)
        yi = model(xi)[0]
        bx = yi[..., :4] / torch.tensor([sw / w, sh / h, sw / w, sh / h], dtype=yi.dtype, device=yi.device)
        if flip:
            bx = torch.cat([w - bx[..., :1], bx[..., 1:]], -1)
        yi = torch.cat([bx, yi[..., 4:]], -1)
        if si == 0:
            yi = yi[:, :yi.shape[1] - (sh // 32) * (sw // 32)]
        elif si == len(TTA_PASSES) - 1:
            yi = yi[:, (sh // 8) * (sw // 8):]
        ys.append(yi)
    return torch.cat(ys, 1)


def _detections(out, i: int, n: int, batch_shape, orig_shape) -> torch.Tensor:
    """Image i's first n detections as (n, 6) rows, boxes rescaled to the
    original image: x1, y1, x2, y2, conf, cls."""
    boxes = scale_boxes(batch_shape, out["boxes"][i][:n], orig_shape)
    return torch.cat([boxes, out["scores"][i][:n, None], out["cls"][i][:n, None].float()], 1)


def letterbox_pad(batch_shape, orig_shape):
    """(gain, pad_w, pad_h) of the letterbox from orig_shape (h, w) to
    batch_shape (h, w), the pad rounded as `round(x / 2 - 0.1)`."""
    h1, w1 = batch_shape
    gain = min(h1 / orig_shape[0], w1 / orig_shape[1])
    return gain, round((w1 - orig_shape[1] * gain) / 2 - 0.1), round((h1 - orig_shape[0] * gain) / 2 - 0.1)


class BasePredictor:
    """Single-model streaming inference on the model's device."""

    task = "detect"  # the `task` of the heads whose outputs run and postprocess read
    outputs_to_host = True  # False: postprocess takes run's outputs on the device

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
        self.augment = bool(self.args.get("augment", False))
        head = model.model[-1]
        if getattr(head, "task", None) != self.task:
            raise NotImplementedError(f"{type(self).__name__} needs a head of task '{self.task}', got "
                                      f"{type(head).__name__} (task {getattr(head, 'task', None)!r})")
        end2end = getattr(head, "end2end", False)
        if self.augment and (not head.tta or end2end):
            raise NotImplementedError(
                f"test-time augmentation (augment=True) is not implemented in ultralytics_pro_tpu_torch for "
                f"{type(self).__name__} with a{'n end-to-end' if end2end else ''} {type(head).__name__} head: "
                "it takes the detect heads Detect, DDetect, IDetect, MAFDetect and AnchorDetect")
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
        dict of (B, max_det) 'boxes' xyxy, 'scores', 'cls', 'valid' (an
        end-to-end head's (B, 300) rows). Runs in full f32 (`utils.full_f32`)."""
        head = self.model.model[-1]
        if self.augment:
            with full_f32():
                y = tta_forward(self.model, rgb01(img_u8))
                nc = self.model.nc
                return non_max_suppression(y[..., :4], y[..., 4:4 + nc], conf_thres=self.conf, iou_thres=self.iou,
                                           max_det=self.max_det, agnostic=self.agnostic, classes=self.classes_mask)
        if not head.fused_single_label and not head.end2end:
            return self._run_generic(img_u8)[0]
        with full_f32():
            if head.end2end:
                return end2end_outputs(self.model(rgb01(img_u8), aux=False)[0], self.conf)
            raw = self.model(rgb01(img_u8), decode=False)
            boxes, conf, cls = decode_single_label(raw, head.stride.tolist(), head.nc, head.reg_max)
            return non_max_suppression_fused(boxes, conf, cls, conf_thres=self.conf,
                                             iou_thres=self.iou, max_det=self.max_det,
                                             agnostic=self.agnostic, classes=self.classes_mask)

    def _run_generic(self, img_u8: torch.Tensor):
        """The generic decode, then NMS with the columns after the class
        scores as each candidate's 'extra' payload. Returns (NMS dict, the
        head's aux dict)."""
        nc = self.model.nc
        with full_f32():
            y, aux = self.model(rgb01(img_u8))
            extra = y[..., 4 + nc:] if y.shape[-1] > 4 + nc else None
            out = non_max_suppression(y[..., :4], y[..., 4:4 + nc], extra=extra,
                                      conf_thres=self.conf, iou_thres=self.iou, max_det=self.max_det,
                                      agnostic=self.agnostic, classes=self.classes_mask)
        return out, aux

    def preprocess(self, imgs: List[np.ndarray]) -> torch.Tensor:
        """Letterbox each image on the device; returns the (B, H, W, C) uint8 batch."""
        return torch.stack([self.letterbox(im, device=self.device) for im in imgs])

    def __call__(self, source, stream: bool = False):
        gen = self.stream_inference(source)
        return gen if stream else list(gen)

    def load_images(self, source) -> Iterator:
        """(path, HWC uint8 BGR array) pairs of the source, one frame at a time."""
        yield from load_inference_source(source)

    def predict_files(self, paths, batch: int = 16) -> List[Results]:
        """One Results a file, in order, from batches of `batch` files: decoded
        on the loader's threads, letterboxed as predict does, one device call
        a batch."""
        loader = DataLoader(FileImages([str(p) for p in paths]), batch_size=batch,
                            workers=int(self.args.get("workers", 8) or 1), collate_fn=FileImages.collate)
        results = []
        for b in loader:
            n = len(b["path"]) - b["pad_count"]
            img = self.preprocess(b["orig"])
            out = self.run(img)
            if self.outputs_to_host:
                out = _to_host(out)
            results += self.postprocess(out, tuple(img.shape[1:3]), b["orig"][:n], b["path"][:n])
        return results

    def stream_inference(self, source) -> Iterator[Results]:
        profilers = (Profile(device=self.device), Profile(device=self.device),
                     Profile(device=self.device))
        for path, im0 in self.load_images(source):
            with profilers[0]:
                batch = self.preprocess([im0])
            with profilers[1]:
                out = self.run(batch)
                if self.outputs_to_host:
                    out = _to_host(out)
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
            data = _detections(out, i, int(out["valid"][i].sum()), batch_shape, im0.shape[:2])
            results.append(Results(im0, paths[i], self.model.names, boxes=data.numpy()))
        return results


class FileImages:
    """`predict_files`' dataset: item i is file i's path and its decoded image (`imread`)."""

    def __init__(self, files: List[str]):
        self.files = files

    def __len__(self):
        return len(self.files)

    def __getitem__(self, i: int) -> dict:
        return {"path": self.files[i], "orig": imread(self.files[i])}

    @staticmethod
    def collate(samples) -> dict:
        return {"path": [s["path"] for s in samples], "orig": [s["orig"] for s in samples]}


class DetectionPredictor(BasePredictor):
    """Boxes: the detect heads, TTA on those whose class sets `tta`."""


class SegmentationPredictor(BasePredictor):
    """Boxes and instance masks; `run` adds 'extra' (B, max_det, nm) mask
    coefficients and 'protos' (B, nm, H/4, W/4)."""

    task = "segment"
    outputs_to_host = False

    @torch.no_grad()
    def run(self, img_u8: torch.Tensor) -> Dict[str, torch.Tensor]:
        out, aux = self._run_generic(img_u8)
        out["protos"] = aux["protos"]
        return out

    @torch.no_grad()
    def postprocess(self, out: Dict[str, torch.Tensor], batch_shape, im0s, paths) -> List[Results]:
        """Masks (n, h0, w0) bool in each original image, made on the device
        from the boxes rescaled there; the rest as the detect postprocess."""
        results = []
        counts = out["valid"].sum(1).tolist()
        for i, im0 in enumerate(im0s):
            n = int(counts[i])
            data = _detections(out, i, n, batch_shape, im0.shape[:2])
            masks = None
            if n:
                with full_f32():
                    masks = process_mask_native(out["protos"][i], out["extra"][i][:n], data[:, :4],
                                                im0.shape[:2]) > 0.5
                masks = masks.cpu().numpy()
            results.append(Results(im0, paths[i], self.model.names, boxes=data.cpu().numpy(), masks=masks))
        return results


class ClassificationPredictor(BasePredictor):
    """Class probabilities; `run` returns (B, nc) softmax rows."""

    task = "classify"

    @torch.no_grad()
    def run(self, img_u8: torch.Tensor) -> torch.Tensor:
        with full_f32():
            return self.model(rgb01(img_u8))

    def preprocess(self, imgs: List[np.ndarray]) -> torch.Tensor:
        """Each image resized to an imgsz square on the device; the (B, S, S, C) uint8 batch."""
        size = (self.imgsz, self.imgsz)
        return torch.stack([resize_bilinear(torch.from_numpy(np.ascontiguousarray(im)).to(self.device), size)
                            for im in imgs])

    def postprocess(self, out: torch.Tensor, batch_shape, im0s, paths) -> List[Results]:
        return [Results(im0, paths[i], self.model.names, probs=out[i].numpy()) for i, im0 in enumerate(im0s)]


class PosePredictor(BasePredictor):
    """Boxes and keypoints; `run` adds 'extra' (B, max_det, nk) keypoints,
    decoded in the letterboxed image's pixels."""

    task = "pose"

    @torch.no_grad()
    def run(self, img_u8: torch.Tensor) -> Dict[str, torch.Tensor]:
        return self._run_generic(img_u8)[0]

    def postprocess(self, out: Dict[str, torch.Tensor], batch_shape, im0s, paths) -> List[Results]:
        """Keypoints (n, K, 2|3) in each original image: the letterbox pad taken
        off and the gain divided out, on the host in numpy, as the JAX
        postprocess does (no clipping)."""
        results = []
        for i, im0 in enumerate(im0s):
            n = int(out["valid"][i].sum())
            data = _detections(out, i, n, batch_shape, im0.shape[:2]).numpy()
            kpts = None
            if n:
                k = out["extra"][i][:n].numpy()
                nk = k.shape[-1] // 3 if k.shape[-1] % 3 == 0 else k.shape[-1] // 2
                k = k.reshape(n, nk, k.shape[-1] // nk).copy()
                gain, pad_w, pad_h = letterbox_pad(batch_shape, im0.shape[:2])
                k[..., 0] = (k[..., 0] - pad_w) / gain
                k[..., 1] = (k[..., 1] - pad_h) / gain
                kpts = k
            results.append(Results(im0, paths[i], self.model.names, boxes=data, keypoints=kpts))
        return results


class OBBPredictor(BasePredictor):
    """Oriented boxes; `run` returns the rotated NMS's (B, max_det) 'rboxes'
    xywhr, 'scores', 'cls' and 'valid'. Like the JAX predictor it takes
    neither `classes` nor `agnostic_nms`."""

    task = "obb"

    @torch.no_grad()
    def run(self, img_u8: torch.Tensor) -> Dict[str, torch.Tensor]:
        nc = self.model.nc
        with full_f32():
            y, _ = self.model(rgb01(img_u8))
            rb = torch.cat([y[..., :4], y[..., 4 + nc:5 + nc]], -1)
            return non_max_suppression_rotated(rb, y[..., 4:4 + nc], conf_thres=self.conf, iou_thres=self.iou,
                                               max_det=self.max_det)

    def postprocess(self, out: Dict[str, torch.Tensor], batch_shape, im0s, paths) -> List[Results]:
        """Each image's valid rboxes in its original pixels: the centre
        unpadded and divided by the gain, the sizes divided by it, no clip."""
        results = []
        for i, im0 in enumerate(im0s):
            n = int(out["valid"][i].sum())
            rb = out["rboxes"][i][:n].numpy().copy()
            gain, pad_w, pad_h = letterbox_pad(batch_shape, im0.shape[:2])
            rb[:, 0] = (rb[:, 0] - pad_w) / gain
            rb[:, 1] = (rb[:, 1] - pad_h) / gain
            rb[:, 2:4] /= gain
            data = np.concatenate([rb, out["scores"][i][:n, None].numpy(),
                                   out["cls"][i][:n, None].numpy().astype(np.float32)], 1)
            results.append(Results(im0, paths[i], self.model.names, obb=data))
        return results
