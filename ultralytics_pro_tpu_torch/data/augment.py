"""Letterbox and the long-side resizes, in torch and numpy.

Counterparts of `ultralytics_pro_tpu/data/augment.py` (`LetterBox:27`,
`Compose:424`, `classify_transforms:554`) and of the two `cv2.resize` calls
of the val path:

- `resize_bilinear` is `cv2.resize(..., INTER_LINEAR)` (`augment.py:68`,
  and `dataset.py:327` when an image grows): `F.interpolate` bilinear with
  align_corners=False and no antialias samples as cv2 does; cv2 interpolates
  uint8 in fixed point, so pixels may differ by one grey level.
- `resize_area` is `cv2.resize(..., INTER_AREA)` for shrinking
  (`dataset.py:327`), at any factor: one weight matrix per axis holds each
  output pixel's fractional input span, as cv2's resizeArea weighs it, the
  sums are taken in f32 and rounded half to even and saturated as
  `saturate_cast<uchar>` does. cv2 sums in another order (and averages
  integer factors in integers), so pixels may differ by one grey level.

`LetterBox` pads centred with the rounding of `augment.py:48-71`. Called on
an image it returns the letterboxed HWC uint8 tensor (the predictor's form);
called on a label dict it letterboxes `img` (a numpy array), shifts and
scales `bboxes` (pixel xyxy, or rotated xywhr: all four of cx, cy, w, h
scaled, the centre alone shifted), `keypoints` (invisible ones stay at 0)
and `segments`, and composes `ratio_pad`, as `:88-117` does.
"""

from __future__ import annotations

import math
import random
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ultralytics_pro_tpu_torch.data import imgproc
from ultralytics_pro_tpu_torch.utils.metrics import box_iou_np


def resize_bilinear(img, size) -> torch.Tensor:
    """HWC uint8 (numpy array or tensor) -> HWC uint8 tensor of size (w, h),
    on the input's device."""
    x = torch.from_numpy(np.ascontiguousarray(img)) if isinstance(img, np.ndarray) else img
    w, h = size
    y = F.interpolate(x.permute(2, 0, 1)[None].float(), size=(h, w), mode="bilinear",
                      align_corners=False, antialias=False)
    return y[0].permute(1, 2, 0).round().clamp(0, 255).to(x.dtype)


def _area_weights(src: int, dst: int) -> np.ndarray:
    """(dst, src) f32 weights: output pixel d averages input span
    [d * s, (d + 1) * s), s = src / dst, with cv2's computeResizeAreaTab
    edges (a part below 1e-3 pixel is dropped)."""
    scale = src / dst
    wts = np.zeros((dst, src), np.float64)
    for d in range(dst):
        f1 = d * scale
        f2 = f1 + scale
        cell = min(scale, src - f1)
        s1, s2 = int(np.ceil(f1)), int(np.floor(f2))
        s2 = min(s2, src - 1)
        s1 = min(s1, s2)
        if s1 - f1 > 1e-3:
            wts[d, s1 - 1] = np.float32((s1 - f1) / cell)
        wts[d, s1:s2] = np.float32(1.0 / cell)
        if f2 - s2 > 1e-3:
            wts[d, s2] = np.float32(min(min(f2 - s2, 1.0), cell) / cell)
    return wts.astype(np.float32)


def resize_area(img: np.ndarray, size) -> np.ndarray:
    """Shrink an HWC (or HW) uint8 image to size (w, h) by area averaging."""
    h0, w0 = img.shape[:2]
    w, h = size
    if w > w0 or h > h0:
        raise ValueError(f"resize_area shrinks: {w0}x{h0} -> {w}x{h} grows an axis")
    wy, wx = torch.from_numpy(_area_weights(h0, h)), torch.from_numpy(_area_weights(w0, w))
    x = torch.from_numpy(np.ascontiguousarray(img)).float()
    rows = x.reshape(h0, w0, -1).permute(2, 0, 1)  # (C, H0, W0)
    out = wy @ (rows @ wx.T)  # (C, h, w), f32
    out = out.round().clamp(0, 255).to(torch.uint8).permute(1, 2, 0)
    return out.reshape((h, w) + img.shape[2:]).numpy()


def classify_transforms(size: int = 224):
    """The classify val pipeline: resize the short side to `size` (the other
    side to Python's `round` of its scaled length) with `resize_bilinear`,
    then crop the centre `size` x `size`. HWC uint8 numpy in and out."""

    def tf(im: np.ndarray) -> np.ndarray:
        h, w = im.shape[:2]
        r = size / min(h, w)
        new = (round(w * r), round(h * r))
        if new != (w, h):
            im = resize_bilinear(im, new).numpy()
        h, w = im.shape[:2]
        y0, x0 = (h - size) // 2, (w - size) // 2
        return im[y0:y0 + size, x0:x0 + size]

    return tf


class LetterBox:
    """Aspect-preserving resize + centred constant pad to `new_shape` (h, w)."""

    def __init__(self, new_shape=(640, 640), scaleup: bool = True, padding_value: int = 114):
        self.new_shape = (new_shape, new_shape) if isinstance(new_shape, int) else new_shape
        self.scaleup = scaleup
        self.padding_value = padding_value

    def _geometry(self, shape, new_shape=None):
        """(ratio, (w, h) after the resize, (top, bottom, left, right) pads) for
        an (h, w) image into new_shape (h, w), the letterbox's own by default."""
        new_shape = new_shape or self.new_shape
        r = min(new_shape[0] / shape[0], new_shape[1] / shape[1])
        if not self.scaleup:
            r = min(r, 1.0)
        new_unpad = (round(shape[1] * r), round(shape[0] * r))  # (w, h)
        dw, dh = (new_shape[1] - new_unpad[0]) / 2, (new_shape[0] - new_unpad[1]) / 2
        pads = (int(round(dh - 0.1)), int(round(dh + 0.1)), int(round(dw - 0.1)), int(round(dw + 0.1)))
        return r, new_unpad, pads

    def _pad(self, img: torch.Tensor, pads) -> torch.Tensor:
        top, bottom, left, right = pads
        h, w, c = img.shape
        out = torch.full((h + top + bottom, w + left + right, c), self.padding_value,
                         dtype=img.dtype, device=img.device)
        out[top:top + h, left:left + w] = img
        return out

    def __call__(self, image, rng=None, nprng=None, device=None):
        """image: HWC uint8 numpy array or tensor -> the letterboxed HWC uint8
        tensor on `device` (default: the image's own device); or a label dict,
        see `letterbox_labels`. It draws nothing: `rng` and `nprng` are the
        generators every transform of a `Compose` is given."""
        if isinstance(image, dict):
            return self.letterbox_labels(image)
        img = torch.from_numpy(np.ascontiguousarray(image)) if isinstance(image, np.ndarray) else image
        if device is not None:
            img = img.to(device)
        shape = tuple(img.shape[:2])  # h, w
        _, new_unpad, pads = self._geometry(shape)
        if shape[::-1] != new_unpad:
            img = resize_bilinear(img, new_unpad)
        return self._pad(img, pads)

    def letterbox_labels(self, labels: Dict) -> Dict:
        """The label-dict form (augment.py:41-119): `img` (HWC uint8 numpy)
        letterboxed, `bboxes` (n, 4) pixel xyxy or (n, 5) xywhr, `keypoints`
        (n, K, 2|3) and `segments` (a list of (k, 2)) scaled and shifted,
        `ratio_pad` ((gain_h, gain_w), (left, top)) composed with the
        dataset's pre-resize gain, `resized_shape` the letterboxed (h, w). A
        `rect_shape` (h, w) in labels (the rect batch's) is popped and taken
        in place of the letterbox's own shape."""
        img = labels["img"]
        shape = img.shape[:2]
        r, new_unpad, pads = self._geometry(shape, labels.pop("rect_shape", None))
        if shape[::-1] != new_unpad or any(pads):  # else (a warped mosaic) the image is already in place
            x = torch.from_numpy(np.ascontiguousarray(img))
            if shape[::-1] != new_unpad:
                x = resize_bilinear(x, new_unpad)
            img = self._pad(x, pads).numpy()
        top, _, left, _ = pads
        labels["img"] = img
        pre = labels.get("ratio_pad")
        if isinstance(pre, tuple) and len(pre) == 2 and not isinstance(pre[0], tuple):
            labels["ratio_pad"] = ((pre[0] * r, pre[1] * r), (left, top))
        else:
            labels["ratio_pad"] = ((r, r), (left, top))
        if "bboxes" in labels and len(labels["bboxes"]):
            b = labels["bboxes"].copy()
            if b.shape[1] == 5:  # rotated xywhr: scale the sizes too, shift the centre only
                b[:, :4] *= r
                b[:, 0] += left
                b[:, 1] += top
            else:
                b = b * r
                b[:, [0, 2]] += left
                b[:, [1, 3]] += top
            labels["bboxes"] = b
        if labels.get("keypoints") is not None and len(labels["keypoints"]):
            k = labels["keypoints"].copy()
            k[..., 0] = k[..., 0] * r + left
            k[..., 1] = k[..., 1] * r + top
            if k.shape[-1] == 3:  # invisible points stay at 0
                k[..., :2] = np.where(k[..., 2:3] > 0, k[..., :2], 0.0)
            labels["keypoints"] = k
        if labels.get("segments") is not None:
            labels["segments"] = [s * r + np.array([left, top], np.float32) for s in labels["segments"]]
        labels["resized_shape"] = img.shape[:2]
        return labels


class Compose:
    """Apply transforms in order to a label dict, each given the sample's
    generators: `t(labels, rng, nprng)`."""

    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, labels, rng: Optional[random.Random] = None, nprng: Optional[np.random.RandomState] = None):
        for t in self.transforms:
            labels = t(labels, rng, nprng)
        return labels

    def __repr__(self):
        return f"Compose({[t.__class__.__name__ for t in self.transforms]})"


# -- train augmentations -------------------------------------------------------
# Each takes the sample's generators, a random.Random and a np.random.RandomState,
# and draws from them what the JAX transform draws from the process-wide
# streams: the same calls, in the same order, so seeding both alike gives the
# same sample (tests/test_torch_augment.py).


class RandomHSV:
    """HSV jitter through uint8 look-up tables (`augment.py:RandomHSV:122`);
    images of other than 3 channels pass unchanged."""

    def __init__(self, hgain=0.5, sgain=0.5, vgain=0.5):
        self.hgain, self.sgain, self.vgain = hgain, sgain, vgain

    def __call__(self, labels, rng, nprng):
        img = labels["img"]
        if img.ndim == 3 and img.shape[2] != 3:
            return labels
        if self.hgain or self.sgain or self.vgain:
            r = nprng.uniform(-1, 1, 3) * [self.hgain, self.sgain, self.vgain] + 1
            hsv = imgproc.bgr2hsv(img)
            x = np.arange(0, 256, dtype=r.dtype)
            tables = (((x * r[0]) % 180).astype(img.dtype), np.clip(x * r[1], 0, 255).astype(img.dtype),
                      np.clip(x * r[2], 0, 255).astype(img.dtype))
            hsv = np.stack([imgproc.lut(hsv[..., k], t) for k, t in enumerate(tables)], -1)
            labels["img"] = imgproc.hsv2bgr(hsv)
        return labels


class RandomFlip:
    """Left-right or up-down flip with probability p (`augment.py:RandomFlip:146`):
    xyxy or rotated xywhr boxes, keypoints (invisible ones kept at 0, the
    left-right pairs swapped by `flip_idx`) and segments follow."""

    def __init__(self, p=0.5, direction="horizontal", flip_idx=None):
        self.p, self.direction, self.flip_idx = p, direction, flip_idx

    def __call__(self, labels, rng, nprng):
        if rng.random() >= self.p:
            return labels
        img = labels["img"]
        h, w = img.shape[:2]
        boxes = labels.get("bboxes")
        rotated = boxes is not None and len(boxes) and boxes.shape[1] == 5
        horizontal = self.direction == "horizontal"
        labels["img"] = np.fliplr(img) if horizontal else np.flipud(img)
        i, size = (0, w) if horizontal else (1, h)
        if boxes is not None and len(boxes):
            if rotated:
                boxes[:, i] = size - boxes[:, i]
                boxes[:, 4] = -boxes[:, 4]
            else:
                lo = boxes[:, i].copy()
                boxes[:, i] = size - boxes[:, i + 2]
                boxes[:, i + 2] = size - lo
        if horizontal and labels.get("keypoints") is not None and len(labels["keypoints"]):
            k = labels["keypoints"]
            k[..., 0] = w - k[..., 0]
            if k.shape[-1] == 3:
                k[..., :2] = np.where(k[..., 2:3] > 0, k[..., :2], 0.0)
            labels["keypoints"] = k[:, self.flip_idx] if self.flip_idx is not None else k
        if labels.get("segments") is not None:
            labels["segments"] = [np.stack([w - s[:, 0], s[:, 1]], 1) if horizontal else
                                  np.stack([s[:, 0], h - s[:, 1]], 1) for s in labels["segments"]]
        return labels


class RandomPerspective:
    """Random rotation, scale, shear, perspective and translation of the image
    and its xyxy boxes (`augment.py:RandomPerspective:198`), through
    `imgproc.warp_affine` (or `warp_perspective`) with a border of 114;
    more than 4 channels are warped 4 at a time, as there. Boxes are the
    bounding boxes of their warped corners, clipped, and kept by
    `box_candidates`."""

    def __init__(self, degrees=0.0, translate=0.1, scale=0.5, shear=0.0, perspective=0.0, border=(0, 0)):
        self.degrees, self.translate, self.scale = degrees, translate, scale
        self.shear, self.perspective, self.border = shear, perspective, border

    def affine_transform(self, img, border, rng: random.Random):
        h, w = img.shape[:2]
        C = np.eye(3)
        C[0, 2], C[1, 2] = -w / 2, -h / 2
        P = np.eye(3)
        P[2, 0] = rng.uniform(-self.perspective, self.perspective)
        P[2, 1] = rng.uniform(-self.perspective, self.perspective)
        R = np.eye(3)
        a = rng.uniform(-self.degrees, self.degrees)
        s = rng.uniform(1 - self.scale, 1 + self.scale)
        R[:2] = imgproc.rotation_matrix_2d((0, 0), a, s)
        S = np.eye(3)
        S[0, 1] = math.tan(rng.uniform(-self.shear, self.shear) * math.pi / 180)
        S[1, 0] = math.tan(rng.uniform(-self.shear, self.shear) * math.pi / 180)
        T = np.eye(3)
        size = (w + border[1] * 2, h + border[0] * 2)
        T[0, 2] = rng.uniform(0.5 - self.translate, 0.5 + self.translate) * size[0]
        T[1, 2] = rng.uniform(0.5 - self.translate, 0.5 + self.translate) * size[1]
        M = T @ S @ R @ P @ C
        if border[0] != 0 or border[1] != 0 or (M != np.eye(3)).any():
            warp = ((lambda im: imgproc.warp_perspective(im, M, size, 114)) if self.perspective else
                    (lambda im: imgproc.warp_affine(im, M[:2], size, 114)))
            if img.ndim == 3 and img.shape[2] > 4:
                img = np.concatenate([imgproc.as_hwc(warp(np.ascontiguousarray(img[:, :, i:i + 4])))
                                      for i in range(0, img.shape[2], 4)], axis=2)
            else:
                img = warp(img)
        return img, M, s

    def apply_bboxes(self, bboxes, M):
        n = len(bboxes)
        if n == 0:
            return bboxes
        xy = np.ones((n * 4, 3))
        xy[:, :2] = bboxes[:, [0, 1, 2, 3, 0, 3, 2, 1]].reshape(n * 4, 2)  # corners
        xy = xy @ M.T
        xy = (xy[:, :2] / xy[:, 2:3] if self.perspective else xy[:, :2]).reshape(n, 8)
        x, y = xy[:, [0, 2, 4, 6]], xy[:, [1, 3, 5, 7]]
        return np.stack([x.min(1), y.min(1), x.max(1), y.max(1)], axis=1)

    @staticmethod
    def box_candidates(box1, box2, wh_thr=2, ar_thr=100, area_thr=0.1, eps=1e-16):
        """Boxes that keep over 2 px a side, area_thr of their area and an
        aspect ratio under ar_thr after the warp."""
        w1, h1 = box1[:, 2] - box1[:, 0], box1[:, 3] - box1[:, 1]
        w2, h2 = box2[:, 2] - box2[:, 0], box2[:, 3] - box2[:, 1]
        ar = np.maximum(w2 / (h2 + eps), h2 / (w2 + eps))
        return (w2 > wh_thr) & (h2 > wh_thr) & (w2 * h2 / (w1 * h1 + eps) > area_thr) & (ar < ar_thr)

    def __call__(self, labels, rng, nprng):
        border = labels.pop("mosaic_border", self.border)
        img, M, scale = self.affine_transform(labels["img"], border, rng)
        h, w = img.shape[:2]
        bboxes = labels.get("bboxes", np.zeros((0, 4)))
        new_boxes = self.apply_bboxes(bboxes, M)
        if len(bboxes):
            clipped = new_boxes.copy()
            clipped[:, [0, 2]] = clipped[:, [0, 2]].clip(0, w)
            clipped[:, [1, 3]] = clipped[:, [1, 3]].clip(0, h)
            keep = self.box_candidates(bboxes * scale, clipped, area_thr=0.1)
            labels["bboxes"] = clipped[keep]
            labels["cls"] = labels["cls"][keep]
        labels["img"] = img
        return labels


class Mosaic:
    """Four images around a random centre on a (2 imgsz)^2 canvas of 114
    (`augment.py:Mosaic:283`, `_mosaic4:298`), with probability p: the
    sample and three drawn from the dataset (`get_image_and_label`); boxes
    and classes only, as there, with `mosaic_border` for the warp after it."""

    def __init__(self, dataset, imgsz=640, p=1.0, n=4):
        self.dataset, self.imgsz, self.p, self.n = dataset, imgsz, p, n
        self.border = (-imgsz // 2, -imgsz // 2)

    def __call__(self, labels, rng, nprng):
        if rng.random() >= self.p:
            return labels
        indices = [rng.randint(0, len(self.dataset) - 1) for _ in range(self.n - 1)]
        return self._mosaic4([labels] + [self.dataset.get_image_and_label(i) for i in indices], rng)

    def _mosaic4(self, mix: List[Dict], rng: random.Random):
        s = self.imgsz
        yc, xc = (int(rng.uniform(-x, 2 * s + x)) for x in self.border)
        c0 = mix[0]["img"].shape[2] if mix[0]["img"].ndim == 3 else 3
        img4 = np.full((s * 2, s * 2, c0), 114, dtype=np.uint8)
        cls4, boxes4 = [], []
        for i, labels in enumerate(mix):
            img = labels["img"]
            h, w = img.shape[:2]
            if i == 0:  # top left
                x1a, y1a, x2a, y2a = max(xc - w, 0), max(yc - h, 0), xc, yc
                x1b, y1b, x2b, y2b = w - (x2a - x1a), h - (y2a - y1a), w, h
            elif i == 1:  # top right
                x1a, y1a, x2a, y2a = xc, max(yc - h, 0), min(xc + w, s * 2), yc
                x1b, y1b, x2b, y2b = 0, h - (y2a - y1a), min(w, x2a - x1a), h
            elif i == 2:  # bottom left
                x1a, y1a, x2a, y2a = max(xc - w, 0), yc, xc, min(s * 2, yc + h)
                x1b, y1b, x2b, y2b = w - (x2a - x1a), 0, w, min(y2a - y1a, h)
            else:  # bottom right
                x1a, y1a, x2a, y2a = xc, yc, min(xc + w, s * 2), min(s * 2, yc + h)
                x1b, y1b, x2b, y2b = 0, 0, min(w, x2a - x1a), min(y2a - y1a, h)
            img4[y1a:y2a, x1a:x2a] = img[y1b:y2b, x1b:x2b]
            if len(labels.get("bboxes", [])):
                b = labels["bboxes"].copy()
                b[:, [0, 2]] += x1a - x1b
                b[:, [1, 3]] += y1a - y1b
                boxes4.append(b)
                cls4.append(labels["cls"])
        out = {"img": img4, "cls": np.concatenate(cls4) if cls4 else np.zeros((0,)),
               "bboxes": np.concatenate(boxes4) if boxes4 else np.zeros((0, 4)), "mosaic_border": self.border}
        if len(out["bboxes"]):
            out["bboxes"][:, [0, 2]] = out["bboxes"][:, [0, 2]].clip(0, 2 * s)
            out["bboxes"][:, [1, 3]] = out["bboxes"][:, [1, 3]].clip(0, 2 * s)
        return out


class MixUp:
    """Blend with another sample at a Beta(32, 32) ratio, with probability p
    (`augment.py:MixUp:342`); the labels of both are kept. The other sample
    is loaded, not warped, so the two images must have one shape (a set of
    square images), or it raises, as the JAX transform does."""

    def __init__(self, dataset, p=0.0):
        self.dataset, self.p = dataset, p

    def __call__(self, labels, rng, nprng):
        if rng.random() >= self.p:
            return labels
        other = self.dataset.get_image_and_label(rng.randint(0, len(self.dataset) - 1))
        r = nprng.beta(32.0, 32.0)
        if other["img"].shape != labels["img"].shape:
            raise ValueError(f"MixUp blends images of one shape, not {labels['img'].shape} and "
                             f"{other['img'].shape}; the JAX transform fails here too (ROADMAP.md section 3)")
        labels["img"] = (labels["img"] * r + other["img"] * (1 - r)).astype(np.uint8)
        labels["cls"] = np.concatenate([labels["cls"], other["cls"]], 0)
        labels["bboxes"] = np.concatenate([labels["bboxes"], other["bboxes"]], 0)
        return labels


class CutMix:
    """Paste the same region of another sample's image, with probability p
    (`augment.py:CutMix:361`); labels unchanged, as there. A region reaching
    past the other image raises, as the JAX transform's assignment does."""

    def __init__(self, dataset, p=0.0, beta=1.0, num_areas=3):
        self.dataset, self.p, self.beta, self.num_areas = dataset, p, beta, num_areas

    def __call__(self, labels, rng, nprng):
        if rng.random() >= self.p:
            return labels
        other = self.dataset.get_image_and_label(rng.randint(0, len(self.dataset) - 1))
        h, w = labels["img"].shape[:2]
        cut_ratio = np.sqrt(1 - nprng.beta(self.beta, self.beta))
        cut_w, cut_h = int(w * cut_ratio), int(h * cut_ratio)
        cx, cy = rng.randint(0, w - 1), rng.randint(0, h - 1)
        x1, y1 = max(cx - cut_w // 2, 0), max(cy - cut_h // 2, 0)
        x2, y2 = min(cx + cut_w // 2, w), min(cy + cut_h // 2, h)
        oh, ow = other["img"].shape[:2]
        if x2 > x1 and y2 > y1 and (y2 - y1) <= oh and (x2 - x1) <= ow:
            part = other["img"][y1:y2, x1:x2]
            if part.shape[0] not in (1, y2 - y1) or part.shape[1] not in (1, x2 - x1):
                raise ValueError(f"CutMix: region {(x1, y1, x2, y2)} passes the other image ({ow} x {oh}); the "
                                 "JAX transform fails here too (ROADMAP.md section 3)")
            labels["img"][y1:y2, x1:x2] = part
        return labels


class CopyPaste:
    """Box-level flip-paste with probability p (`augment.py:CopyPaste:387`):
    each box whose left-right mirror overlaps no box at IoU 0.3 or more is
    a candidate, the first half of them (at least one) pasted at their
    mirror with their classes."""

    def __init__(self, dataset=None, p=0.0):
        self.dataset, self.p = dataset, p

    def __call__(self, labels, rng, nprng):
        if rng.random() >= self.p or not len(labels.get("bboxes", [])):
            return labels
        img = labels["img"]
        w = img.shape[1]
        boxes = labels["bboxes"]
        flipped = boxes.copy()
        flipped[:, [0, 2]] = w - boxes[:, [2, 0]]
        idx = np.nonzero((box_iou_np(flipped, boxes) < 0.30).all(1))[0]
        sel = idx[: max(1, len(idx) // 2)] if len(idx) else idx
        for j in sel:
            x1, y1, x2, y2 = boxes[j].astype(int)
            fx1, fy1, fx2, fy2 = flipped[j].astype(int)
            ph, pw = min(y2 - y1, fy2 - fy1), min(x2 - x1, fx2 - fx1)
            if ph > 0 and pw > 0:
                img[fy1:fy1 + ph, fx1:fx1 + pw] = img[y1:y1 + ph, x1:x1 + pw]
        if len(sel):
            labels["cls"] = np.concatenate([labels["cls"], labels["cls"][sel]], 0)
            labels["bboxes"] = np.concatenate([boxes, flipped[sel]], 0)
        labels["img"] = img
        return labels


def v8_transforms(dataset, imgsz: int, hyp: Dict) -> Compose:
    """The detect train pipeline (`augment.py:v8_transforms:436`): Mosaic,
    CopyPaste, RandomPerspective, MixUp, CutMix, RandomHSV, the up-down and
    the left-right flip, with the `hyp` gains (the defaults where a key is
    missing)."""
    return Compose([
        Mosaic(dataset, imgsz=imgsz, p=hyp.get("mosaic", 1.0)),
        CopyPaste(dataset, p=hyp.get("copy_paste", 0.0)),
        RandomPerspective(degrees=hyp.get("degrees", 0.0), translate=hyp.get("translate", 0.1),
                          scale=hyp.get("scale", 0.5), shear=hyp.get("shear", 0.0),
                          perspective=hyp.get("perspective", 0.0)),
        MixUp(dataset, p=hyp.get("mixup", 0.0)),
        CutMix(dataset, p=hyp.get("cutmix", 0.0)),
        RandomHSV(hyp.get("hsv_h", 0.015), hyp.get("hsv_s", 0.7), hyp.get("hsv_v", 0.4)),
        RandomFlip(p=hyp.get("flipud", 0.0), direction="vertical"),
        RandomFlip(p=hyp.get("fliplr", 0.5), direction="horizontal", flip_idx=getattr(dataset, "flip_idx", None)),
    ])


# -- classify augmentations (augment.py:466-597) --------------------------------
def _ra_autocontrast(im, mag, rng):
    lo, hi = im.min(axis=(0, 1), keepdims=True), im.max(axis=(0, 1), keepdims=True)
    span = np.maximum(hi - lo, 1)
    return ((im.astype(np.float32) - lo) * (255.0 / span)).clip(0, 255).astype(np.uint8)


def _ra_equalize(im, mag, rng):
    ycc = imgproc.bgr2ycrcb(im)
    ycc[..., 0] = imgproc.equalize_hist(ycc[..., 0])
    return imgproc.ycrcb2bgr(ycc)


def _ra_rotate(im, mag, rng):
    h, w = im.shape[:2]
    deg = (mag / 10.0) * 30.0 * rng.choice((-1, 1))
    return imgproc.warp_affine(im, imgproc.rotation_matrix_2d((w / 2, h / 2), deg, 1.0), (w, h), (128, 128, 128))


def _ra_posterize(im, mag, rng):
    bits = max(8 - int(mag / 10.0 * 4), 4)
    return (im >> (8 - bits)) << (8 - bits)


def _ra_solarize(im, mag, rng):
    thr = 255 - int(mag / 10.0 * 110)
    return np.where(im < thr, im, 255 - im).astype(np.uint8)


def _ra_contrast(im, mag, rng):
    f = 1.0 + (mag / 10.0) * 0.9 * rng.choice((-1, 1))
    mean = im.mean()
    return (mean + (im.astype(np.float32) - mean) * f).clip(0, 255).astype(np.uint8)


def _ra_brightness(im, mag, rng):
    f = 1.0 + (mag / 10.0) * 0.9 * rng.choice((-1, 1))
    return (im.astype(np.float32) * f).clip(0, 255).astype(np.uint8)


def _ra_sharpness(im, mag, rng):
    f = (mag / 10.0) * 0.9 * rng.choice((-1, 1))
    blur = imgproc.gaussian_blur3(im)
    return (im.astype(np.float32) * (1 + f) - blur.astype(np.float32) * f).clip(0, 255).astype(np.uint8)


RANDAUG_OPS = (_ra_autocontrast, _ra_equalize, _ra_rotate, _ra_posterize, _ra_solarize, _ra_contrast,
               _ra_brightness, _ra_sharpness)


class RandAugment:
    """`num_ops` ops drawn with replacement from the eight, at one magnitude
    (`augment.py:RandAugment:510`)."""

    def __init__(self, num_ops: int = 2, magnitude: int = 9):
        self.num_ops, self.magnitude = num_ops, magnitude

    def __call__(self, im, rng: random.Random):
        for op in rng.choices(RANDAUG_OPS, k=self.num_ops):
            im = op(im, self.magnitude, rng)
        return im


class RandomErasing:
    """With probability p, one rectangle of uint8 noise, its area and aspect
    ratio drawn up to 10 times until it fits (`augment.py:RandomErasing:530`)."""

    def __init__(self, p: float = 0.4, scale=(0.02, 0.33), ratio=(0.3, 3.3)):
        self.p, self.scale, self.ratio = p, scale, ratio

    def __call__(self, im, rng: random.Random, nprng: np.random.RandomState):
        if rng.random() >= self.p:
            return im
        h, w = im.shape[:2]
        for _ in range(10):
            area = rng.uniform(*self.scale) * h * w
            ar = math.exp(rng.uniform(math.log(self.ratio[0]), math.log(self.ratio[1])))
            eh, ew = int(round(math.sqrt(area * ar))), int(round(math.sqrt(area / ar)))
            if eh < h and ew < w:
                y0, x0 = rng.randint(0, h - eh), rng.randint(0, w - ew)
                im = im.copy()
                im[y0:y0 + eh, x0:x0 + ew] = nprng.randint(0, 256, (eh, ew, im.shape[2]), np.uint8)
                return im
        return im


def classify_augmentations(size: int = 224, scale=(0.08, 1.0), hflip: float = 0.5,
                           auto_augment: str = "randaugment", erasing: float = 0.0):
    """The classify train pipeline (`augment.py:classify_augmentations:569`):
    a random crop of area `scale` and aspect ratio in [3/4, 4/3] (10 draws,
    else the whole image) resized to size x size (`imgproc.resize_linear`),
    the left-right flip, RandAugment and RandomErasing. Returns
    tf(im, rng, nprng)."""
    ra = RandAugment() if auto_augment == "randaugment" else None
    re_ = RandomErasing(erasing) if erasing > 0 else None

    def tf(im: np.ndarray, rng: random.Random, nprng: np.random.RandomState) -> np.ndarray:
        h, w = im.shape[:2]
        crop = im
        for _ in range(10):
            area = rng.uniform(*scale) * h * w
            ar = math.exp(rng.uniform(math.log(3 / 4), math.log(4 / 3)))
            ch, cw = int(round(math.sqrt(area / ar))), int(round(math.sqrt(area * ar)))
            if ch <= h and cw <= w:
                y0, x0 = rng.randint(0, h - ch), rng.randint(0, w - cw)
                crop = im[y0:y0 + ch, x0:x0 + cw]
                break
        out = imgproc.resize_linear(np.ascontiguousarray(crop), (size, size))
        if rng.random() < hflip:
            out = np.fliplr(out).copy()
        if ra is not None:
            out = ra(out, rng)
        if re_ is not None:
            out = re_(out, rng, nprng)
        return out

    return tf
