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

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F


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

    def __call__(self, image, device=None):
        """image: HWC uint8 numpy array or tensor -> the letterboxed HWC uint8
        tensor on `device` (default: the image's own device); or a label dict,
        see `letterbox_labels`."""
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
    """Apply transforms in order to a label dict."""

    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, labels):
        for t in self.transforms:
            labels = t(labels)
        return labels

    def __repr__(self):
        return f"Compose({[t.__class__.__name__ for t in self.transforms]})"
