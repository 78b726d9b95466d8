"""Box coordinate conversions and rescaling, on tensors.

Counterpart of `ultralytics_pro_tpu/ops/boxes.py` (`xywh2xyxy:19`,
`clip_boxes:74`, `scale_boxes:85`, `xywhr2xyxyxyxy:109`), with the same
operation order so results agree to the last bit on the CPU. Boxes are
(..., 4) or wider; rotated boxes are (..., 5) xywhr, the angle in radians.
"""

from __future__ import annotations

import numpy as np
import torch


def xywh2xyxy(x: torch.Tensor) -> torch.Tensor:
    """(cx, cy, w, h) -> (x1, y1, x2, y2)."""
    cx, cy, w, h = x.unbind(-1)
    hw, hh = w * 0.5, h * 0.5
    return torch.stack([cx - hw, cy - hh, cx + hw, cy + hh], -1)


def clip_boxes(boxes: torch.Tensor, shape) -> torch.Tensor:
    """Clip xyxy boxes to an image shape (h, w); extra columns pass through."""
    h, w = shape[0], shape[1]
    out = boxes.clone()
    out[..., 0].clamp_(0, w)
    out[..., 1].clamp_(0, h)
    out[..., 2].clamp_(0, w)
    out[..., 3].clamp_(0, h)
    return out


def scale_boxes(img1_shape, boxes: torch.Tensor, img0_shape, ratio_pad=None,
                padding: bool = True, xywh: bool = False) -> torch.Tensor:
    """Rescale boxes from the letterboxed `img1_shape` (h, w) back to `img0_shape`.

    gain = min(h1/h0, w1/w0); the pad uses the round(x/2 - 0.1) convention of
    LetterBox so pixel outputs line up.
    """
    if ratio_pad is None:
        gain = min(img1_shape[0] / img0_shape[0], img1_shape[1] / img0_shape[1])
        pad_w = round((img1_shape[1] - img0_shape[1] * gain) / 2 - 0.1)
        pad_h = round((img1_shape[0] - img0_shape[0] * gain) / 2 - 0.1)
    else:
        gain = ratio_pad[0][0]
        pad_w, pad_h = ratio_pad[1]
    boxes = boxes.clone()
    if padding:
        sub = torch.tensor([pad_w, pad_h, 0 if xywh else pad_w, 0 if xywh else pad_h],
                           dtype=boxes.dtype, device=boxes.device)
        boxes[..., :4] -= sub
    boxes[..., :4] *= 1.0 / gain
    if not xywh:
        boxes = clip_boxes(boxes, img0_shape)
    return boxes


def xywhr2xyxyxyxy(x):
    """Rotated (cx, cy, w, h, rad) -> the 4 corners (..., 4, 2): centre plus
    and minus the half-width and half-height vectors. A numpy array in gives
    a numpy array out."""
    if isinstance(x, np.ndarray):
        return xywhr2xyxyxyxy(torch.from_numpy(x)).numpy()
    ctr = x[..., :2]
    w, h, angle = x[..., 2:3], x[..., 3:4], x[..., 4:5]
    cos, sin = torch.cos(angle), torch.sin(angle)
    vec1 = torch.cat([w / 2 * cos, w / 2 * sin], -1)
    vec2 = torch.cat([-h / 2 * sin, h / 2 * cos], -1)
    return torch.stack([ctr + vec1 + vec2, ctr + vec1 - vec2, ctr - vec1 - vec2, ctr - vec1 + vec2], -2)
