"""Instance-mask ops: prototype combination, box cropping, rescaling.

Counterpart of `ultralytics_pro_tpu/ops/masks.py` (`crop_mask:14`,
`process_mask:28`, `process_mask_native:57`, `scale_masks:68`), on the
tensors' own device. Masks are (N, H, W); prototypes are one image's
(C, H, W), channel-first, where the JAX package's are (H, W, C).

`jax.image.resize(..., "bilinear")` antialiases: where it shrinks an axis
its triangle kernel widens by the factor. `F.interpolate` does so only with
`antialias=True`, which is what `_resize` passes; where an axis grows both
are plain half-pixel bilinear with the edge sample repeated.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _resize(masks: torch.Tensor, shape) -> torch.Tensor:
    """(N, H, W) -> (N, h, w), bilinear as `jax.image.resize` computes it."""
    h, w = int(shape[0]), int(shape[1])
    if not masks.shape[0]:
        return masks.new_zeros((0, h, w))
    return F.interpolate(masks[None], size=(h, w), mode="bilinear", align_corners=False, antialias=True)[0]


def crop_mask(masks: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """Zero each mask outside its xyxy box: (N, H, W), (N, 4) in mask pixels."""
    _, h, w = masks.shape
    x1, y1, x2, y2 = boxes[:, :, None].split(1, 1)  # each (N, 1, 1)
    r = torch.arange(w, dtype=boxes.dtype, device=boxes.device)[None, None, :]
    c = torch.arange(h, dtype=boxes.dtype, device=boxes.device)[None, :, None]
    return masks * ((r >= x1) & (r < x2) & (c >= y1) & (c < y2))


def _combine(protos: torch.Tensor, masks_in: torch.Tensor) -> torch.Tensor:
    """sigmoid(coefficients @ prototypes): (C, mh, mw), (N, C) -> (N, mh, mw)."""
    c, mh, mw = protos.shape
    return (masks_in @ protos.reshape(c, -1)).sigmoid().reshape(-1, mh, mw)


def process_mask(protos: torch.Tensor, masks_in: torch.Tensor, bboxes: torch.Tensor, shape,
                 upsample: bool = False) -> torch.Tensor:
    """Masks on the prototype grid, each cropped by its box scaled to that grid
    with the edges rounded; bilinear to `shape` (h, w) if upsample.

    protos (C, mh, mw), masks_in (N, C), bboxes (N, 4) xyxy in the network
    input's pixels, shape that input's (h, w). The > 0.5 threshold is the
    caller's."""
    _, mh, mw = protos.shape
    ih, iw = shape
    masks = _combine(protos, masks_in)
    wr, hr = mw / iw, mh / ih
    scale = torch.tensor([wr, hr, wr, hr], dtype=bboxes.dtype, device=bboxes.device)
    masks = crop_mask(masks, torch.round(bboxes * scale))
    return _resize(masks, (ih, iw)) if upsample else masks


def process_mask_native(protos: torch.Tensor, masks_in: torch.Tensor, bboxes: torch.Tensor,
                        shape) -> torch.Tensor:
    """Masks scaled to `shape` (the original image's (h, w), letterbox pad
    removed) before the crop by bboxes in that image's pixels."""
    return crop_mask(scale_masks(_combine(protos, masks_in), shape), bboxes)


def scale_masks(masks: torch.Tensor, shape, padding: bool = True) -> torch.Tensor:
    """Rescale (N, H, W) masks to (h, w), cutting the letterbox pad off first."""
    _, mh, mw = masks.shape
    h, w = shape
    gain = min(mh / h, mw / w)
    pad_w = mw - w * gain
    pad_h = mh - h * gain
    if padding:
        top = int(round(pad_h / 2 - 0.1))
        left = int(round(pad_w / 2 - 0.1))
        bottom = mh - int(round(pad_h / 2 + 0.1))
        right = mw - int(round(pad_w / 2 + 0.1))
        masks = masks[:, top:bottom, left:right]
    return _resize(masks, (h, w))
