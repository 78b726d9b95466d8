"""Prediction results, numpy-backed: boxes, instance masks, keypoints,
oriented boxes and class probabilities.

Counterpart of `ultralytics_pro_tpu/engine/results.py` (`BaseTensor:23`,
`Boxes:41`, `Masks:82`, `Keypoints:103`, `Probs:120`, `OBB:140`, `Results:167`)
for detect, segment, pose, obb and classify: the same accessors
(.xyxy/.xywh/.xyxyn/.xywhn/.conf/.cls, the keypoints' .xy/.xyn/.conf, the
oriented boxes' .xywhr/.xyxyxyxy/.xyxy, the probabilities'
.top1/.top5/.top1conf/.top5conf, len and indexing). `Probs.top5` orders by a
stable descending sort, ties to the lower class, where the JAX one reverses
an ascending argsort (ties to the higher). `Masks.xy` (polygon contours,
`cv2.findContours`) raises NotImplementedError, and drawing and saving need
OpenCV too; they wait for a later slice.
"""

from __future__ import annotations

import numpy as np

from ultralytics_pro_tpu_torch.ops.boxes import xywhr2xyxyxyxy
from ultralytics_pro_tpu_torch.utils import SimpleClass


class BaseTensor(SimpleClass):
    """A numpy array with the reference's .cpu()/.numpy() surface."""

    def __init__(self, data, orig_shape):
        self.data = np.asarray(data)
        self.orig_shape = orig_shape

    def cpu(self):
        return self

    def numpy(self):
        return self.data

    def __len__(self):
        return len(self.data)

    def __getitem__(self, idx):
        return self.__class__(self.data[idx], self.orig_shape)


class Boxes(BaseTensor):
    """Detection boxes: data (n, 6) = x1, y1, x2, y2, conf, cls."""

    @property
    def xyxy(self):
        return self.data[:, :4]

    @property
    def conf(self):
        return self.data[:, -2]

    @property
    def cls(self):
        return self.data[:, -1]

    @property
    def xywh(self):
        x = self.xyxy
        return np.stack([(x[:, 0] + x[:, 2]) / 2, (x[:, 1] + x[:, 3]) / 2,
                         x[:, 2] - x[:, 0], x[:, 3] - x[:, 1]], 1)

    @property
    def xyxyn(self):
        h, w = self.orig_shape
        return self.xyxy / np.array([w, h, w, h])

    @property
    def xywhn(self):
        h, w = self.orig_shape
        return self.xywh / np.array([w, h, w, h])


class Masks(BaseTensor):
    """Instance masks: data (n, H, W) bool, in the original image's pixels."""

    @property
    def xy(self):
        raise NotImplementedError("Masks.xy (polygon contours) needs cv2.findContours, which "
                                  "ultralytics_pro_tpu_torch does not use; read Masks.data")

    @property
    def xyn(self):
        return self.xy


class Keypoints(BaseTensor):
    """Keypoints: data (n, K, 3) (x, y, visibility) or (n, K, 2), in the original image's pixels."""

    @property
    def xy(self):
        return self.data[..., :2]

    @property
    def xyn(self):
        h, w = self.orig_shape
        return self.xy / np.array([w, h])

    @property
    def conf(self):
        return self.data[..., 2] if self.data.shape[-1] == 3 else None


class Probs(BaseTensor):
    """Classification probabilities: data (nc,)."""

    @property
    def top1(self) -> int:
        return int(self.data.argmax())

    @property
    def top5(self) -> list:
        return np.argsort(-self.data, kind="stable")[:5].tolist()

    @property
    def top1conf(self) -> float:
        return float(self.data.max())

    @property
    def top5conf(self):
        return self.data[self.top5]


class OBB(BaseTensor):
    """Oriented boxes: data (n, 7) = cx, cy, w, h, rad, conf, cls, in the original image's pixels."""

    @property
    def xywhr(self):
        return self.data[:, :5]

    @property
    def conf(self):
        return self.data[:, -2]

    @property
    def cls(self):
        return self.data[:, -1]

    @property
    def xyxyxyxy(self):
        """(n, 4, 2) corners."""
        return xywhr2xyxyxyxy(np.ascontiguousarray(self.xywhr))

    @property
    def xyxy(self):
        """(n, 4) axis-aligned extent of the corners."""
        pts = self.xyxyxyxy
        return np.concatenate([pts.min(1), pts.max(1)], axis=-1)


class Results(SimpleClass):
    """One image's detections, with its masks or keypoints where the task has
    them; an obb task's oriented boxes are on `obb`, and a classify task's
    probabilities on `probs`, with `boxes` None."""

    def __init__(self, orig_img, path, names, boxes=None, masks=None, probs=None, keypoints=None, obb=None,
                 speed=None):
        self.orig_img = orig_img
        self.orig_shape = orig_img.shape[:2]
        self.path = path
        self.names = names
        self.boxes = Boxes(boxes, self.orig_shape) if boxes is not None else None
        self.masks = Masks(masks, self.orig_shape) if masks is not None else None
        self.keypoints = Keypoints(keypoints, self.orig_shape) if keypoints is not None else None
        self.obb = OBB(obb, self.orig_shape) if obb is not None else None
        self.probs = Probs(probs, self.orig_shape) if probs is not None else None
        self.speed = speed or {"preprocess": None, "inference": None, "postprocess": None}

    def __len__(self):
        for v in (self.boxes, self.masks, self.keypoints, self.obb):
            if v is not None:
                return len(v)
        return 0
