"""Prediction results, numpy-backed: boxes, instance masks, keypoints,
oriented boxes and class probabilities.

Counterpart of `ultralytics_pro_tpu/engine/results.py` (`BaseTensor:23`,
`Boxes:41`, `Masks:82`, `Keypoints:103`, `Probs:120`, `OBB:140`, `Results:167`)
for detect, segment, pose, obb and classify: the same accessors
(.xyxy/.xywh/.xyxyn/.xywhn/.conf/.cls, the keypoints' .xy/.xyn/.conf, the
oriented boxes' .xywhr/.xyxyxyxy/.xyxy, the probabilities'
.top1/.top5/.top1conf/.top5conf, len and indexing). `Probs.top5` orders by a
stable descending sort, ties to the lower class, where the JAX one reverses
an ascending argsort (ties to the higher).

A tracked frame's boxes have 7 columns, x1, y1, x2, y2, track id, conf,
cls (`Boxes.id`, `is_track`). `Masks.xy` is each mask's largest outer
contour (`data/contours.py`, cv2.findContours' copy), as the JAX property
takes it. The exports (`save_txt:236`, `summary:254`, `to_json:276`,
`to_df`) write what the JAX ones write on untracked rows, byte for byte. On
a tracked row the JAX `summary` reads the id as the confidence and the
confidence as the class (`row[:6]`, `:263`); this one reads `Boxes.conf`
and `Boxes.cls` and adds the reference's `track_id` (ROADMAP.md section 3).
Drawing (`plot`, `save`) waits for a later slice.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List

import numpy as np

from ultralytics_pro_tpu_torch.data.contours import contour_area, find_contours
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
    """Detection boxes: data (n, 6) = x1, y1, x2, y2, conf, cls, or (n, 7)
    with the track id before conf."""

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
    def id(self):
        return self.data[:, -3] if self.data.shape[1] == 7 else None

    @property
    def is_track(self) -> bool:
        return self.data.shape[1] == 7

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
    def xy(self) -> list:
        """Each mask's largest outer contour (the first of equal areas, in
        cv2's order), (k, 2) f32 pixels; (0, 2) for an empty mask."""
        out = []
        for m in self.data.astype(np.uint8):
            contours = find_contours(m)
            out.append(max(contours, key=contour_area).reshape(-1, 2).astype(np.float32)
                       if contours else np.zeros((0, 2), np.float32))
        return out

    @property
    def xyn(self) -> list:
        h, w = self.orig_shape
        return [p / np.array([w, h], np.float32) for p in self.xy]


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

    def new(self) -> "Results":
        """An empty Results of the same image, path and names."""
        return Results(self.orig_img, self.path, self.names)

    def save_txt(self, txt_file, save_conf: bool = False) -> Path:
        """Append YOLO-format lines to txt_file: `cls cx cy w h [conf]`
        normalised to 6 decimals, or a classify result's top-5
        `prob name` lines."""
        lines = []
        if self.probs is not None:
            lines += [f"{self.probs.data[i]:.2f} {self.names.get(i, i)}" for i in self.probs.top5]
        elif self.boxes is not None:
            for row, xywhn in zip(self.boxes.data, self.boxes.xywhn):
                c, cf = int(row[-1]), row[-2]
                parts = [str(c), *(f"{x:.6f}" for x in xywhn)]
                if save_conf:
                    parts.append(f"{cf:.6f}")
                lines.append(" ".join(parts))
        p = Path(txt_file)
        p.parent.mkdir(parents=True, exist_ok=True)
        with open(p, "a", encoding="utf-8") as f:
            f.write("\n".join(lines) + "\n" if lines else "")
        return p

    def summary(self, normalize: bool = False, decimals: int = 5) -> List[Dict]:
        """One dict a detection: name, class, confidence and box (x1, y1, x2,
        y2, divided by the image's width and height with normalize), plus
        track_id on a tracked frame; a classify result's top-1 alone."""
        if self.probs is not None:
            return [{"name": self.names.get(self.probs.top1, ""), "class": self.probs.top1,
                     "confidence": round(self.probs.top1conf, decimals)}]
        out = []
        if self.boxes is not None:
            h, w = self.orig_shape
            ids = self.boxes.id
            for i, (row, cf, c) in enumerate(zip(self.boxes.data, self.boxes.conf, self.boxes.cls)):
                x1, y1, x2, y2 = row[:4]
                if normalize:
                    x1, x2, y1, y2 = x1 / w, x2 / w, y1 / h, y2 / h
                d = {"name": self.names.get(int(c), str(int(c))), "class": int(c),
                     "confidence": round(float(cf), decimals),
                     "box": {"x1": round(float(x1), decimals), "y1": round(float(y1), decimals),
                             "x2": round(float(x2), decimals), "y2": round(float(y2), decimals)}}
                if ids is not None:
                    d["track_id"] = int(ids[i])
                out.append(d)
        return out

    def to_json(self, normalize: bool = False, decimals: int = 5) -> str:
        return json.dumps(self.summary(normalize=normalize, decimals=decimals), indent=2)

    def to_df(self, normalize: bool = False, decimals: int = 5):
        """The summary as a pandas DataFrame, or as the list of dicts where
        pandas is not installed."""
        rows = self.summary(normalize=normalize, decimals=decimals)
        try:
            import pandas as pd
        except ImportError:
            return rows
        return pd.DataFrame(rows)
