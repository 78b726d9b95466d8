"""YOLO-format detect, segment, pose and obb datasets, and the folder-per-class
classify dataset, for val and for train without augmentation.

Counterpart of `ultralytics_pro_tpu/data/dataset.py` (`YOLODataset:34`):
image scan (`get_img_files:140`, `IMG_FORMATS:25`), label paths
(`img2label_paths:28`) and labels (`_parse_labels:207`: detect boxes,
segment polygons with their bounding boxes, pose boxes with `kpt_shape`
keypoints from the dataset YAML, a missing visibility written as 2, obb's
four corners), the
long-side resize on load (`_read_resized:295` and `load_image:332` in one:
area averaging to shrink, bilinear to grow), `get_image_and_label:344`, and
the non-augment transforms (`build_transforms:386`) behind `__getitem__:414`;
and `ClassificationDataset:422`: sorted class folders, the files inside
each sorted, through `classify_transforms` (short side to imgsz, centre
crop). Images are read by `data/image_io.imread`: PNG natively, other formats
(the JPEG of ImageNet or imagenette) only where PIL imports.
Images are read by `data/image_io.imread`, not OpenCV. An obb label's
corners become (cx, cy, w, h, rad) in the resized image's pixels through
`data/geometry.poly2xywhr`, the copy of `_poly2xywhr:276` and of the
`cv2.minAreaRect` it calls (`:360`).

With `augment=False` (the JAX package's default, `cfg/default.yaml:66`)
train images go through the same transforms as val, as in the JAX dataset.
Labels are parsed on every construction: the port writes no `.cache` beside
the labels. Rectangular batches, image caches, augmentation (the JAX
`v8_transforms`: Mosaic, RandomPerspective, RandomHSV, flips, MixUp),
channel counts other than 3 and `ClassificationDataset(augment=True)`
(RandAugment through cv2) raise NotImplementedError; the class filter and
`fraction` of the JAX dataset are
left out.
"""

from __future__ import annotations

import glob
import os
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from ultralytics_pro_tpu_torch.data.augment import Compose, LetterBox, classify_transforms, resize_area, resize_bilinear
from ultralytics_pro_tpu_torch.data.geometry import poly2xywhr
from ultralytics_pro_tpu_torch.data.image_io import imread

IMG_FORMATS = {"bmp", "dng", "jpeg", "jpg", "mpo", "png", "tif", "tiff", "webp", "pfm"}
TASKS = ("detect", "segment", "pose", "obb")


def img2label_paths(img_paths: List[str]) -> List[str]:
    """images/xxx.jpg -> labels/xxx.txt."""
    sa, sb = f"{os.sep}images{os.sep}", f"{os.sep}labels{os.sep}"
    return [sb.join(x.rsplit(sa, 1)).rsplit(".", 1)[0] + ".txt" for x in img_paths]


def _poly2xywh(pts: np.ndarray) -> np.ndarray:
    """A polygon's (k, 2) points -> the xywh box of its extent."""
    x1, y1 = pts[:, 0].min(), pts[:, 1].min()
    x2, y2 = pts[:, 0].max(), pts[:, 1].max()
    return np.array([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1], np.float32)


class YOLODataset:
    """Detect, segment, pose or obb dataset over YOLO-format labels (no augmentation)."""

    def __init__(self, img_path, imgsz: int = 640, augment: bool = False, rect: bool = False,
                 single_cls: bool = False, data: Optional[Dict] = None, task: str = "detect",
                 cache=None):
        if augment:
            raise NotImplementedError(
                "YOLODataset(augment=True) is not implemented in ultralytics_pro_tpu_torch yet: the "
                "train augmentations (the JAX package's data/augment.py v8_transforms) need cv2-free "
                "forms, ROADMAP.md queue 1 (train augmentations); train with augment=False, the default")
        if task == "classify":
            raise NotImplementedError("YOLODataset(task='classify'): a classify set is a folder per class, "
                                      "read by ClassificationDataset (data/dataset.py) after check_cls_dataset")
        unported = {"rect=True": rect, f"cache={cache!r}": cache, f"task={task!r}": task not in TASKS}
        for what, asked in unported.items():
            if asked:
                raise NotImplementedError(f"YOLODataset({what}) is not implemented in "
                                          f"ultralytics_pro_tpu_torch yet; it ports the {', '.join(TASKS)} "
                                          "paths without augmentation")
        self.data = data or {}
        ch = int(self.data.get("channels", 3) or 3)
        if ch != 3:
            raise NotImplementedError(f"datasets with channels={ch} are not implemented in "
                                      "ultralytics_pro_tpu_torch yet (3 only)")
        self.img_path = img_path
        self.imgsz = imgsz
        self.single_cls = single_cls
        self.task = task
        self.im_files = self.get_img_files(img_path)
        self.labels = self.get_labels()
        self.ni = len(self.labels)
        self.transforms = self.build_transforms()

    # -- files / labels -------------------------------------------------------
    def get_img_files(self, img_path) -> List[str]:
        files = []
        for p in img_path if isinstance(img_path, list) else [img_path]:
            p = Path(p)
            if p.is_dir():
                files += glob.glob(str(p / "**" / "*.*"), recursive=True)
            elif p.is_file():  # txt file listing images
                with open(p) as f:
                    parent = str(p.parent) + os.sep
                    files += [x.replace("./", parent) if x.startswith("./") else x
                              for x in f.read().strip().splitlines()]
            else:
                raise FileNotFoundError(f"{p} does not exist")
        files = sorted(x for x in files if x.rsplit(".", 1)[-1].lower() in IMG_FORMATS)
        if not files:
            raise FileNotFoundError(f"No images found in {img_path}")
        return files

    def get_labels(self) -> List[Dict]:
        """Parsed labels, single_cls applied."""
        labels = self._parse_labels(img2label_paths(self.im_files))
        if self.single_cls:
            for entry in labels:
                if len(entry["cls"]):
                    entry["cls"][:] = 0
        return labels

    def _parse_labels(self, label_files: List[str]) -> List[Dict]:
        """Labels by task, normalised; a missing file is an image without
        objects. detect: `cls cx cy w h`; segment: `cls x1 y1 x2 y2 ...` (a
        polygon, boxed by its extent); pose: `cls cx cy w h` and kpt_shape[0]
        keypoints of kpt_shape[1] values; obb: `cls x1 y1 x2 y2 x3 y3 x4 y4`."""
        kpt_shape = tuple(self.data.get("kpt_shape", (17, 3)))
        labels = []
        for im_file, lb_file in zip(self.im_files, label_files):
            rows = []
            if os.path.isfile(lb_file):
                with open(lb_file) as f:
                    rows = [x.split() for x in f.read().strip().splitlines() if len(x)]
            entry = {"im_file": im_file}
            if self.task == "segment":
                segments = [np.array(r[1:], np.float32).reshape(-1, 2) for r in rows]
                entry["cls"] = np.array([float(r[0]) for r in rows], np.float32)
                entry["bboxes_n"] = np.array([_poly2xywh(p) for p in segments], np.float32).reshape(-1, 4)
                entry["segments_n"] = segments
            elif self.task == "pose":
                k, nd = kpt_shape
                v = [np.array(r, np.float32) for r in rows]
                kpts = [x[5:5 + k * nd].reshape(k, nd) for x in v]
                if nd == 2:
                    kpts = [np.concatenate([kp, 2 * np.ones((k, 1), np.float32)], 1) for kp in kpts]
                entry["cls"] = np.array([x[0] for x in v], np.float32)
                entry["bboxes_n"] = np.array([x[1:5] for x in v], np.float32).reshape(-1, 4)
                entry["keypoints_n"] = np.stack(kpts) if kpts else np.zeros((0, k, 3), np.float32)
            elif self.task == "obb":
                entry["cls"] = np.array([float(r[0]) for r in rows], np.float32)
                entry["corners_n"] = np.array([r[1:9] for r in rows], np.float32).reshape(-1, 4, 2)
            else:
                lb = np.array(rows, np.float32) if rows else np.zeros((0, 5), np.float32)
                entry["cls"], entry["bboxes_n"] = lb[:, 0], lb[:, 1:5]
            labels.append(entry)
        return labels

    # -- loading --------------------------------------------------------------
    def load_image(self, i: int):
        """Read + long-side resize to imgsz (`_read_resized`; there is no image
        cache): area averaging to shrink, bilinear to grow (the val path's
        INTER_AREA and INTER_LINEAR). Returns (image, (h0, w0), (h, w))."""
        im = imread(self.im_files[i])
        h0, w0 = im.shape[:2]
        r = self.imgsz / max(h0, w0)
        if r != 1:
            size = (min(round(w0 * r), self.imgsz), min(round(h0 * r), self.imgsz))
            im = resize_bilinear(im, size).numpy() if r > 1 else resize_area(im, size)
        return im, (h0, w0), im.shape[:2]

    def get_image_and_label(self, i: int) -> Dict:
        """Label dict with pixel-space xyxy boxes (and keypoints or polygons),
        or obb's (n, 5) xywhr boxes, for the (resized) image."""
        im, ori_shape, resized = self.load_image(i)
        lb = self.labels[i]
        h, w = resized
        out = {
            "img": im,
            "cls": lb["cls"].copy(),
            "im_file": lb["im_file"],
            "ori_shape": ori_shape,
            "resized_shape": resized,
            # the full pre-resize gain; LetterBox composes its own ratio and pads on top
            "ratio_pad": (resized[0] / ori_shape[0], resized[1] / ori_shape[1]),
        }
        if self.task == "obb":  # corners in the resized image's pixels, so the angles are undistorted
            scale = np.array([w, h], np.float32)
            out["bboxes"] = np.array([poly2xywhr(c * scale) for c in lb["corners_n"]], np.float32).reshape(-1, 5)
            return out
        n = lb["bboxes_n"]
        if len(n):
            cx, cy, bw, bh = n[:, 0] * w, n[:, 1] * h, n[:, 2] * w, n[:, 3] * h
            boxes = np.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2], 1)
        else:
            boxes = np.zeros((0, 4), np.float32)
        out["bboxes"] = boxes.astype(np.float32)
        if "keypoints_n" in lb:
            k = lb["keypoints_n"].copy()
            if len(k):
                k[..., 0] *= w
                k[..., 1] *= h
            out["keypoints"] = k
        if "segments_n" in lb:
            out["segments"] = [s * np.array([w, h], np.float32) for s in lb["segments_n"]]
        return out

    # -- pipeline -------------------------------------------------------------
    def build_transforms(self) -> Compose:
        return Compose([LetterBox((self.imgsz, self.imgsz), scaleup=False)])

    def __len__(self):
        return self.ni

    def __getitem__(self, i: int) -> Dict:
        return self.transforms(self.get_image_and_label(i))


class ClassificationDataset:
    """Folder-per-class dataset: root/<class>/<images>, the classes and the
    files inside each sorted. Items are {"img": (imgsz, imgsz, 3) uint8 BGR,
    "cls": class index}."""

    def __init__(self, root, imgsz: int = 224, augment: bool = False):
        if augment:
            raise NotImplementedError(
                "ClassificationDataset(augment=True) is not implemented in ultralytics_pro_tpu_torch yet: "
                "classify_augmentations (RandomResizedCrop, flips, RandAugment through cv2, RandomErasing) "
                "comes with the train augmentations, ROADMAP.md queue 1 item 2a; train with augment=False, "
                "the default")
        self.root = Path(root)
        self.tf = classify_transforms(imgsz)
        classes = sorted(d.name for d in self.root.iterdir() if d.is_dir())
        self.samples = [(str(f), i) for i, c in enumerate(classes) for f in sorted((self.root / c).rglob("*.*"))
                        if f.suffix[1:].lower() in IMG_FORMATS]
        if not self.samples:
            raise FileNotFoundError(f"No images found under {root}")

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i: int) -> Dict:
        path, cls = self.samples[i]
        return {"img": np.ascontiguousarray(self.tf(imread(path))), "cls": cls}
