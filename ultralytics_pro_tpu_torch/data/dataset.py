"""YOLO-format detect, segment, pose and obb datasets, and the folder-per-class
classify dataset, for val and for train, with or without augmentation.

Counterpart of `ultralytics_pro_tpu/data/dataset.py` (`YOLODataset:34`):
image scan (`get_img_files:140`, `IMG_FORMATS:25`), label paths
(`img2label_paths:28`) and labels (`_parse_labels:207`: detect boxes,
segment polygons with their bounding boxes, pose boxes with `kpt_shape`
keypoints from the dataset YAML, a missing visibility written as 2, obb's
four corners), the
long-side resize on load (`_read_resized:295` and `load_image:332`),
`get_image_and_label:344`, the transforms (`build_transforms:386`) behind
`__getitem__:414` and `close_mosaic:404`; and `ClassificationDataset:422`:
sorted class folders, the files inside each sorted, through
`classify_transforms` (short side to imgsz, centre crop) or
`classify_augmentations`. Images are read by `data/image_io.imread`, not
OpenCV: PNG natively, other formats (the JPEG of ImageNet or imagenette)
only where PIL imports. An obb label's
corners become (cx, cy, w, h, rad) in the resized image's pixels through
`data/geometry.poly2xywhr`, the copy of `_poly2xywhr:276` and of the
`cv2.minAreaRect` it calls (`:360`).

With `augment=False` (the JAX package's default, `cfg/default.yaml:66`)
train images go through the same transforms as val, as in the JAX dataset.
Labels are parsed on every construction: the port writes no `.cache` beside
the labels.

`rect=True` (`set_rectangle:74`, `__getitem__:414-417`): the images sorted
by aspect ratio h / w, read from the files' headers (`image_io.imsize`; the
JAX dataset opens them with PIL, and an image it cannot open counts as
square there and here), one shape a batch of `batch_size`, a multiple of
`stride` (`ceil(shape * imgsz / stride + pad) * stride`), and each image
letterboxed to its batch's shape. `cache` (`_cache_images:124`,
`load_image:332`): "ram" (or any other true value) keeps each resized image,
unless the free memory looks too small for them (`_check_cache_ram:103`);
"disk" writes each resized image and its original (h, w) as `im` and `shape`
in an `.npz` beside the image file, read back in place of the image (either
package reads the other's).

`augment=True` (`build_transforms:386-402`): detect runs `v8_transforms`
(Mosaic, CopyPaste, RandomPerspective, MixUp, CutMix, RandomHSV, the two
flips) and a scale-up letterbox; segment, pose and obb a letterbox, RandomHSV
and the left-right flip with the dataset's `flip_idx`; the `hyp` gains are
the train arguments of those names. Images are then shrunk on load with
bilinear interpolation (`imgproc.resize_linear`, cv2's INTER_LINEAR bit for
bit), as the JAX dataset does under augmentation. `close_mosaic` sets the
probability of Mosaic, MixUp, CutMix and CopyPaste to 0; they still draw
their coin, as there. Each sample draws from its own generators,
`random.Random(s)` and `np.random.RandomState(s)` with s from
`np.random.SeedSequence([SEED, epoch, index])` (`data/build.py:sample_generators`,
the loader's seed and its pass): an augmented
epoch does not depend on the loader's threads, where the JAX loader's
threads share the process-wide streams (ROADMAP.md section 3).
`sample(i, rng, nprng)` takes the generators given, so a test seeds both
packages alike.

The dataset YAML's `channels` (`_read_resized:295-330`): 1 reads the image,
turns it grey as cv2's BGR2GRAY does (`imgproc.bgr2gray`) and repeats it to
3 channels; more than 3 reads the `.npy` band stack (H, W, channels) beside
each image, or tiles the image's BGR channels to that count where there is
none.

`ClassificationDataset(augment=True)` runs `classify_augmentations`
(RandomResizedCrop, the flip, RandAugment and RandomErasing at the JAX
dataset's defaults: randaugment, erasing 0.4). The class filter and
`fraction` of the JAX dataset are left out.
"""

from __future__ import annotations

import glob
import os
import random
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from ultralytics_pro_tpu_torch.data import imgproc
from ultralytics_pro_tpu_torch.data.augment import (Compose, CopyPaste, CutMix, LetterBox, MixUp, Mosaic, RandomFlip,
                                                    RandomHSV, classify_augmentations, classify_transforms, resize_area,
                                                    resize_bilinear, v8_transforms)
from ultralytics_pro_tpu_torch.data.build import sample_generators
from ultralytics_pro_tpu_torch.data.geometry import poly2xywhr
from ultralytics_pro_tpu_torch.data.image_io import imread, imsize
from ultralytics_pro_tpu_torch.utils import LOGGER

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
    """Detect, segment, pose or obb dataset over YOLO-format labels."""

    def __init__(self, img_path, imgsz: int = 640, augment: bool = False, hyp: Optional[Dict] = None,
                 rect: bool = False, single_cls: bool = False, data: Optional[Dict] = None, task: str = "detect",
                 cache=None, batch_size: int = 16, stride: int = 32, pad: float = 0.5):
        if task == "classify":
            raise NotImplementedError("YOLODataset(task='classify'): a classify set is a folder per class, "
                                      "read by ClassificationDataset (data/dataset.py) after check_cls_dataset")
        if task not in TASKS:
            raise NotImplementedError(f"YOLODataset(task={task!r}) is not implemented in ultralytics_pro_tpu_torch "
                                      f"yet; it ports the {', '.join(TASKS)} paths")
        self.data = data or {}
        self.channels = int(self.data.get("channels", 3) or 3)
        self.augment = bool(augment)
        self.hyp = dict(hyp or {})
        self.flip_idx = self.data.get("flip_idx")
        self.epoch = 0  # the loader's pass, which it sets
        self.img_path = img_path
        self.imgsz = imgsz
        self.single_cls = single_cls
        self.task = task
        self.im_files = self.get_img_files(img_path)
        self.labels = self.get_labels()
        self.ni = len(self.labels)
        self.cache = str(cache).lower() if cache not in (None, False) else None
        self.ims = [None] * self.ni
        if self.cache == "ram" and not self._check_cache_ram():
            self.cache = None
        if self.cache:
            self._cache_images()
        self.rect = bool(rect)
        self.batch_size, self.stride, self.pad = batch_size, stride, pad
        if self.rect:
            self.set_rectangle()
        self.transforms = self.build_transforms()

    def set_rectangle(self):
        """Sort the images by aspect ratio and give each batch one shape,
        `batch_shapes[batch_index[i]]` (h, w)."""
        shapes = []
        for f in self.im_files:
            try:
                shapes.append(imsize(f))
            except Exception:  # as the JAX dataset takes an image PIL cannot open
                shapes.append((self.imgsz, self.imgsz))
        ar = np.array([h / w for h, w in shapes], np.float64)
        order = np.argsort(ar).tolist()
        self.im_files = [self.im_files[i] for i in order]
        self.labels = [self.labels[i] for i in order]
        self.ims = [self.ims[i] for i in order]
        ar = ar[order]
        nb = int(np.ceil(self.ni / self.batch_size))
        self.batch_index = (np.arange(self.ni) // self.batch_size).astype(int)
        out = np.ones((nb, 2), np.float64)
        for b in range(nb):
            ari = ar[self.batch_index == b]
            mini, maxi = ari.min(), ari.max()
            if maxi < 1:
                out[b] = [maxi, 1]
            elif mini > 1:
                out[b] = [1, 1 / mini]
        self.batch_shapes = np.ceil(out * self.imgsz / self.stride + self.pad).astype(int) * self.stride

    # -- caching ----------------------------------------------------------------
    def _npy_path(self, i: int) -> Path:
        return Path(self.im_files[i]).with_suffix(".npz")

    def _check_cache_ram(self, safety_margin: float = 0.5) -> bool:
        """Whether the resized images of up to 30 sampled files, extrapolated
        to the set and times 1 + safety_margin, fit in the free memory."""
        n = min(self.ni, 30)
        b = 0
        for i in random.Random(0).sample(range(self.ni), n):
            try:
                h, w = imsize(self.im_files[i])
            except (OSError, ImportError):  # unreadable, or not PNG with no PIL: left out of the sample
                continue
            r = self.imgsz / max(h, w)
            b += h * w * 3 * min(r, 1) ** 2
        need = b * self.ni / max(n, 1) * (1 + safety_margin)
        free = _available_memory()
        if need >= free:
            LOGGER.warning(f"cache=ram needs ~{need / 1e9:.1f}GB but only {free / 1e9:.1f}GB free; caching disabled")
        return need < free

    def _cache_images(self):
        for i in range(self.ni):
            if self.cache == "disk":
                p = self._npy_path(i)
                if not p.exists():
                    im, (h0, w0), _ = self._read_resized(i)
                    np.savez(str(p), im=im, shape=np.array((h0, w0)))
            else:
                self.ims[i] = self._read_resized(i)

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
        """The image from the RAM cache, the disk cache's `.npz`, or the file
        (`_read_resized`). Returns (image, (h0, w0), (h, w))."""
        if self.ims[i] is not None:
            return self.ims[i]
        if self.cache == "disk":
            p = self._npy_path(i)
            if p.exists():
                with np.load(str(p)) as z:
                    im = z["im"]
                    return im, tuple(int(v) for v in z["shape"]), im.shape[:2]
        return self._read_resized(i)

    def _read_resized(self, i: int):
        """Read (with the `channels` conversion) + long-side resize to imgsz:
        bilinear under augmentation (`imgproc.resize_linear`, bit for bit),
        else area averaging to shrink and bilinear to grow (the val path's
        INTER_AREA and INTER_LINEAR, `resize_area` and `resize_bilinear`).
        Returns (image, (h0, w0), (h, w))."""
        ch = self.channels
        npy = Path(self.im_files[i]).with_suffix(".npy")
        if ch > 3 and npy.exists():
            im = np.load(str(npy))
        else:
            im = imread(self.im_files[i])
            if ch > 3:  # no band stack: the BGR channels tiled to the count
                im = np.tile(im, (1, 1, (ch + 2) // 3))[:, :, :ch]
            elif ch == 1:
                im = imgproc.gray2bgr(imgproc.bgr2gray(im))
        h0, w0 = im.shape[:2]
        r = self.imgsz / max(h0, w0)
        if r != 1:
            size = (min(round(w0 * r), self.imgsz), min(round(h0 * r), self.imgsz))
            if self.augment:
                im = imgproc.resize_linear(im, size)
            else:
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
        size = (self.imgsz, self.imgsz)
        if not self.augment:
            return Compose([LetterBox(size, scaleup=False)])
        if self.task in ("obb", "pose", "segment"):
            return Compose([LetterBox(size, scaleup=True),
                            RandomHSV(self.hyp.get("hsv_h", 0.015), self.hyp.get("hsv_s", 0.7),
                                      self.hyp.get("hsv_v", 0.4)),
                            RandomFlip(p=self.hyp.get("fliplr", 0.5), direction="horizontal",
                                       flip_idx=self.flip_idx)])
        return Compose(v8_transforms(self, self.imgsz, self.hyp).transforms + [LetterBox(size, scaleup=True)])

    def close_mosaic(self):
        """Mosaic, MixUp, CutMix and CopyPaste off for the last epochs (their p to 0)."""
        for t in self.transforms.transforms:
            if isinstance(t, (Mosaic, MixUp, CutMix, CopyPaste)):
                t.p = 0.0

    def __len__(self):
        return self.ni

    def sample(self, i: int, rng: random.Random, nprng: np.random.RandomState) -> Dict:
        """Sample i through the transforms, drawing from rng and nprng."""
        labels = self.get_image_and_label(i)
        if self.rect:
            labels["rect_shape"] = tuple(int(v) for v in self.batch_shapes[self.batch_index[i]])
        return self.transforms(labels, rng, nprng)

    def __getitem__(self, i: int) -> Dict:
        return self.sample(i, *sample_generators(self.epoch, i))


def _available_memory() -> float:
    """Bytes of memory free for new allocations: psutil's `available` where
    psutil imports, else the system's free pages."""
    try:
        import psutil
    except ImportError:
        return float(os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE"))
    return float(psutil.virtual_memory().available)


class ClassificationDataset:
    """Folder-per-class dataset: root/<class>/<images>, the classes and the
    files inside each sorted. Items are {"img": (imgsz, imgsz, 3) uint8 BGR,
    "cls": class index}; with augment, each sample's generators are drawn as
    YOLODataset's (`sample_generators`, `sample`)."""

    def __init__(self, root, imgsz: int = 224, augment: bool = False, auto_augment: str = "randaugment",
                 erasing: float = 0.4, hflip: float = 0.5, scale=(0.08, 1.0)):
        self.root = Path(root)
        self.augment = bool(augment)
        self.epoch = 0  # the loader's pass, which it sets
        self.tf = (classify_augmentations(imgsz, scale=scale, hflip=hflip, auto_augment=auto_augment,
                                          erasing=erasing) if augment else classify_transforms(imgsz))
        classes = sorted(d.name for d in self.root.iterdir() if d.is_dir())
        self.samples = [(str(f), i) for i, c in enumerate(classes) for f in sorted((self.root / c).rglob("*.*"))
                        if f.suffix[1:].lower() in IMG_FORMATS]
        if not self.samples:
            raise FileNotFoundError(f"No images found under {root}")

    def __len__(self):
        return len(self.samples)

    def sample(self, i: int, rng: random.Random, nprng: np.random.RandomState) -> Dict:
        path, cls = self.samples[i]
        im = imread(path)
        return {"img": np.ascontiguousarray(self.tf(im, rng, nprng) if self.augment else self.tf(im)), "cls": cls}

    def __getitem__(self, i: int) -> Dict:
        return self.sample(i, *sample_generators(self.epoch, i))
