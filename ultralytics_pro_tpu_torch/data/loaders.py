"""Predict sources: image files, folders, globs, lists of paths, and arrays.

Counterpart of `ultralytics_pro_tpu/data/loaders.py` (`LoadImagesAndVideos:25`,
`LoadPilAndNumpy:112`, `load_inference_source:128`). Files are listed in
the JAX loader's order: a glob's matches sorted (recursive with `**`), a
folder's image and video files sorted by path, files as given. They are
read by `data/image_io.py:imread`: PNG and `.npy` on any machine, JPEG and
the other image suffixes where PIL is installed (else it raises naming the
file and PIL). Video files, stream URLs, webcams, screens and YouTube raise
NotImplementedError: they need a video decoder (the JAX loader's
cv2.VideoCapture, mss, yt_dlp), and the card's machine has none.
"""

from __future__ import annotations

import glob
from pathlib import Path
from typing import Iterator, List, Tuple

import numpy as np

from ultralytics_pro_tpu_torch.data.image_io import imread

IMG_SUFFIXES = {".bmp", ".jpeg", ".jpg", ".png", ".tif", ".tiff", ".webp"}
VID_SUFFIXES = {".mp4", ".avi", ".mov", ".mkv", ".m4v", ".wmv", ".mpeg", ".mpg", ".webm", ".gif"}
STREAM_PREFIXES = ("rtsp://", "rtmp://", "http://", "https://")


def _no_decoder(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what}: ultralytics_pro_tpu_torch reads image files (PNG and .npy itself, other formats "
        "through PIL) and arrays; video files and streams need a video decoder (OpenCV's "
        "cv2.VideoCapture in the JAX package), which this package does not use")


class LoadImagesAndVideos:
    """The image files of a path, glob, folder or list of them, in the JAX
    loader's order; a video file among them raises by name."""

    def __init__(self, path):
        paths: List[str] = []
        for p in path if isinstance(path, (list, tuple)) else [path]:
            p = str(p)
            if "*" in p:
                paths.extend(sorted(glob.glob(p, recursive=True)))
            elif Path(p).is_dir():
                paths.extend(sorted(str(f) for f in Path(p).iterdir()
                                    if f.suffix.lower() in IMG_SUFFIXES | VID_SUFFIXES))
            elif Path(p).is_file():
                paths.append(p)
            else:
                raise FileNotFoundError(f"source '{p}' not found")
        videos = [f for f in paths if Path(f).suffix.lower() in VID_SUFFIXES]
        if videos:
            raise _no_decoder(f"video file {videos[0]}")
        self.files = paths

    def __iter__(self) -> Iterator[Tuple[str, np.ndarray]]:
        for f in self.files:
            yield f, imread(f)

    def __len__(self):
        return len(self.files)


def _is_pil(im) -> bool:
    return type(im).__module__.split(".")[0] == "PIL"


class LoadPilAndNumpy:
    """In-memory images: HWC uint8 BGR arrays, or PIL images (RGB, turned to BGR)."""

    def __init__(self, imgs):
        self.imgs = imgs if isinstance(imgs, (list, tuple)) else [imgs]

    def __iter__(self):
        for i, im in enumerate(self.imgs):
            if _is_pil(im):
                im = np.ascontiguousarray(np.asarray(im.convert("RGB"))[..., ::-1])
            elif not isinstance(im, np.ndarray):
                raise TypeError(f"source item {i} of type {type(im).__name__}: pass arrays, PIL images or paths")
            yield f"image{i}", im

    def __len__(self):
        return len(self.imgs)


def load_inference_source(source):
    """The loader of a predict source: arrays and PIL images in memory, files
    otherwise; streams, webcams, screens and YouTube raise by name."""
    first = source[0] if isinstance(source, (list, tuple)) and len(source) else source
    if isinstance(first, np.ndarray) or _is_pil(first):
        return LoadPilAndNumpy(source)
    s = str(source)
    if "youtube.com/" in s or "youtu.be/" in s:
        raise _no_decoder(f"YouTube source {s} (yt_dlp and a decoder)")
    if s.isdigit() or s.startswith(STREAM_PREFIXES):
        raise _no_decoder(f"stream or webcam source {s}")
    if s.lower().startswith("screen"):
        raise _no_decoder(f"screen capture source {s} (mss)")
    return LoadImagesAndVideos(source)
