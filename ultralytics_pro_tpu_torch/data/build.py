"""Batches for train and val: fixed-shape padded label arrays, read by a thread pool.

Counterpart of `ultralytics_pro_tpu/data/build.py` (`collate_detect:23`,
`collate_classify:114` and `DataLoader:121`). Classify's collate stacks
the images and their int64 classes. The detect collate stacks images and
pads labels to `max_gt` slots (img (B, S, S, 3) uint8 BGR, cls (B, G),
bboxes (B, G, 4) normalised xywh, or obb's (B, G, 5) xywhr with cx, w by the width and cy, h by the
height and the angle as it is, mask_gt (B, G)), with pose's keypoints (B, G, K, 3)
normalised and segment's instance masks (B, G, S/mask_ratio, S/mask_ratio):
each polygon filled at the full size and shrunk as cv2 does it
(`data/rasterize.py`), overlaps given to the smaller instance and the
instance rows reordered largest first, as `:72-96` does; the loader yields batches whose
samples a thread pool reads. For val it keeps the dataset's order and pads
the last batch by repeating its last sample, with `pad_count` saying how
many; for train it shuffles with `random.Random(SEED + epoch)`, SEED 0, and drops
the last partial batch, as the JAX loader does, and `epoch` counts the
passes. Each pass hands its `epoch` to the dataset, whose augmented samples
draw from `sample_generators(epoch, index)`, seeded by (SEED, epoch, index), so the threads' order
changes no sample; `reset` (the trainer's close_mosaic) has the dataset
turn its mosaic-type transforms off, as the JAX loader's does.
"""

from __future__ import annotations

import functools
import random
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterator, Optional

import numpy as np

from ultralytics_pro_tpu_torch.data.rasterize import fill_poly, resize_linear_u8

SEED = 0  # the JAX loader's shuffle seed; the root of the per-sample generators too


def sample_generators(epoch: int, i: int):
    """Sample i's random.Random and np.random.RandomState in pass `epoch`."""
    s = int(np.random.SeedSequence([SEED, epoch, i]).generate_state(1)[0])
    return random.Random(s), np.random.RandomState(s)


def collate_detect(samples, max_gt: int = 128, mask_ratio: int = 4) -> Dict[str, np.ndarray]:
    """Stack label dicts into a fixed-shape batch. Boxes (pixel xyxy) are
    renormalised to the letterboxed image as xywh, rotated ones (pixel
    xywhr) keep their form; keypoints (pose) are normalised, segments become
    masks at 1/mask_ratio (segment).

    The boxes are rotated when any sample's are (n, 5), an image without
    objects too. The JAX collate asks only samples[0], and only when it
    has objects (`build.py:34`): a batch whose first image has none gets its
    rotated boxes read as xyxy there (ROADMAP.md section 3)."""
    b = len(samples)
    imgs = np.stack([s["img"] for s in samples])  # (B, H, W, 3) uint8 BGR
    h, w = imgs.shape[1:3]
    rotated = any(np.shape(s.get("bboxes", ()))[1:] == (5,) for s in samples)
    cls = np.zeros((b, max_gt), np.float32)
    bboxes = np.zeros((b, max_gt, 5 if rotated else 4), np.float32)
    mask = np.zeros((b, max_gt), bool)
    kpts = masks = None
    if samples[0].get("keypoints") is not None:
        k = samples[0]["keypoints"].shape[1] if len(samples[0]["keypoints"]) else 17
        kpts = np.zeros((b, max_gt, k, 3), np.float32)
    if samples[0].get("segments") is not None:
        mh, mw = h // mask_ratio, w // mask_ratio
        masks = np.zeros((b, max_gt, mh, mw), np.float32)
    for i, s in enumerate(samples):
        n = min(len(s["cls"]), max_gt)
        if not n:
            continue
        bx = s["bboxes"][:n]
        if rotated:
            bboxes[i, :n] = bx / np.array([w, h, w, h, 1], np.float32)
        else:
            bboxes[i, :n, 0] = (bx[:, 0] + bx[:, 2]) / 2 / w
            bboxes[i, :n, 1] = (bx[:, 1] + bx[:, 3]) / 2 / h
            bboxes[i, :n, 2] = (bx[:, 2] - bx[:, 0]) / w
            bboxes[i, :n, 3] = (bx[:, 3] - bx[:, 1]) / h
        cls[i, :n] = s["cls"][:n]
        mask[i, :n] = True
        if kpts is not None and len(s.get("keypoints", [])):
            kk = s["keypoints"][:n].copy()
            kk[..., 0] /= w
            kk[..., 1] /= h
            kpts[i, :n] = kk
        if masks is not None:
            ms = np.zeros((n, mh, mw), np.float32)
            for j, poly in enumerate(s["segments"][:n]):
                if len(poly) >= 3:
                    full = fill_poly(np.zeros((h, w), np.uint8), np.asarray(poly, np.int32).reshape(-1, 2))
                    ms[j] = resize_linear_u8(full, (mw, mh))
            # overlaps go to the smaller instance; rows reordered largest first
            order = np.argsort(-ms.reshape(n, -1).sum(1), kind="stable")
            winner = np.zeros((mh, mw), np.int32)
            for rank, j in enumerate(order, start=1):
                winner[ms[j] > 0] = rank
            for rank in range(1, n + 1):
                masks[i, rank - 1] = winner == rank
            cls[i, :n] = cls[i, :n][order]
            bboxes[i, :n] = bboxes[i, :n][order]
            if kpts is not None:
                kpts[i, :n] = kpts[i, :n][order]
    out = {
        "img": imgs,
        "cls": cls,
        "bboxes": bboxes,
        "mask_gt": mask,
        "im_files": [s.get("im_file") for s in samples],
        "ori_shapes": [s.get("ori_shape") for s in samples],
        "ratio_pads": [s.get("ratio_pad") for s in samples],
    }
    if kpts is not None:
        out["keypoints"] = kpts
    if masks is not None:
        out["masks"] = masks
    return out


def collate_classify(samples) -> Dict[str, np.ndarray]:
    """img (B, S, S, 3) uint8 BGR and cls (B,) int64."""
    return {"img": np.stack([s["img"] for s in samples]),
            "cls": np.array([s["cls"] for s in samples], np.int64)}


class DataLoader:
    """Iterable over the dataset's samples in batches of batch_size read by a
    thread pool. With shuffle, each pass takes the order
    `random.Random(SEED + epoch)` gives and `epoch` then counts up; with
    drop_last a last partial batch is dropped, else it is padded by repeating
    its last sample, and its `pad_count` says how many repeats the validator
    skips. `collate_fn` takes the list of samples (default: collate_detect
    at `max_gt` slots)."""

    def __init__(self, dataset, batch_size: int = 16, workers: int = 8, max_gt: int = 128,
                 shuffle: bool = False, drop_last: bool = False, collate_fn: Optional[Callable] = None):
        self.dataset = dataset
        self.collate_fn = collate_fn or functools.partial(collate_detect, max_gt=max_gt)
        self.batch_size = batch_size
        self.workers = max(1, workers)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.epoch = 0

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else (n + self.batch_size - 1) // self.batch_size

    def _index_batches(self):
        idx = list(range(len(self.dataset)))
        if self.shuffle:
            random.Random(SEED + self.epoch).shuffle(idx)  # the JAX loader's seed, plus the epoch
        batches = []
        for i in range(0, len(idx), self.batch_size):
            chunk = idx[i:i + self.batch_size]
            pad = self.batch_size - len(chunk)
            if pad and self.drop_last:
                continue
            batches.append((chunk + [chunk[-1]] * pad, pad))
        return batches

    def __iter__(self) -> Iterator[Dict]:
        batches = self._index_batches()
        if hasattr(self.dataset, "epoch"):
            self.dataset.epoch = self.epoch
        with ThreadPoolExecutor(max_workers=self.workers) as pool:
            # one pool task per sample, batches assembled in order, up to 4 in flight
            pending = []
            for chunk, pad in batches:
                pending.append(([pool.submit(self.dataset.__getitem__, i) for i in chunk], pad))
                if len(pending) > 3:
                    yield self._assemble(*pending.pop(0))
            for futs, pad in pending:
                yield self._assemble(futs, pad)
        self.epoch += 1

    def _assemble(self, futures, pad: int = 0):
        batch = self.collate_fn([f.result() for f in futures])
        batch["pad_count"] = pad
        return batch

    def reset(self):
        """close_mosaic: the dataset's Mosaic, MixUp, CutMix and CopyPaste off
        (a dataset without them, such as classify's, is left as it is)."""
        if hasattr(self.dataset, "close_mosaic"):
            self.dataset.close_mosaic()
