"""The port's train augmentations against cv2 and against the JAX package, on the CPU.

- `data/imgproc.py`, the numpy copies of the cv2 calls, each against cv2
  itself (OpenCV 5.0.0): every one is exact, so every test asserts equality
  (a share of exact pixels of 1.0): BGR2GRAY, BGR2HSV and HSV2BGR over every
  colour, warpAffine and warpPerspective with rotation, scale, shear,
  perspective, non-square outputs and the constant border for 1 to 4
  channels, the YCrCb pair, equalizeHist, the 3x3 GaussianBlur, the
  bilinear resize of 3 channels and getRotationMatrix2D.
- Each JAX transform of `ultralytics_pro_tpu/data/augment.py` against the
  port's on the same label dict, the JAX process-wide streams seeded with s
  (`random.seed`, `np.random.seed`) and the port's generators made from s
  (`random.Random(s)`, `np.random.RandomState(s)`), with nonzero degrees,
  shear, perspective, mixup, cutmix and copy_paste: images within 1 grey
  level (all equal as measured), boxes, classes, keypoints and segments
  within 1e-4 px.
- Both packages' `YOLODataset(augment=True)` for detect, segment, pose (with
  `flip_idx`) and obb, and `ClassificationDataset(augment=True)`, sample by
  sample, seeded as above: images within 2 grey levels, labels within 1e-4
  px; `close_mosaic` turns off the same transforms in both.
"""

import copy
import math
import random
import shutil
from pathlib import Path

import cv2
import numpy as np
import pytest

from tests.conftest import FIXTURES
from tests.test_torch_modules import torch_threads  # noqa: F401 (autouse fixture)
from ultralytics_pro_tpu.data import augment as jaug
from ultralytics_pro_tpu.data import dataset as jds
from ultralytics_pro_tpu_torch.data import augment as paug
from ultralytics_pro_tpu_torch.data import dataset as pds
from ultralytics_pro_tpu_torch.data import imgproc

PX_TOL = 1e-4
IMG_TOL = 1  # a transform against its JAX counterpart, grey levels
DATASET_IMG_TOL = 2  # a dataset sample against the JAX one
HYP = {"degrees": 10.0, "translate": 0.1, "scale": 0.5, "shear": 5.0, "perspective": 0.0005, "mixup": 0.5,
       "cutmix": 0.5, "copy_paste": 0.5, "mosaic": 1.0, "hsv_h": 0.015, "hsv_s": 0.7, "hsv_v": 0.4,
       "flipud": 0.5, "fliplr": 0.5}
FLIP_IDX = [1, 0, 3, 2, 4]  # the pose set's 5 keypoints: corners swapped in pairs, the centre kept


def all_colours() -> np.ndarray:
    v = np.arange(256)
    b, g, r = np.meshgrid(v, v, v, indexing="ij")
    return np.stack([b, g, r], -1).reshape(4096, 4096, 3).astype(np.uint8)


def seeded_image(seed: int, h: int, w: int, c: int = 3) -> np.ndarray:
    """A smooth image with noise (uniform noise alone hides interpolation errors in its own spread)."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:h, :w]
    base = 127 + 100 * np.sin(xx[..., None] / (5 + 3 * np.arange(c)) + yy[..., None] / 7.0)
    return np.clip(base + rng.randint(-20, 21, (h, w, c)), 0, 255).astype(np.uint8)


# -- the cv2 copies ------------------------------------------------------------
def test_bgr2gray_matches_cv2_on_every_colour():
    img = all_colours()
    np.testing.assert_array_equal(imgproc.bgr2gray(img), cv2.cvtColor(img, cv2.COLOR_BGR2GRAY))
    np.testing.assert_array_equal(imgproc.gray2bgr(imgproc.bgr2gray(img[:7, :9])),
                                  cv2.cvtColor(cv2.cvtColor(img[:7, :9], cv2.COLOR_BGR2GRAY), cv2.COLOR_GRAY2BGR))


@pytest.mark.parametrize("width", [4096, 4095, 31, 1])
def test_hsv_pair_matches_cv2_on_every_colour(width):
    """BGR2HSV over all 2^24 colours; HSV2BGR over every hue below 180 and
    every saturation and value, in rows of `width` pixels: cv2's vector loop
    takes 32 pixels at a time and its scalar tail rounds otherwise, so the
    widths put pixels in both."""
    img = all_colours()
    if width == 4096:
        np.testing.assert_array_equal(imgproc.bgr2hsv(img), cv2.cvtColor(img, cv2.COLOR_BGR2HSV))
    hsv = img.reshape(-1, 3).copy()
    hsv[:, 0] %= 180
    n = (len(hsv) // width) * width
    hsv = hsv[:n].reshape(-1, width, 3)[:max(1, 2 ** 20 // width)]
    np.testing.assert_array_equal(imgproc.hsv2bgr(hsv), cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR))


def random_warps(seed: int, n: int):
    """n (image, 3x3 matrix, dsize) triples: rotations of up to 45 degrees,
    scales 0.3-2, shears up to 20 degrees, perspective up to 1e-3 and
    translations, into outputs from 3 to 500 px a side, square or not."""
    rng = np.random.RandomState(seed)
    out = []
    for k in range(n):
        h, w = rng.randint(3, 260, 2)
        R = np.eye(3)
        R[:2] = cv2.getRotationMatrix2D(angle=rng.uniform(-45, 45), center=(0, 0), scale=rng.uniform(0.3, 2))
        S = np.eye(3)
        S[0, 1], S[1, 0] = (math.tan(rng.uniform(-20, 20) * math.pi / 180) for _ in range(2))
        P = np.eye(3)
        P[2, :2] = rng.uniform(-1e-3, 1e-3, 2)
        T = np.eye(3)
        T[:2, 2] = rng.uniform(0, w), rng.uniform(0, h)
        C = np.eye(3)
        C[:2, 2] = -w / 2, -h / 2
        dsize = (int(rng.randint(3, 500)), int(rng.randint(3, 500)))
        out.append((seeded_image(seed * 100 + k, h, w, 4), T @ S @ R @ P @ C, dsize))
    return out


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
@pytest.mark.parametrize("kind", ["affine", "perspective"])
def test_warps_match_cv2(kind, channels):
    """Every pixel equal, the border of 114 (of 128 for RandAugment's rotate) included."""
    for img, m, dsize in random_warps(channels + (10 if kind == "perspective" else 0), 12):
        img = img[..., 0] if channels == 1 else np.ascontiguousarray(img[..., :channels])
        fill = (128,) * 3 if channels == 3 else (114,) * 4  # a 3-tuple leaves a 4th channel's border at 0
        if kind == "affine":
            got = imgproc.warp_affine(img, m[:2], dsize, fill)
            want = cv2.warpAffine(img, m[:2], dsize, borderValue=fill)
        else:
            got = imgproc.warp_perspective(img, m, dsize, fill)
            want = cv2.warpPerspective(img, m, dsize, borderValue=fill)
        np.testing.assert_array_equal(got, want.reshape(got.shape))


def test_warp_of_many_bands_in_fours_equals_warp_per_band():
    """The JAX transform warps more than 4 bands 4 at a time (cv2's limit);
    the f32 warp of 1, 3 or 4 channels treats each channel alone, so one
    band at a time gives the same pixels. cv2 warps a 2-channel chunk (the
    last of 10 bands) by its older fixed-point remap, which differs."""
    img = seeded_image(3, 50, 70, 10)
    m = cv2.getRotationMatrix2D((35, 25), 17.0, 0.8)
    fours = np.concatenate([imgproc.as_hwc(imgproc.warp_affine(np.ascontiguousarray(img[..., i:i + 4]), m, (64, 48)))
                            for i in range(0, 8, 4)], 2)
    single = np.stack([imgproc.warp_affine(np.ascontiguousarray(img[..., i]), m, (64, 48)) for i in range(8)], -1)
    np.testing.assert_array_equal(fours, single)
    two = imgproc.warp_affine(np.ascontiguousarray(img[..., 8:]), m, (64, 48))
    np.testing.assert_array_equal(two, cv2.warpAffine(np.ascontiguousarray(img[..., 8:]), m, (64, 48),
                                                      borderValue=(114,) * 4))
    assert (two != np.stack([imgproc.warp_affine(np.ascontiguousarray(img[..., i]), m, (64, 48))
                             for i in (8, 9)], -1)).any()


def test_ycrcb_equalize_blur_resize_rotation_match_cv2():
    img = all_colours()
    np.testing.assert_array_equal(imgproc.bgr2ycrcb(img), cv2.cvtColor(img, cv2.COLOR_BGR2YCrCb))
    np.testing.assert_array_equal(imgproc.ycrcb2bgr(img), cv2.cvtColor(img, cv2.COLOR_YCrCb2BGR))
    rng = np.random.RandomState(0)
    for k in range(20):
        h, w = rng.randint(1, 200, 2)
        gray = np.clip(rng.normal(rng.uniform(0, 255), rng.uniform(0.5, 80), (h, w)), 0, 255).astype(np.uint8)
        np.testing.assert_array_equal(imgproc.equalize_hist(gray), cv2.equalizeHist(gray))
        im = seeded_image(k, max(h, 2), max(w, 2))
        np.testing.assert_array_equal(imgproc.gaussian_blur3(im), cv2.GaussianBlur(im, (3, 3), 0))
        size = tuple(int(v) for v in rng.randint(1, 300, 2))
        np.testing.assert_array_equal(imgproc.resize_linear(im, size),
                                      cv2.resize(im, size, interpolation=cv2.INTER_LINEAR))
        center, angle, scale = (rng.uniform(0, 100), rng.uniform(0, 100)), rng.uniform(-180, 180), rng.uniform(0.3, 2)
        np.testing.assert_array_equal(imgproc.rotation_matrix_2d(center, angle, scale),
                                      cv2.getRotationMatrix2D(center, angle, scale))
    np.testing.assert_array_equal(imgproc.equalize_hist(np.full((5, 6), 77, np.uint8)),
                                  cv2.equalizeHist(np.full((5, 6), 77, np.uint8)))


# -- the transforms --------------------------------------------------------------
def raised_in(err: ValueError) -> str:
    """The class whose __call__ raised err (the JAX MixUp and CutMix fail
    where the other sample's image does not fit: ROADMAP.md section 3)."""
    tb = err.__traceback__
    while tb.tb_next is not None:
        tb = tb.tb_next
    return type(tb.tb_frame.f_locals.get("self")).__name__


def raises_as_jax(err: ValueError, port_call):
    """The JAX transform raised err in MixUp or CutMix: the port raises there too."""
    assert raised_in(err) in ("MixUp", "CutMix"), err
    with pytest.raises(ValueError, match=raised_in(err)):
        port_call()


def both(jax_t, port_t, labels: dict, seed: int):
    """(JAX output, port output) of one labels dict, both seeded with seed;
    None where the JAX MixUp or CutMix raised (and the port's did too)."""
    random.seed(seed)
    np.random.seed(seed)
    try:
        got_j = jax_t(copy.deepcopy(labels))
    except ValueError as err:
        raises_as_jax(err, lambda: port_t(copy.deepcopy(labels), random.Random(seed), np.random.RandomState(seed)))
        return None
    after_j = (random.random(), np.random.random())
    rng, nprng = random.Random(seed), np.random.RandomState(seed)
    got_p = port_t(copy.deepcopy(labels), rng, nprng)
    assert (rng.random(), nprng.random()) == after_j, "the two consumed different draws"
    return got_j, got_p


def assert_same_labels(got, want, img_tol=IMG_TOL):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        if k == "img":
            assert g.shape == w.shape and g.dtype == w.dtype
            assert np.abs(g.astype(int) - w.astype(int)).max(initial=0) <= img_tol, k
        elif k == "segments":
            assert len(g) == len(w)
            for a, b in zip(g, w):
                np.testing.assert_allclose(a, b, rtol=0, atol=PX_TOL)
        elif isinstance(w, np.ndarray):
            assert g.shape == w.shape, k
            np.testing.assert_allclose(g, w, rtol=0, atol=PX_TOL, err_msg=k)
        else:
            assert g == w, k


def labels_dict(seed: int, h: int = 70, w: int = 90, n: int = 6, c: int = 3, keypoints: bool = False,
                segments: bool = False, rotated: bool = False) -> dict:
    rng = np.random.RandomState(seed)
    xy = rng.uniform(0, [w * 0.7, h * 0.7], (n, 2))
    wh = rng.uniform(4, [w * 0.3, h * 0.3], (n, 2))
    boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    out = {"img": seeded_image(seed, h, w, c), "cls": rng.randint(0, 3, n).astype(np.float32), "bboxes": boxes}
    if rotated:
        out["bboxes"] = np.concatenate([xy + wh / 2, wh, rng.uniform(-1, 1, (n, 1))], 1).astype(np.float32)
    if keypoints:
        k = rng.uniform(0, [w, h], (n, 5, 2))
        out["keypoints"] = np.concatenate([k, rng.randint(0, 3, (n, 5, 1))], -1).astype(np.float32)
    if segments:
        out["segments"] = [rng.uniform(0, [w, h], (int(rng.randint(3, 9)), 2)).astype(np.float32) for _ in range(n)]
    return out


class FakeSet:
    """The dataset side of Mosaic, MixUp, CutMix: seeded samples by index."""

    def __init__(self, c: int = 3):
        self.c = c

    def __len__(self):
        return 9

    def get_image_and_label(self, i: int):
        return labels_dict(100 + i, h=50 + 7 * i, w=80 - 3 * i, c=self.c)


@pytest.mark.parametrize("seed", range(4))
def test_hsv_and_flips_match_jax(seed):
    lb = labels_dict(seed, keypoints=True, segments=True)
    assert_same_labels(*both(jaug.RandomHSV(0.5, 0.7, 0.4), paug.RandomHSV(0.5, 0.7, 0.4), lb, seed)[::-1])
    gray = {**lb, "img": lb["img"][..., :1].copy()}  # not 3 channels: no draw, no change
    assert_same_labels(*both(jaug.RandomHSV(), paug.RandomHSV(), gray, seed)[::-1])
    for direction in ("horizontal", "vertical"):
        for flip_idx in (None, FLIP_IDX):
            for d in (lb, labels_dict(seed, rotated=True)):
                assert_same_labels(*both(jaug.RandomFlip(0.5, direction, flip_idx),
                                         paug.RandomFlip(0.5, direction, flip_idx), d, seed)[::-1])


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("channels", [3, 10])
def test_random_perspective_matches_jax(seed, channels):
    """Rotation, scale, shear, translation; perspective on odd seeds; the
    mosaic border on seeds 0 and 1; 10 bands warped 4 at a time."""
    kw = dict(degrees=10.0, translate=0.1, scale=0.5, shear=5.0, perspective=0.0005 if seed % 2 else 0.0)
    lb = labels_dict(seed, h=90, w=110, c=channels)
    if seed < 2:
        lb["mosaic_border"] = (-24, -24)
    got_j, got_p = both(jaug.RandomPerspective(**kw), paug.RandomPerspective(**kw), lb, seed)
    assert_same_labels(got_p, got_j)
    assert np.array_equal(got_p["img"], got_j["img"])  # the copies are exact


@pytest.mark.parametrize("seed", range(6))
def test_mosaic_copy_paste_mixup_cutmix_match_jax(seed):
    for make in (lambda m, s: m.Mosaic(s, imgsz=64, p=0.8), lambda m, s: m.CopyPaste(s, p=0.7),
                 lambda m, s: m.MixUp(s, p=0.7), lambda m, s: m.CutMix(s, p=0.7)):
        lb = labels_dict(seed, h=50, w=80, n=4)  # FakeSet's first image: MixUp draws it on some seeds
        out = both(make(jaug, FakeSet()), make(paug, FakeSet()), lb, seed)
        if out is not None:
            assert_same_labels(*out[::-1])
    box = np.array([[2, 2, 20, 20], [25, 40, 35, 60]], np.float32)  # the first box's mirror is clear: pasted
    lb = {**labels_dict(seed, h=64, w=64, n=2), "bboxes": box}
    got_j, got_p = both(jaug.CopyPaste(p=1.0), paug.CopyPaste(p=1.0), lb, seed)
    assert len(got_p["bboxes"]) == 3
    assert_same_labels(got_p, got_j)


@pytest.mark.parametrize("name", ["CutMix", "MixUp"])
def test_mixup_cutmix_with_an_image_that_does_not_fit_raise_as_jax(name):
    """A 100 x 100 image against others of 50-106 x 56-80: the JAX MixUp
    raises on any such pair, its CutMix where the region passes the other
    image; the port's raise on the same seeds and match the JAX output on
    the others."""
    raised = same = 0
    for seed in range(30):
        lb = labels_dict(seed, h=100, w=100, n=2)
        out = both(getattr(jaug, name)(FakeSet(), p=1.0), getattr(paug, name)(FakeSet(), p=1.0), lb, seed)
        if out is None:
            raised += 1
            continue
        assert_same_labels(*out[::-1])
        same += 1
    assert raised and (same or name == "MixUp")


class SquareSet(FakeSet):
    """Square 48 px samples, as a set of square images loads at imgsz 48:
    MixUp and CutMix fit the warped mosaic."""

    def get_image_and_label(self, i: int):
        return labels_dict(100 + i, h=48, w=48, c=self.c)


@pytest.mark.parametrize("seed", range(6))
def test_v8_transforms_match_jax(seed):
    """The whole detect pipeline and its letterbox, every branch's p above 0."""
    lb = labels_dict(seed, h=48, w=40, n=5)
    tj = jaug.Compose(jaug.v8_transforms(SquareSet(), 48, HYP).transforms + [jaug.LetterBox((48, 48), scaleup=True)])
    tp = paug.Compose(paug.v8_transforms(SquareSet(), 48, HYP).transforms + [paug.LetterBox((48, 48), scaleup=True)])
    got_j, got_p = both(tj, tp, lb, seed)
    assert_same_labels(got_p, got_j)


@pytest.mark.parametrize("op", range(8))
def test_randaugment_ops_match_jax(op):
    for seed in range(3):
        im = seeded_image(seed, 40, 56)
        random.seed(seed)
        want = jaug._RANDAUG_OPS[op](im.copy(), 9)
        got = paug.RANDAUG_OPS[op](im.copy(), 9, random.Random(seed))
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", range(8))
def test_classify_augmentations_match_jax(seed):
    """RandomResizedCrop, the flip, RandAugment (2 ops) and RandomErasing at p = 0.9."""
    im = seeded_image(seed, 60 + seed, 80)
    random.seed(seed)
    np.random.seed(seed)
    want = jaug.classify_augmentations(48, erasing=0.9)(im)
    got = paug.classify_augmentations(48, erasing=0.9)(im, random.Random(seed), np.random.RandomState(seed))
    np.testing.assert_array_equal(got, want)


# -- the datasets ------------------------------------------------------------------
TASK_SETS = {"detect": "torch_val_synth", "segment": "torch_val_synth_segment", "pose": "torch_val_synth_pose",
             "obb": "torch_val_synth_obb"}


@pytest.fixture(scope="module")
def sets(tmp_path_factory):
    """The four task fixture sets, copied (the JAX dataset writes a label cache)."""
    root = tmp_path_factory.mktemp("aug_sets")
    return {task: shutil.copytree(Path(FIXTURES) / name, root / name) for task, name in TASK_SETS.items()}


def dataset_pair(sets, task: str, imgsz: int = 96, **kw):
    data = {"names": {i: f"shape{i}" for i in range(3)}, "nc": 3}
    if task == "pose":
        data.update(kpt_shape=[5, 3], flip_idx=FLIP_IDX)
    path = str(sets[task] / "images" / "val")
    return (jds.YOLODataset(path, imgsz=imgsz, augment=True, hyp=HYP, data=data, task=task, **kw),
            pds.YOLODataset(path, imgsz=imgsz, augment=True, hyp=HYP, data=data, task=task, **kw))


def sample_pair(jset, pset, i: int, seed: int):
    """(port sample, JAX sample) of index i seeded with seed; None where the
    JAX dataset's MixUp or CutMix raised (and the port's did too)."""
    random.seed(seed)
    np.random.seed(seed)
    try:
        want = jset[i]
    except ValueError as err:
        raises_as_jax(err, lambda: pset.sample(i, random.Random(seed), np.random.RandomState(seed)))
        return None
    return pset.sample(i, random.Random(seed), np.random.RandomState(seed)), want


def comparable(labels: dict) -> dict:
    return {k: v for k, v in labels.items() if k in ("img", "cls", "bboxes", "keypoints", "segments", "ratio_pad",
                                                     "resized_shape")}


@pytest.mark.parametrize("task", list(TASK_SETS))
def test_augmented_dataset_matches_jax(sets, task):
    jset, pset = dataset_pair(sets, task)
    assert [type(t).__name__ for t in pset.transforms.transforms] == \
        [type(t).__name__ for t in jset.transforms.transforms]
    compared = 0
    for i, seed in zip(list(range(16)) * 2, range(32)):
        out = sample_pair(jset, pset, i, seed)
        if out is None:  # detect: MixUp or CutMix drew an image that does not fit
            continue
        got, want = out
        assert_same_labels(comparable(got), comparable(want), img_tol=DATASET_IMG_TOL)
        compared += 1
        if compared == 6:
            break
    assert compared == 6


def test_close_mosaic_turns_off_the_same_transforms(sets):
    jset, pset = dataset_pair(sets, "detect")
    jset.close_mosaic()
    pset.close_mosaic()
    ps = {type(t).__name__: getattr(t, "p", None) for t in jset.transforms.transforms}
    assert ps == {type(t).__name__: getattr(t, "p", None) for t in pset.transforms.transforms}
    assert ps["Mosaic"] == ps["MixUp"] == ps["CutMix"] == ps["CopyPaste"] == 0.0 and ps["RandomFlip"] == 0.5
    for i, seed in ((0, 1), (5, 2)):
        got, want = sample_pair(jset, pset, i, seed)
        assert got["img"].shape == (96, 96, 3)
        assert_same_labels(comparable(got), comparable(want), img_tol=DATASET_IMG_TOL)


def test_augmented_classify_dataset_matches_jax():
    root = Path(FIXTURES) / "torch_cls_synth" / "train"
    jset = jds.ClassificationDataset(root, imgsz=48, augment=True)
    pset = pds.ClassificationDataset(root, imgsz=48, augment=True)
    for i, seed in zip(range(0, 24, 3), range(8)):
        random.seed(seed)
        np.random.seed(seed)
        want = jset[i]
        got = pset.sample(i, random.Random(seed), np.random.RandomState(seed))
        assert got["cls"] == want["cls"]
        assert np.abs(got["img"].astype(int) - want["img"].astype(int)).max() <= DATASET_IMG_TOL


def test_sample_generators_do_not_depend_on_order(sets):
    """The port's loader: a sample's draws come from (seed, epoch, index),
    so reading in another order gives the same samples, and the next epoch
    other ones."""
    _, pset = dataset_pair(sets, "detect")
    pset.hyp = {**HYP, "cutmix": 0.0, "mixup": 0.0}
    pset.transforms = pset.build_transforms()
    first = [pset[i]["img"] for i in (3, 7)]
    assert np.array_equal(pset[7]["img"], first[1]) and np.array_equal(pset[3]["img"], first[0])
    pset.epoch = 1
    assert not np.array_equal(pset[3]["img"], first[0])
