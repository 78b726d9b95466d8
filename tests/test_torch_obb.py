"""The port's OBB (oriented box) path against the JAX package, on the CPU.

Ops: `dist2rbox`, `xywhr2xyxyxyxy`, `probiou` and `batch_probiou` on seeded
inputs within 1e-6 (probiou within 1e-6 absolute; XLA's and torch's log,
sqrt and exp differ by ulps). `non_max_suppression_rotated` on seeded rows
with score ties, rows below conf, a row all below conf, agnostic on and off,
K below and at max_nms = 4096, and more rows than one probiou pass holds:
the kept candidates' indices, valid flags and cls equal, rboxes and scores
within 1e-6. A pair whose probiou sits within 1e-6 of iou_thres could be
suppressed in one package and not in the other: the k4096 row has one, and
both packages put it on the same side (`test_rotated_nms_pairs_near_the_
threshold_fall_on_the_same_side`).

Modules: the `OBB` head on weights carried from JAX, and yolov8n-obb at 64 px
through the carrier both ways, within 1e-4 of each output's largest magnitude.

Data: `min_area_rect` against cv2.minAreaRect (OpenCV 5.0.0 here) bit for
bit on the fixture set's labels and on 1,000 seeded point sets (rotated
rectangles, rectangles clipped as the synthetic generator clips them,
squares at 0, 45 and 90 degrees, axis-aligned rectangles, any quadrilateral,
integer points that may be collinear); `poly2xywhr` against the JAX
dataset's `_poly2xywhr`; labels, the rotated letterbox and the collate
against the JAX dataset and `collate_detect`, equal. The collate's rotated
test departs from the JAX one where a batch's first image has no objects
(pinned below).

The slice: the reference-trained yolov8n-obb (`val_parity_obb_model.npz`,
nc 3) through `YOLO(...).val` on the committed PNG set
`tests/fixtures/torch_val_synth_obb/`: box mAP50 and mAP50-95 within 1e-3 of
the JAX OBBValidator on the same files and within 0.005 of
`val_parity_obb_ref.json`; `save_json` writes the JAX validator's DOTA files;
predict against the JAX OBBPredictor: rboxes within 1e-3 px. The fixture set
is regenerated by `tests/test_torch_segment.py:make_task_fixture`
(`python -m tests.test_torch_obb`).
"""

import json
import shutil
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from chip_smoke import metric
from tests.conftest import FIXTURES
from tests.test_torch_modules import nchw, randomize, to_nhwc, torch_threads  # noqa: F401
from tests.test_torch_segment import (
    assert_close_to_largest,
    assert_fixture_equals_a_fresh_regeneration,
    jax_parity_model,
    make_task_fixture,
    parity_model,
)
from ultralytics_pro_tpu_torch import YOLO
from ultralytics_pro_tpu_torch.data import LetterBox, YOLODataset, check_det_dataset, collate_detect
from ultralytics_pro_tpu_torch.data.geometry import min_area_rect, poly2xywhr
from ultralytics_pro_tpu_torch.nn.modules.head import OBB
from ultralytics_pro_tpu_torch.nn.tasks import OBBModel
from ultralytics_pro_tpu_torch.ops import anchors as port_anchors
from ultralytics_pro_tpu_torch.ops import boxes as port_boxes
from ultralytics_pro_tpu_torch.ops import iou as port_iou
from ultralytics_pro_tpu_torch.ops import nms as port_nms
from ultralytics_pro_tpu_torch.utils import metrics as port_metrics
from ultralytics_pro_tpu_torch.utils.weights import jax_to_torch_state_dict, torch_state_dict_to_jax

SET = Path(FIXTURES) / "torch_val_synth_obb"
REF = json.loads((Path(FIXTURES) / "val_parity_obb_ref.json").read_text())
VAL_KW = dict(imgsz=REF["val_args"]["imgsz"], batch=8, conf=REF["val_args"]["conf"],
              iou=REF["val_args"]["iou"], max_det=REF["val_args"]["max_det"])
T = torch.from_numpy


@pytest.fixture(scope="module")
def fixture_copy(tmp_path_factory) -> Path:
    """The committed set, copied (the JAX loader writes a label cache)."""
    return Path(shutil.copytree(SET, tmp_path_factory.mktemp("obb") / "set"))


def test_fixture_equals_a_fresh_regeneration(tmp_path):
    assert_fixture_equals_a_fresh_regeneration(tmp_path, SET, REF)


# -- rotated-box ops ----------------------------------------------------------

def _rboxes(rng, shape, lo=0.0, hi=300.0):
    """Seeded xywhr boxes of the given leading shape, angles in [-pi/4, 3pi/4)."""
    xy = rng.uniform(lo, hi, (*shape, 2))
    wh = rng.uniform(2, 80, (*shape, 2))
    ang = rng.uniform(-np.pi / 4, 3 * np.pi / 4, (*shape, 1))
    return np.concatenate([xy, wh, ang], -1).astype(np.float32)


def test_dist2rbox_matches_jax():
    from ultralytics_pro_tpu.ops.anchors import dist2rbox

    rng = np.random.default_rng(0)
    dist = rng.uniform(0, 15, (2, 300, 4)).astype(np.float32)
    angle = rng.uniform(-np.pi / 4, 3 * np.pi / 4, (2, 300, 1)).astype(np.float32)
    anchors = rng.uniform(0, 80, (300, 2)).astype(np.float32)
    got = port_anchors.dist2rbox(T(dist), T(angle), T(anchors)[None]).numpy()
    np.testing.assert_allclose(got, dist2rbox(dist, angle, anchors[None]), atol=1e-5, rtol=0)


def test_xywhr2xyxyxyxy_matches_jax_for_tensors_and_arrays():
    from ultralytics_pro_tpu.ops.boxes import xywhr2xyxyxyxy

    rb = _rboxes(np.random.default_rng(1), (3, 50))
    want = np.asarray(xywhr2xyxyxyxy(rb))
    assert want.shape == (3, 50, 4, 2)
    np.testing.assert_allclose(port_boxes.xywhr2xyxyxyxy(T(rb)).numpy(), want, atol=1e-4, rtol=0)
    got = port_boxes.xywhr2xyxyxyxy(rb)
    assert isinstance(got, np.ndarray)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_probiou_and_batch_probiou_match_jax():
    from ultralytics_pro_tpu.ops import iou as jiou

    rng = np.random.default_rng(2)
    a, b = _rboxes(rng, (40,), hi=100.0), _rboxes(rng, (60,), hi=100.0)
    b[:5] = a[:5]  # identical pairs: the self-probiou, clipped at eps
    np.testing.assert_allclose(port_iou.probiou(T(a[:40]), T(b[:40])).numpy(), jiou.probiou(a[:40], b[:40]),
                               atol=1e-6, rtol=0)
    got = port_iou.batch_probiou(T(a), T(b)).numpy()
    assert got.shape == (40, 60)
    np.testing.assert_allclose(got, jiou.batch_probiou(a, b), atol=1e-6, rtol=0)
    assert (got > 0.01).sum() > 20  # overlapping pairs, not only the far ones


# (rows, anchors, classes, max_nms) of the NMS cases: K below and at 4096
NMS_CASES = {"k600": (3, 600, 4, 4096), "k4096": (1, 5000, 3, 4096), "k300_of_600": (2, 600, 2, 300)}


def _nms_rows(case: str):
    """Seeded (B, A, 5) rboxes and (B, A, nc) scores: clusters of boxes so
    that suppression happens, scores on a grid of 1/32 (ties) in row 0, most
    of row 1 below conf 0.25 and, with 3 rows, row 2 all below it."""
    b, a, nc, max_nms = NMS_CASES[case]
    rng = np.random.default_rng(len(case) * 7 + a)
    centres = rng.uniform(0, 500, (b, a // 6 + 1, 2))
    pick = rng.integers(0, centres.shape[1], (b, a))
    xy = np.take_along_axis(centres, pick[..., None], 1) + rng.normal(0, 6, (b, a, 2))
    wh = rng.uniform(8, 60, (b, a, 2))
    ang = rng.uniform(-np.pi / 4, 3 * np.pi / 4, (b, a, 1))
    rb = np.concatenate([xy, wh, ang], -1).astype(np.float32)
    scores = rng.uniform(0, 1, (b, a, nc)).astype(np.float32)
    scores[0] = np.ceil(scores[0] * 32) / 32
    if b > 1:
        scores[1] *= np.where(rng.uniform(0, 1, (a, 1)) < 0.8, 0.2, 1.0).astype(np.float32)
    if b > 2:
        scores[2] *= 0.2
    return rb, scores, max_nms


def _kept_indices(out, rb, scores, conf, max_nms):
    """Each kept slot's candidate index in the top-k order, from its rbox,
    the valid slots only."""
    masked = np.where(scores.max(-1) > conf, scores.max(-1), -1.0)
    order = np.argsort(-masked, axis=-1, kind="stable")[:, :min(max_nms, rb.shape[1])]
    idx = []
    for i in range(rb.shape[0]):
        lookup = {tuple(r): j for j, r in enumerate(rb[i][order[i]].tolist())}
        n = int(np.asarray(out["valid"][i]).sum())
        idx.append([lookup[tuple(r)] for r in np.asarray(out["rboxes"][i][:n]).tolist()])
    return idx


@pytest.mark.parametrize("agnostic", [False, True], ids=["per_class", "agnostic"])
@pytest.mark.parametrize("case", list(NMS_CASES))
def test_rotated_nms_matches_jax(case, agnostic):
    from ultralytics_pro_tpu.ops.nms import non_max_suppression_rotated as jnms

    rb, scores, max_nms = _nms_rows(case)
    kw = dict(conf_thres=0.25, iou_thres=0.45, max_det=300, max_nms=max_nms, agnostic=agnostic)
    ref = {k: np.asarray(v) for k, v in jnms(rb, scores, **kw).items()}
    got = {k: v.numpy() for k, v in port_nms.non_max_suppression_rotated(T(rb), T(scores), **kw).items()}
    assert got.keys() == ref.keys() and got["rboxes"].shape == (rb.shape[0], 300, 5)
    counts = got["valid"].sum(1)
    assert counts.max() > 0 and (counts.min() < 300 or rb.shape[0] == 1), counts  # a row runs out
    for k in ("valid", "cls"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert _kept_indices(got, rb, scores, 0.25, max_nms) == _kept_indices(ref, rb, scores, 0.25, max_nms)
    for k in ("rboxes", "scores"):
        np.testing.assert_allclose(got[k], ref[k], atol=1e-6, rtol=0, err_msg=k)
    if rb.shape[0] > 2:  # the all-below row: no valid slot, candidate 0 with score 0 and cls 0
        assert not got["valid"][2].any() and not got["scores"][2].any() and not got["cls"][2].any()


@pytest.mark.parametrize("case", list(NMS_CASES))
def test_rotated_nms_pairs_near_the_threshold_fall_on_the_same_side(case):
    """XLA's and torch's log, sqrt and exp differ by ulps, so a pair whose
    probiou sits within 1e-6 of iou_thres (0.45) could be suppressed in one
    package and not in the other. Such pairs are found here, class-offset and
    agnostic, and each must fall on the same side in both. Found: one pair on
    the k4096 row (candidates 1137 and 2129, one class, class-offset), at
    0.44999957 in both packages, 4.2e-7 below the threshold; none elsewhere."""
    from ultralytics_pro_tpu.ops.iou import batch_probiou as jbatch_probiou

    rb, scores, max_nms = _nms_rows(case)
    conf = scores.max(-1)
    near = 0
    for i in range(rb.shape[0]):
        order = np.argsort(-np.where(conf[i] > 0.25, conf[i], -1.0), kind="stable")[:max_nms]
        cand = T(rb[i][order])
        off = T(scores[i][order].argmax(-1).astype(np.float32))[:, None] * 7680.0
        for c in (cand, torch.cat([cand[:, :2] + off, cand[:, 2:]], -1)):
            got = port_iou.batch_probiou(c, c).numpy()
            close = np.abs(got - 0.45) <= 1e-6
            if close.any():
                want = np.asarray(jbatch_probiou(c.numpy(), c.numpy()))
                np.testing.assert_array_equal(got[close] > 0.45, want[close] > 0.45)
                near += int(close.sum())
    assert near == {"k4096": 2}.get(case, 0), near  # the k4096 pair, as (j, k) and (k, j)


def test_rotated_nms_in_several_passes_equals_one_pass(monkeypatch):
    rb, scores, _ = _nms_rows("k600")
    kw = dict(conf_thres=0.25, iou_thres=0.45, max_det=300)
    one = port_nms.non_max_suppression_rotated(T(rb), T(scores), **kw)
    monkeypatch.setattr(port_nms, "ROTATED_PAIRS", 600 * 600)  # one row a pass
    several = port_nms.non_max_suppression_rotated(T(rb), T(scores), **kw)
    for k in one:
        assert torch.equal(one[k], several[k]), k


def test_rotated_nms_keeps_a_box_that_suppresses_nothing_once_per_step():
    """At iou_thres above the self-probiou (1 - sqrt(2e-7) ~ 0.99955) a pick
    does not suppress itself, so the JAX loop takes it again at every step;
    the port does the same."""
    from ultralytics_pro_tpu.ops.nms import non_max_suppression_rotated as jnms

    rb, scores, _ = _nms_rows("k600")
    kw = dict(conf_thres=0.25, iou_thres=0.9999, max_det=5)
    ref = jnms(rb[:1], scores[:1], **kw)
    got = port_nms.non_max_suppression_rotated(T(rb[:1]), T(scores[:1]), **kw)
    np.testing.assert_array_equal(got["rboxes"].numpy(), np.asarray(ref["rboxes"]))
    assert (got["rboxes"][0] == got["rboxes"][0, :1]).all()


# -- the head and the model ---------------------------------------------------

def test_obb_head_matches_jax_on_carried_weights():
    import jax

    from ultralytics_pro_tpu.nn.modules.head import OBB as JOBB

    rng = np.random.default_rng(4)
    strides, nc, chs = (8, 16, 32), 5, (16, 32, 64)
    feats = [rng.normal(0, 1, (2, 64 // s, 64 // s, c)).astype(np.float32) for s, c in zip(strides, chs)]
    jm = JOBB(nc=nc, ne=1, strides=strides)
    v = randomize(jm.init(jax.random.PRNGKey(0), feats), 5)
    tm = OBB(nc=nc, ch=chs, ne=1)
    tm.load_state_dict(jax_to_torch_state_dict(v))
    tm.stride = torch.tensor(strides, dtype=torch.float32)
    tm.eval()
    y_ref, aux = jm.apply(v, feats)
    with torch.no_grad():
        y, got = tm([nchw(f) for f in feats])
    assert y.shape == (2, sum((64 // s) ** 2 for s in strides), 4 + nc + 1)
    assert_close_to_largest(y.numpy(), y_ref, what="y")
    assert_close_to_largest(got["angle"].numpy(), aux["angle"], what="angle")
    for r, rr in zip(got["feats"], aux["feats"]):
        assert_close_to_largest(to_nhwc(r), rr, what="feats")
    assert set(tm([nchw(f) for f in feats], decode=False)) == {"feats", "angle"}


def test_obb_model_carries_both_ways_and_matches_jax():
    """yolov8n-obb at 64 px: JAX variables -> port -> JAX exact (cv4_i <-> cv4.i),
    and the decoded outputs and angles agree."""
    import jax.numpy as jnp

    from ultralytics_pro_tpu.nn.tasks import OBBModel as JModel

    jm = JModel("yolov8n-obb.yaml")
    v = randomize(jm.init_params(imgsz=64), 7)
    tm = OBBModel("yolov8n-obb.yaml")
    tm.load_state_dict(jax_to_torch_state_dict(v))  # strict
    back = torch_state_dict_to_jax(tm.state_dict())
    flat = lambda t, p=(): [x for k, s in t.items() for x in (flat(s, (*p, k)) if hasattr(s, "items") else [((*p, k), s)])]  # noqa: E731
    a, b = dict(flat(v)), dict(flat(back))
    assert a.keys() == b.keys() and ("params", "layers_22", "cv4_2_2", "kernel") in a
    assert "model.22.cv4.2.2.weight" in tm.state_dict()
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), b[k], err_msg=str(k))
    x = np.random.default_rng(8).uniform(0, 1, (1, 64, 64, 3)).astype(np.float32)
    y_ref, aux = jm.apply(v, jnp.asarray(x), train=False)
    with torch.no_grad():
        y, got = tm(nchw(x))
    assert y.shape == (1, 84, 4 + 15 + 1)
    assert_close_to_largest(y.numpy(), y_ref, what="y")
    assert_close_to_largest(got["angle"].numpy(), aux["angle"], what="angle")


# -- minAreaRect and the labels -----------------------------------------------

def _cv2_rect(pts):
    (cx, cy), (w, h), a = cv2.minAreaRect(np.asarray(pts, np.float32))
    return [cx, cy, w, h, a]


def _rect(pts):
    (cx, cy), (w, h), a = min_area_rect(pts)
    return [cx, cy, w, h, a]


QUADS = ("rotated", "clipped", "square", "axis_aligned", "any", "integer")


def _seeded_points(rng, kind):
    """One seeded point set: a rotated rectangle's corners (cv2.boxPoints), one
    clipped to [2, min(ih, iw) - 2] as the synthetic OBB generator clips them,
    a square at 0, 45 or 90 degrees, an axis-aligned rectangle in any corner
    order, any 4 points, or 4 integer points on a small grid (collinear and
    repeated points among them)."""
    if kind in ("rotated", "clipped"):
        ih, iw = (int(v) for v in rng.choice([120, 160, 200], 2))
        w, h = (int(v) for v in rng.integers(16, 60, 2))
        x, y = int(rng.integers(0, iw - w)), int(rng.integers(0, ih - h))
        pts = cv2.boxPoints(((x + w / 2, y + h / 2), (w, h), float(rng.uniform(-60, 60))))
        return np.clip(pts, 2, min(ih, iw) - 2) if kind == "clipped" else pts
    if kind == "square":
        s = int(rng.integers(4, 40))
        c = rng.uniform(20, 80, 2)
        return cv2.boxPoints(((float(c[0]), float(c[1])), (s, s), float(rng.choice([0.0, 45.0, 90.0]))))
    if kind == "axis_aligned":
        x, y = rng.integers(0, 50, 2)
        w, h = rng.integers(1, 40, 2)
        return np.array([[x, y], [x + w, y], [x + w, y + h], [x, y + h]], np.float32)[rng.permutation(4)]
    if kind == "any":
        return rng.uniform(0, 100, (4, 2)).astype(np.float32)
    return rng.integers(0, 8, (4, 2)).astype(np.float32)


@pytest.mark.parametrize("kind", QUADS)
def test_min_area_rect_equals_cv2_on_seeded_points(kind):
    """1,000 point sets in all (six kinds), every value equal to cv2's."""
    rng = np.random.default_rng(QUADS.index(kind))
    for _ in range(1000 // len(QUADS) + (QUADS.index(kind) < 1000 % len(QUADS))):
        pts = np.asarray(_seeded_points(rng, kind), np.float32)
        assert _rect(pts) == _cv2_rect(pts), pts.tolist()
        np.testing.assert_array_equal(poly2xywhr(pts), _jax_poly2xywhr(pts), err_msg=str(pts.tolist()))


def _jax_poly2xywhr(pts):
    from ultralytics_pro_tpu.data.dataset import YOLODataset as JDataset

    return JDataset._poly2xywhr(pts)


def test_min_area_rect_equals_cv2_on_fixture_labels(fixture_copy):
    """Every label's corners in the resized image's pixels, as the dataset
    hands them to minAreaRect: rectangles, clipped ones among them."""
    d = check_det_dataset(fixture_copy / "data.yaml")
    ds = YOLODataset(d["val"], imgsz=160, data=d, task="obb")
    n = 0
    for i, lb in enumerate(ds.labels):
        h, w = ds.load_image(i)[2]
        for c in lb["corners_n"]:
            pts = c * np.array([w, h], np.float32)
            assert _rect(pts) == _cv2_rect(pts), pts.tolist()
            np.testing.assert_array_equal(poly2xywhr(pts), _jax_poly2xywhr(pts))
            n += 1
    assert n > 30


def test_letterbox_scales_rotated_boxes_and_shifts_their_centres():
    from ultralytics_pro_tpu.data.augment import LetterBox as JLetterBox

    rng = np.random.default_rng(3)
    img = rng.integers(0, 255, (120, 200, 3), dtype=np.uint8)
    rb = _rboxes(rng, (6,), hi=110.0)
    got = LetterBox((160, 160), scaleup=False)({"img": img.copy(), "bboxes": rb.copy(), "ratio_pad": (1.0, 1.0)})
    want = JLetterBox((160, 160), scaleup=False)({"img": img.copy(), "bboxes": rb.copy(), "ratio_pad": (1.0, 1.0)})
    np.testing.assert_allclose(got["bboxes"], want["bboxes"], atol=1e-5, rtol=0)
    r = 160 / 200
    np.testing.assert_allclose(got["bboxes"][:, 2:], rb[:, 2:] * [r, r, 1.0], rtol=1e-6)
    assert got["ratio_pad"] == want["ratio_pad"]


def test_dataset_items_and_collate_match_jax(fixture_copy):
    from ultralytics_pro_tpu.data.build import collate_detect as jcollate
    from ultralytics_pro_tpu.data.dataset import YOLODataset as JDataset
    from ultralytics_pro_tpu.data.utils import check_det_dataset as jcheck

    d = check_det_dataset(fixture_copy / "data.yaml")
    got_ds = YOLODataset(d["val"], imgsz=160, data=d, task="obb")
    want_ds = JDataset(d["val"], imgsz=160, data=jcheck(fixture_copy / "data.yaml"), task="obb")
    got = [got_ds[i] for i in range(len(got_ds))]
    want = [want_ds[i] for i in range(len(want_ds))]
    for g, w in zip(got, want):
        assert g["im_file"] == w["im_file"] and g["bboxes"].shape[1] == 5
        np.testing.assert_array_equal(g["img"], w["img"])
        np.testing.assert_array_equal(g["bboxes"], w["bboxes"])
        np.testing.assert_array_equal(g["cls"], w["cls"])
        assert g["ratio_pad"] == w["ratio_pad"]
    for lo in range(0, 16, 8):
        gb, wb = collate_detect(got[lo:lo + 8], max_gt=8), jcollate(want[lo:lo + 8], max_gt=8)
        assert gb["bboxes"].shape == wb["bboxes"].shape == (8, 8, 5)
        for k in ("cls", "mask_gt", "bboxes"):
            np.testing.assert_array_equal(gb[k], wb[k], err_msg=k)


def test_collate_keeps_boxes_rotated_when_the_first_image_has_none(fixture_copy):
    """The port asks every sample whether its boxes are (n, 5), an empty
    (0, 5) too. The JAX collate asks samples[0] only, and only when it has
    objects: with an empty first image it reads the others' xywhr as xyxy
    (ROADMAP.md section 3); the port's batch equals the JAX one of the same
    samples with the empty image moved last."""
    from ultralytics_pro_tpu.data.build import collate_detect as jcollate

    d = check_det_dataset(fixture_copy / "data.yaml")
    ds = YOLODataset(d["val"], imgsz=160, data=d, task="obb")
    items = [ds[i] for i in range(3)]
    empty = {**items[0], "cls": np.zeros((0,), np.float32), "bboxes": np.zeros((0, 5), np.float32)}
    got = collate_detect([empty, *items[1:]], max_gt=6)
    assert got["bboxes"].shape == (3, 6, 5) and not got["mask_gt"][0].any()
    moved = jcollate([*items[1:], empty], max_gt=6)
    np.testing.assert_array_equal(got["bboxes"][1:], moved["bboxes"][:2])
    jax_first_empty = jcollate([empty, *items[1:]], max_gt=6)
    assert jax_first_empty["bboxes"].shape == (3, 6, 4)  # the JAX-side difference


def test_obb_metrics_match_jax():
    from ultralytics_pro_tpu.utils import metrics as jm

    names = {i: f"c{i}" for i in range(3)}
    got, want = port_metrics.OBBMetrics(names), jm.OBBMetrics(names)
    rng = np.random.default_rng(1)
    for _ in range(3):
        tp = rng.uniform(0, 1, (40, 10)) < 0.5
        conf = rng.uniform(0, 1, 40).astype(np.float32)
        pred_cls, gt_cls = rng.integers(0, 3, 40).astype(np.float32), rng.integers(0, 3, 9).astype(np.float32)
        for mt in (got, want):
            mt.update_stats(tp, conf, pred_cls, gt_cls)
    got.process(), want.process()
    np.testing.assert_allclose(list(got.results_dict.values()), list(want.results_dict.values()), atol=1e-6)


# -- the slice: val and predict -----------------------------------------------

@pytest.fixture(scope="module")
def port_val(fixture_copy, tmp_path_factory):
    save_dir = tmp_path_factory.mktemp("port_dota")
    m = parity_model("val_parity_obb", "yolov8n-obb.yaml", REF).val(
        data=str(fixture_copy / "data.yaml"), save_json=True, save_dir=str(save_dir), **VAL_KW)
    return m, save_dir


@pytest.fixture(scope="module")
def jax_val(fixture_copy, tmp_path_factory):
    save_dir = tmp_path_factory.mktemp("jax_dota")
    model = jax_parity_model("val_parity_obb", "yolov8n-obb.yaml", REF)
    m = model.val(data=str(fixture_copy / "data.yaml"), plots=False, save_json=True, save_dir=str(save_dir),
                  **VAL_KW)
    return m, save_dir


MAPS = (("box.map50", "metrics/mAP50(B)"), ("box.map", "metrics/mAP50-95(B)"))


@pytest.mark.parametrize("attr,key", MAPS, ids=[a for a, _ in MAPS])
def test_val_map_matches_jax_validator_and_the_reference(port_val, jax_val, attr, key):
    got = metric(port_val[0], attr)
    assert type(port_val[0]).__name__ == "OBBMetrics"
    assert abs(got - metric(jax_val[0], attr)) <= 1e-3, (attr, got, metric(jax_val[0], attr))
    assert abs(got - REF["results"][key]) <= 0.005, (attr, got, REF["results"][key])


def test_save_json_writes_the_jax_validators_dota_files(port_val, jax_val):
    """One Task1_<class>.txt per class, `image_id conf x1 y1 ... y4` rows:
    the same files, the same rows; confidences (4 decimals) and corners
    (2 decimals) may differ by one in the last place."""
    got_dir, want_dir = port_val[1] / "predictions_dota", jax_val[1] / "predictions_dota"
    names = sorted(p.name for p in want_dir.glob("Task1_*.txt"))
    assert names == sorted(p.name for p in got_dir.glob("Task1_*.txt")) and len(names) == 3
    for name in names:
        got = [r.split() for r in (got_dir / name).read_text().splitlines()]
        want = [r.split() for r in (want_dir / name).read_text().splitlines()]
        assert len(got) == len(want) > 16
        assert [r[0] for r in got] == [r[0] for r in want]
        g = np.array([[float(v) for v in r[1:]] for r in got])
        w = np.array([[float(v) for v in r[1:]] for r in want])
        assert np.abs(g[:, 0] - w[:, 0]).max() <= 1.01e-4
        assert np.abs(g[:, 1:] - w[:, 1:]).max() <= 1.01e-2


def test_predict_matches_jax_predictor():
    imgs = [cv2.imread(str(SET / "images" / "val" / f"val{i}.png")) for i in (0, 1, 2)]
    # padded only: a shrunk image goes through the port's bilinear resize, which
    # may differ from cv2's fixed-point one by a grey level (data/augment.py)
    assert {im.shape[:2] for im in imgs} == {(160, 160), (160, 120), (120, 160)}
    kw = dict(imgsz=160, conf=0.25)
    ref = jax_parity_model("val_parity_obb", "yolov8n-obb.yaml", REF).predict(imgs, **kw)
    got = parity_model("val_parity_obb", "yolov8n-obb.yaml", REF).predict(imgs, **kw)
    for g, r in zip(got, ref):
        rd = np.asarray(r.obb.data)
        assert g.boxes is None and 0 < len(g) == len(rd)
        np.testing.assert_array_equal(g.obb.cls, rd[:, 6])
        np.testing.assert_allclose(g.obb.xywhr[:, :4], rd[:, :4], atol=1e-3, rtol=0)
        np.testing.assert_allclose(g.obb.xywhr[:, 4], rd[:, 4], atol=1e-5, rtol=0)
        np.testing.assert_allclose(g.obb.conf, rd[:, 5], atol=1e-5, rtol=0)
        np.testing.assert_allclose(g.obb.xyxyxyxy, np.asarray(r.obb.xyxyxyxy), atol=1e-3, rtol=0)
        np.testing.assert_allclose(g.obb.xyxy, np.asarray(r.obb.xyxy), atol=1e-3, rtol=0)


def test_results_obb_surface():
    img = np.random.default_rng(0).integers(0, 256, (90, 70, 3), dtype=np.uint8)
    r = YOLO("yolov8n-obb.yaml", device="cpu").predict([img], imgsz=64, conf=1e-6)[0]
    assert 0 < len(r) == len(r.obb) <= 300 and r.obb.data.shape[1] == 7
    assert r.obb.xyxyxyxy.shape == (len(r), 4, 2) and r.obb.xyxy.shape == (len(r), 4)
    assert r.obb[:2].data.shape == (2, 7) and r.obb.cpu().numpy() is r.obb.data
    assert np.isfinite(r.obb.data).all()



if __name__ == "__main__":
    target = Path(FIXTURES) / "torch_val_synth_obb"
    shutil.rmtree(target, ignore_errors=True)
    print(make_task_fixture(target, REF))
