"""The port's segment path against the JAX package, on the CPU.

Modules: `Proto` and the `Segment` head on weights carried from JAX (within
1e-4 of each output's largest magnitude), the carrier both ways with
`proto.upsample` (a transposed conv) exact; the mask ops `crop_mask`,
`process_mask`, `process_mask_native` and `scale_masks`, growing and
shrinking, within 1e-5 with the > 0.5 masks equal; NMS with a payload,
single- and multi-label, `keep`/`valid` equal and `extra` within 1e-6.

Data: `fill_poly` and the mask shrink against cv2 (OpenCV 5.0.0 here) bit
for bit, on the fixture set's polygons and on seeded convex and concave
polygons, inside the image, on its edge and crossing it; labels, letterbox
and the collate's masks, cls and boxes against the JAX dataset and
`collate_detect`, equal.

Metrics: `mask_iou_np` within 1e-6, `SegmentMetrics` within 1e-6 of the JAX
class on the same statistics.

The slice: the reference-trained yolov8n-seg (`val_parity_segment_model.npz`)
through `YOLO(...).val` on the committed PNG set
`tests/fixtures/torch_val_synth_segment/`: box and mask mAP50 and mAP50-95
within 1e-3 of the JAX validator on the same files and within 0.005 of
`val_parity_segment_ref.json` (tests/test_val_parity.py's bound); predict
against the JAX SegmentationPredictor: boxes within 1e-3 px, masks equal but
for at most 0.1% of pixels. The JAX side runs on the CPU through its plain
NMS, as its own tests run it.

`make_task_fixture` regenerates a task's fixture set from the JAX generator
(`python -m tests.test_torch_segment` rewrites the committed segment and
pose sets).
"""

import json
import shutil
import tempfile
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from chip_smoke import metric, parity_yolov8n
from tests.conftest import FIXTURES
from tests.test_torch_modules import carry, nchw, randomize, to_nhwc, torch_threads  # noqa: F401
from ultralytics_pro_tpu_torch import YOLO
from ultralytics_pro_tpu_torch.data import DataLoader, YOLODataset, check_det_dataset, collate_detect
from ultralytics_pro_tpu_torch.data.rasterize import fill_poly, resize_linear_u8
from ultralytics_pro_tpu_torch.nn.modules.block import Proto
from ultralytics_pro_tpu_torch.nn.modules.head import Segment
from ultralytics_pro_tpu_torch.nn.tasks import SegmentationModel, yaml_model_load
from ultralytics_pro_tpu_torch.ops import masks as port_masks
from ultralytics_pro_tpu_torch.ops.nms import non_max_suppression
from ultralytics_pro_tpu_torch.utils import metrics as port_metrics
from ultralytics_pro_tpu_torch.utils.weights import jax_to_torch_state_dict, torch_state_dict_to_jax

SET = Path(FIXTURES) / "torch_val_synth_segment"
REF = json.loads((Path(FIXTURES) / "val_parity_segment_ref.json").read_text())
VAL_KW = dict(imgsz=REF["val_args"]["imgsz"], batch=8, conf=REF["val_args"]["conf"],
              iou=REF["val_args"]["iou"], max_det=REF["val_args"]["max_det"])


def make_task_fixture(root, ref: dict) -> Path:
    """Write a task's fixture set under `root`: the JAX package's synthetic set
    with ref's dataset_args, its val JPEGs read by cv2 and written as PNG
    (adaptive filters), the labels, and data.yaml (with pose's kpt_shape)."""
    from ultralytics_pro_tpu.data.synth import make_synth_dataset

    root = Path(root)
    with tempfile.TemporaryDirectory() as tmp:
        src = Path(tmp)
        make_synth_dataset(src, **ref["dataset_args"])
        (root / "images" / "val").mkdir(parents=True, exist_ok=True)
        (root / "labels" / "val").mkdir(parents=True, exist_ok=True)
        for jpg in sorted((src / "images" / "val").glob("*.jpg")):
            cv2.imwrite(str(root / "images" / "val" / f"{jpg.stem}.png"), cv2.imread(str(jpg)),
                        [cv2.IMWRITE_PNG_FILTER, cv2.IMWRITE_PNG_ALL_FILTERS])
            shutil.copy(src / "labels" / "val" / f"{jpg.stem}.txt", root / "labels" / "val")
    names = "".join(f"  {i}: shape{i}\n" for i in range(ref["dataset_args"]["nc"]))
    kpt = "kpt_shape: [5, 3]\n" if ref["task"] == "pose" else ""
    (root / "data.yaml").write_text("val: images/val\n" + kpt + "names:\n" + names)
    return root


def assert_fixture_equals_a_fresh_regeneration(tmp_path, committed: Path, ref: dict):
    files = lambda root: sorted(p.relative_to(root).as_posix() for p in root.rglob("*") if p.is_file())  # noqa: E731
    fresh = make_task_fixture(tmp_path / "fresh", ref)
    assert files(fresh) == files(committed)
    assert len(list((committed / "images" / "val").glob("*.png"))) == ref["dataset_args"]["n_images"]
    for rel in files(fresh):
        if rel.endswith(".png"):
            a, b = cv2.imread(str(fresh / rel)), cv2.imread(str(committed / rel))
            assert a.shape == b.shape and (a == b).all(), rel
        else:
            assert (fresh / rel).read_text() == (committed / rel).read_text(), rel


def parity_model(stem: str, model_yaml: str, ref: dict):
    """The port's model on the CPU at the reference's nc (and pose's
    kpt_shape) with the reference-trained weights, as chip_smoke.py builds it."""
    return parity_yolov8n(YOLO, yaml_model_load, ref, "cpu", stem, model_yaml)


def jax_parity_model(stem: str, model_yaml: str, ref: dict):
    from ultralytics_pro_tpu import YOLO as JYOLO
    from ultralytics_pro_tpu.nn.tasks import yaml_model_load as jyaml
    from ultralytics_pro_tpu.utils.torch_import import load_torch_state_dict

    y = jyaml(model_yaml)
    y["nc"] = ref["dataset_args"]["nc"]
    if ref["task"] == "pose":
        y["kpt_shape"] = [5, 3]
    model = JYOLO(y)
    fx = np.load(Path(FIXTURES) / f"{stem}_model.npz")
    variables = model.model.init_params(imgsz=ref["val_args"]["imgsz"])
    model.model.variables = load_torch_state_dict(
        variables, {k[4:]: fx[k] for k in fx.files if k.startswith("sd::")}, strict=True)
    return model


def assert_close_to_largest(got, want, tol=1e-4, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.abs(got - want).max() <= tol * np.abs(want).max(), (what, np.abs(got - want).max())


@pytest.fixture(scope="module")
def fixture_copy(tmp_path_factory) -> Path:
    """The committed set, copied (the JAX loader writes a label cache)."""
    return Path(shutil.copytree(SET, tmp_path_factory.mktemp("seg") / "set"))


# -- the fixture ------------------------------------------------------------

def test_fixture_equals_a_fresh_regeneration(tmp_path):
    assert_fixture_equals_a_fresh_regeneration(tmp_path, SET, REF)


# -- modules and the carrier ------------------------------------------------

def test_proto_matches_jax_on_carried_weights():
    from ultralytics_pro_tpu.nn.modules.block import Proto as JProto

    x = np.random.default_rng(1).normal(0, 1, (2, 10, 12, 24)).astype(np.float32)
    jm, tm = JProto(c_=32, c2=16), Proto(24, 32, 16)
    v = carry(jm, x, tm, seed=2)
    ref = np.asarray(jm.apply(v, x))
    with torch.no_grad():
        got = to_nhwc(tm(nchw(x)))
    assert got.shape == (2, 20, 24, 16)
    assert_close_to_largest(got, ref)
    w = v["params"]["upsample"]["kernel"]  # flax (kh, kw, out, in) under transpose_kernel
    np.testing.assert_array_equal(tm.upsample.weight.detach().numpy(), w.transpose(3, 2, 0, 1))


def test_segment_head_matches_jax_on_carried_weights():
    import jax

    from ultralytics_pro_tpu.nn.modules.head import Segment as JSegment

    rng = np.random.default_rng(4)
    strides, nc, chs = (8, 16, 32), 5, (16, 32, 64)
    feats = [rng.normal(0, 1, (2, 64 // s, 64 // s, c)).astype(np.float32) for s, c in zip(strides, chs)]
    jm = JSegment(nc=nc, nm=32, npr=24, strides=strides)
    v = randomize(jm.init(jax.random.PRNGKey(0), feats), 5)
    tm = Segment(nc=nc, ch=chs, nm=32, npr=24)
    tm.load_state_dict(jax_to_torch_state_dict(v))
    tm.stride = torch.tensor(strides, dtype=torch.float32)
    tm.eval()
    y_ref, aux = jm.apply(v, feats)
    with torch.no_grad():
        y, got = tm([nchw(f) for f in feats])
    assert y.shape == (2, sum((64 // s) ** 2 for s in strides), 4 + nc + 32)
    assert_close_to_largest(y.numpy(), y_ref, what="y")
    assert_close_to_largest(got["mc"].numpy(), aux["mc"], what="mc")
    assert_close_to_largest(to_nhwc(got["protos"]), aux["protos"], what="protos")
    for r, rr in zip(got["feats"], aux["feats"]):
        assert_close_to_largest(to_nhwc(r), rr, what="feats")
    assert set(tm([nchw(f) for f in feats], decode=False)) == {"feats", "mc", "protos"}


def test_segmentation_model_carries_both_ways_and_matches_jax():
    """yolov8n-seg at 64 px: JAX variables -> port -> JAX exact (proto.upsample
    included), and the decoded outputs and prototypes agree."""
    import jax.numpy as jnp

    from ultralytics_pro_tpu.nn.tasks import SegmentationModel as JModel

    jm = JModel("yolov8n-seg.yaml")
    v = randomize(jm.init_params(imgsz=64), 7)
    tm = SegmentationModel("yolov8n-seg.yaml")
    tm.load_state_dict(jax_to_torch_state_dict(v))  # strict
    back = torch_state_dict_to_jax(tm.state_dict())
    flat = lambda t, p=(): [x for k, s in t.items() for x in (flat(s, (*p, k)) if hasattr(s, "items") else [((*p, k), s)])]  # noqa: E731
    a, b = dict(flat(v)), dict(flat(back))
    assert a.keys() == b.keys() and ("params", "layers_22", "proto", "upsample", "kernel") in a
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), b[k], err_msg=str(k))
    x = np.random.default_rng(8).uniform(0, 1, (1, 64, 64, 3)).astype(np.float32)
    y_ref, aux = jm.apply(v, jnp.asarray(x), train=False)
    with torch.no_grad():
        y, got = tm(nchw(x))
    assert_close_to_largest(y.numpy(), y_ref, what="y")
    assert_close_to_largest(to_nhwc(got["protos"]), aux["protos"], what="protos")


# -- mask ops ---------------------------------------------------------------

def _mask_inputs(seed, n=6, c=8, mh=40, mw=40, ih=160, iw=160):
    rng = np.random.default_rng(seed)
    protos = rng.normal(0, 1, (mh, mw, c)).astype(np.float32)  # the JAX layout
    coef = rng.normal(0, 1, (n, c)).astype(np.float32)
    xy = rng.uniform(0, [iw * 0.8, ih * 0.8], (n, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(8, [iw * 0.5, ih * 0.5], (n, 2))], 1).astype(np.float32)
    return protos, coef, boxes


def _assert_masks(got, want):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got > 0.5, want > 0.5)


def test_crop_mask_matches_jax():
    import jax.numpy as jnp

    from ultralytics_pro_tpu.ops import masks as jm

    rng = np.random.default_rng(0)
    m = rng.uniform(0, 1, (5, 30, 20)).astype(np.float32)
    b = np.round(rng.uniform(-3, 33, (5, 4))).astype(np.float32)
    _assert_masks(port_masks.crop_mask(torch.from_numpy(m), torch.from_numpy(b)),
                  jm.crop_mask(jnp.asarray(m), jnp.asarray(b)))


@pytest.mark.parametrize("upsample", [False, True], ids=["proto_grid", "upsampled"])
@pytest.mark.parametrize("size", [(40, 40, 160, 160), (40, 40, 160, 96), (20, 24, 80, 96)])
def test_process_mask_matches_jax(upsample, size):
    import jax.numpy as jnp

    from ultralytics_pro_tpu.ops import masks as jm

    mh, mw, ih, iw = size
    protos, coef, boxes = _mask_inputs(sum(size), mh=mh, mw=mw, ih=ih, iw=iw)
    want = jm.process_mask(jnp.asarray(protos), jnp.asarray(coef), jnp.asarray(boxes), (ih, iw), upsample=upsample)
    got = port_masks.process_mask(torch.from_numpy(protos.transpose(2, 0, 1).copy()), torch.from_numpy(coef),
                                  torch.from_numpy(boxes), (ih, iw), upsample=upsample)
    _assert_masks(got, want)


# (prototype grid, original image): grown on both axes, grown on one and shrunk
# on the other, shrunk on both (an original image smaller than the grid)
SCALE_CASES = {"grow": ((40, 40), (480, 640)), "grow_odd": ((40, 40), (333, 500)),
               "mixed": ((160, 160), (100, 250)), "shrink": ((160, 160), (100, 150)),
               "shrink_far": ((40, 40), (17, 29))}


@pytest.mark.parametrize("case", list(SCALE_CASES))
def test_scale_masks_and_process_mask_native_match_jax(case):
    import jax.numpy as jnp

    from ultralytics_pro_tpu.ops import masks as jm

    (mh, mw), (h, w) = SCALE_CASES[case]
    protos, coef, boxes = _mask_inputs(len(case), mh=mh, mw=mw, ih=h, iw=w)
    p = torch.from_numpy(protos.transpose(2, 0, 1).copy())
    masks = np.array(jm.process_mask(jnp.asarray(protos), jnp.asarray(coef), jnp.asarray(boxes), (mh, mw)))
    _assert_masks(port_masks.scale_masks(torch.from_numpy(masks), (h, w)), jm.scale_masks(jnp.asarray(masks), (h, w)))
    want = jm.process_mask_native(jnp.asarray(protos), jnp.asarray(coef), jnp.asarray(boxes), (h, w))
    _assert_masks(port_masks.process_mask_native(p, torch.from_numpy(coef), torch.from_numpy(boxes), (h, w)), want)


def test_mask_ops_take_no_instances():
    p = torch.zeros(8, 40, 40)
    assert port_masks.process_mask_native(p, torch.zeros(0, 8), torch.zeros(0, 4), (100, 80)).shape == (0, 100, 80)
    assert port_masks.process_mask(p, torch.zeros(0, 8), torch.zeros(0, 4), (160, 160), upsample=True).shape == (0, 160, 160)


# -- NMS with a payload -----------------------------------------------------

@pytest.mark.parametrize("case,kw", [("default", dict(conf_thres=0.25, iou_thres=0.45)),
                                     ("val", dict(conf_thres=0.001, iou_thres=0.7, multi_label=True))],
                         ids=["single_label", "multi_label"])
def test_nms_with_extra_matches_jax(case, kw):
    from tests.conftest import load_fixture
    from ultralytics_pro_tpu.ops.nms import non_max_suppression as jax_nms

    pred = load_fixture(f"nms_{case}.npz")["pred"]  # (B, 4+nc, A)
    boxes = np.ascontiguousarray(pred[:, :4].transpose(0, 2, 1))
    scores = np.ascontiguousarray(pred[:, 4:].transpose(0, 2, 1))
    extra = np.random.default_rng(9).normal(0, 1, (*boxes.shape[:2], 32)).astype(np.float32)
    ref = jax_nms(boxes, scores, extra=extra, use_pallas=False, max_det=300, **kw)
    got = non_max_suppression(torch.from_numpy(boxes), torch.from_numpy(scores), extra=torch.from_numpy(extra),
                              max_det=300, **kw)
    assert int(got["valid"].sum()) > 0
    for k in ("valid", "cls", "scores", "boxes"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)
    np.testing.assert_allclose(got["extra"].numpy(), np.asarray(ref["extra"]), atol=1e-6, rtol=0)


# -- polygon fill and the mask shrink against cv2 ---------------------------

def _cv2_fill(h, w, pts):
    img = np.zeros((h, w), np.uint8)
    cv2.fillPoly(img, [np.asarray(pts, np.int32).reshape(-1, 2)], 1)
    return img


def test_fill_poly_equals_cv2_on_fixture_polygons(fixture_copy):
    d = check_det_dataset(fixture_copy / "data.yaml")
    ds = YOLODataset(d["val"], imgsz=160, data=d, task="segment")
    n = 0
    for i in range(len(ds)):
        item = ds[i]
        h, w = item["img"].shape[:2]
        for poly in item["segments"]:
            pts = np.asarray(poly, np.int32)
            np.testing.assert_array_equal(fill_poly(np.zeros((h, w), np.uint8), pts), _cv2_fill(h, w, pts))
            n += 1
    assert n > 16


POLYGONS = ("convex", "star", "any", "on_edge", "crossing")


def _random_polygon(rng, kind, h, w):
    """Seeded polygon vertices (k, 2) int32: convex or star-shaped (concave)
    inside the image, anywhere in it (self-crossing too), with vertices on
    x = w or y = h (what a normalised label at 1.0 gives), or crossing the
    image's edges."""
    k = int(rng.integers(3, 12))
    c = rng.uniform([w * 0.2, h * 0.2], [w * 0.8, h * 0.8])
    ang = np.sort(rng.uniform(0, 2 * np.pi, k))
    r = rng.uniform(2, min(h, w) * 0.45) if kind == "convex" else rng.uniform(1, min(h, w) * 0.6, k)[:, None]
    pts = c + r * np.stack([np.cos(ang), np.sin(ang)], 1)
    if kind == "any":
        pts = rng.uniform(0, [w, h], (k, 2))
    if kind == "on_edge":
        pts = rng.integers(0, [w + 1, h + 1], (k, 2))
        pts[:, 0] = np.where(rng.uniform(size=k) < 0.4, w, pts[:, 0])
        return pts.astype(np.int32)
    if kind == "crossing":
        return (c + rng.uniform(1, max(h, w), k)[:, None] * np.stack([np.cos(ang), np.sin(ang)], 1)).astype(np.int32)
    return np.clip(pts, 0, [w - 1, h - 1]).astype(np.int32)


@pytest.mark.parametrize("kind", POLYGONS)
def test_fill_poly_equals_cv2_on_random_polygons(kind):
    rng = np.random.default_rng(POLYGONS.index(kind))
    for _ in range(200):
        h, w = (int(v) for v in rng.integers(8, 120, 2))
        pts = _random_polygon(rng, kind, h, w)
        np.testing.assert_array_equal(fill_poly(np.zeros((h, w), np.uint8), pts), _cv2_fill(h, w, pts),
                                      err_msg=f"{h}x{w} {pts.tolist()}")


@pytest.mark.parametrize("src,ratio", [((160, 160), 4), ((640, 640), 4), ((128, 96), 4), ((160, 160), 2),
                                       ((150, 100), 3), ((101, 77), 2.5)])
def test_mask_shrink_equals_cv2(src, ratio):
    rng = np.random.default_rng(int(src[0] * ratio))
    h, w = src
    size = (int(w // ratio), int(h // ratio))
    binary = np.zeros((h, w), np.uint8)
    for _ in range(3):
        fill_poly(binary, _random_polygon(rng, "star", h, w))
    for img in (binary, rng.integers(0, 256, (h, w), dtype=np.uint8)):
        np.testing.assert_array_equal(resize_linear_u8(img, size), cv2.resize(img, size))


# -- dataset and collate ----------------------------------------------------

def test_dataset_items_and_collate_match_jax(fixture_copy):
    from ultralytics_pro_tpu.data.build import collate_detect as jcollate
    from ultralytics_pro_tpu.data.dataset import YOLODataset as JDataset
    from ultralytics_pro_tpu.data.utils import check_det_dataset as jcheck

    d = check_det_dataset(fixture_copy / "data.yaml")
    got_ds = YOLODataset(d["val"], imgsz=160, data=d, task="segment")
    want_ds = JDataset(d["val"], imgsz=160, data=jcheck(fixture_copy / "data.yaml"), task="segment")
    got = [got_ds[i] for i in range(len(got_ds))]
    want = [want_ds[i] for i in range(len(want_ds))]
    for g, w in zip(got, want):
        assert g["im_file"] == w["im_file"] and len(g["segments"]) == len(w["segments"])
        np.testing.assert_array_equal(g["img"], w["img"])  # every image is at most 160 px: padded, not resized
        np.testing.assert_allclose(g["bboxes"], w["bboxes"], atol=1e-5, rtol=0)
        for a, b in zip(g["segments"], w["segments"]):
            np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)
    for lo in range(0, 16, 8):
        gb, wb = collate_detect(got[lo:lo + 8], max_gt=8), jcollate(want[lo:lo + 8], max_gt=8)
        assert gb["masks"].shape == wb["masks"].shape == (8, 8, 40, 40)
        for k in ("masks", "cls", "mask_gt", "bboxes"):
            np.testing.assert_array_equal(gb[k], wb[k], err_msg=k)


def test_loader_batches_carry_masks(fixture_copy):
    d = check_det_dataset(fixture_copy / "data.yaml")
    batch = next(iter(DataLoader(YOLODataset(d["val"], imgsz=64, data=d, task="segment"), batch_size=4,
                                 workers=2, max_gt=6)))
    assert batch["masks"].shape == (4, 6, 16, 16)
    np.testing.assert_array_equal(batch["masks"].reshape(4, 6, -1).any(-1), batch["mask_gt"])


# -- metrics ----------------------------------------------------------------

def test_mask_iou_matches_jax():
    from ultralytics_pro_tpu.utils.metrics import mask_iou_np as jmask_iou

    rng = np.random.default_rng(0)
    a = (rng.uniform(0, 1, (7, 400)) < 0.3).astype(np.float32)
    b = (rng.uniform(0, 1, (11, 400)) < 0.4).astype(np.float32)
    np.testing.assert_allclose(port_metrics.mask_iou_np(a, b), jmask_iou(a, b), atol=1e-6, rtol=0)


def test_segment_metrics_match_jax():
    from ultralytics_pro_tpu.utils import metrics as jm

    names = {i: f"c{i}" for i in range(4)}
    got, want = port_metrics.SegmentMetrics(names), jm.SegmentMetrics(names)
    rng = np.random.default_rng(1)
    for _ in range(3):
        n, m = 50, 12
        tp, tp_m = rng.uniform(0, 1, (n, 10)) < 0.5, rng.uniform(0, 1, (n, 10)) < 0.4
        conf = rng.uniform(0, 1, n).astype(np.float32)
        pred_cls, gt_cls = rng.integers(0, 4, n).astype(np.float32), rng.integers(0, 4, m).astype(np.float32)
        for mt in (got, want):
            mt.update_stats(tp, conf, pred_cls, gt_cls, tp_m=tp_m)
    got.process(), want.process()
    assert got.results_dict.keys() == want.results_dict.keys()
    np.testing.assert_allclose(list(got.results_dict.values()), list(want.results_dict.values()), atol=1e-6)
    np.testing.assert_allclose(got.seg.mean_results(), want.seg.mean_results(), atol=1e-6)


# -- the slice: val and predict ---------------------------------------------

@pytest.fixture(scope="module")
def port_val(fixture_copy):
    return parity_model("val_parity_segment", "yolov8n-seg.yaml", REF).val(data=str(fixture_copy / "data.yaml"),
                                                                          **VAL_KW)


@pytest.fixture(scope="module")
def jax_val(fixture_copy):
    model = jax_parity_model("val_parity_segment", "yolov8n-seg.yaml", REF)
    return model.val(data=str(fixture_copy / "data.yaml"), plots=False, **VAL_KW)


MAPS = (("box.map50", "metrics/mAP50(B)"), ("box.map", "metrics/mAP50-95(B)"),
        ("seg.map50", "metrics/mAP50(M)"), ("seg.map", "metrics/mAP50-95(M)"))


@pytest.mark.parametrize("attr,key", MAPS, ids=[a for a, _ in MAPS])
def test_val_map_matches_jax_validator_and_the_reference(port_val, jax_val, attr, key):
    got = metric(port_val, attr)
    assert abs(got - metric(jax_val, attr)) <= 1e-3, (attr, got, metric(jax_val, attr))
    assert abs(got - REF["results"][key]) <= 0.005, (attr, got, REF["results"][key])


def test_predict_matches_jax_predictor():
    imgs = [cv2.imread(str(SET / "images" / "val" / f"val{i}.png")) for i in (0, 1, 2)]
    assert {im.shape[:2] for im in imgs} == {(160, 160), (160, 120), (120, 160)}  # padded only
    kw = dict(imgsz=160, conf=0.25)
    ref = jax_parity_model("val_parity_segment", "yolov8n-seg.yaml", REF).predict(imgs, **kw)
    got = parity_model("val_parity_segment", "yolov8n-seg.yaml", REF).predict(imgs, **kw)
    for g, r, im in zip(got, ref, imgs):
        rd = np.asarray(r.boxes.data)
        assert 0 < len(g) == len(rd)
        np.testing.assert_array_equal(g.boxes.cls, rd[:, 5])
        np.testing.assert_allclose(g.boxes.xyxy, rd[:, :4], atol=1e-3, rtol=0)
        np.testing.assert_allclose(g.boxes.conf, rd[:, 4], atol=1e-5, rtol=0)
        gm, rm = g.masks.data, np.asarray(r.masks.data)
        assert gm.dtype == bool and gm.shape == rm.shape == (len(rd), *im.shape[:2])
        assert (gm != rm).mean() <= 1e-3, (gm != rm).mean()


def test_results_masks_surface():
    imgs = [np.random.default_rng(0).integers(0, 256, (90, 70, 3), dtype=np.uint8)]
    r = YOLO("yolov8n-seg.yaml", device="cpu").predict(imgs, imgsz=64, conf=1e-6)[0]
    assert len(r.masks) == len(r.boxes) > 0 and r.masks.data.shape[1:] == (90, 70)
    assert r.masks[:2].data.shape == (2, 90, 70) and r.masks.cpu().numpy() is r.masks.data
    xy, xyn = r.masks.xy, r.masks.xyn  # each mask's largest outer contour, as cv2 finds it
    assert len(xy) == len(xyn) == len(r.masks)
    for m, pts, ptsn in zip(r.masks.data.astype(np.uint8), xy, xyn):
        found = cv2.findContours(m, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)[0]
        want = max(found, key=cv2.contourArea).reshape(-1, 2) if found else np.zeros((0, 2))
        np.testing.assert_array_equal(pts, want.astype(np.float32))
        np.testing.assert_array_equal(ptsn, pts / np.array([70, 90], np.float32))


if __name__ == "__main__":
    ROOT = Path(FIXTURES)
    for stem in ("segment", "pose"):
        target = ROOT / f"torch_val_synth_{stem}"
        shutil.rmtree(target, ignore_errors=True)
        print(make_task_fixture(target, json.loads((ROOT / f"val_parity_{stem}_ref.json").read_text())))
