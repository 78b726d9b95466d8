"""The port's detect val against the JAX package, on the CPU.

The fixture `tests/fixtures/torch_val_synth/` holds the val split of the
synthetic set behind `val_parity_ref.json` (16 images, 3 classes, sizes
160x160, 160x120, 120x160 and 200x160): the JAX package's JPEGs decoded by
`cv2.imread` and written losslessly as PNG with cv2's adaptive row filters,
and their labels. `make_torch_val_fixture` regenerates it
(`python -m tests.test_torch_val` from the repo root rewrites the committed
copy). The JAX loader writes a label `.cache` beside the labels, so every
test that runs the JAX package on the fixture works on a copy.

Tolerances: the PNG reader is exact against `cv2.imread`; the resizes are
within one grey level of cv2 (cv2 sums uint8 in fixed point or in another
order); boxes and ratio_pad within 1e-5; metrics from the same statistics
within 1e-6; mAP of the port's val within 1e-3 of the JAX validator's on the
same files (f32 forwards of two frameworks), and within 0.005 of the
reference's numbers, the tolerance of tests/test_val_parity.py.
"""

import json
import shutil
import sys
import tempfile
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from tests.conftest import FIXTURES
from tests.test_torch_modules import torch_threads  # noqa: F401 (autouse fixture)
from ultralytics_pro_tpu_torch import YOLO
from ultralytics_pro_tpu_torch.data import (
    DataLoader,
    LetterBox,
    YOLODataset,
    check_det_dataset,
    collate_detect,
    imread,
    resize_area,
    resize_bilinear,
)
from ultralytics_pro_tpu_torch.nn.tasks import yaml_model_load
from ultralytics_pro_tpu_torch.ops.nms import non_max_suppression
from ultralytics_pro_tpu_torch.utils import metrics as port_metrics

FIXTURE_SET = Path(FIXTURES) / "torch_val_synth"
REF = json.loads((Path(FIXTURES) / "val_parity_ref.json").read_text())
VAL_KW = dict(imgsz=REF["val_args"]["imgsz"], batch=8, conf=REF["val_args"]["conf"],
              iou=REF["val_args"]["iou"], max_det=REF["val_args"]["max_det"])
PNG_FILTERS = {"none": cv2.IMWRITE_PNG_FILTER_NONE, "sub": cv2.IMWRITE_PNG_FILTER_SUB,
               "up": cv2.IMWRITE_PNG_FILTER_UP, "average": cv2.IMWRITE_PNG_FILTER_AVG,
               "paeth": cv2.IMWRITE_PNG_FILTER_PAETH, "adaptive": cv2.IMWRITE_PNG_ALL_FILTERS}


def make_torch_val_fixture(root) -> Path:
    """Write the fixture set under `root`: the JAX package's synthetic set
    with val_parity_ref.json's dataset_args, its val JPEGs read by cv2 and
    written as PNG (adaptive filters), the labels, and data.yaml."""
    from ultralytics_pro_tpu.data.synth import make_synth_dataset

    root = Path(root)
    with tempfile.TemporaryDirectory() as tmp:
        src = Path(tmp)
        make_synth_dataset(src, **REF["dataset_args"])
        (root / "images" / "val").mkdir(parents=True, exist_ok=True)
        (root / "labels" / "val").mkdir(parents=True, exist_ok=True)
        for jpg in sorted((src / "images" / "val").glob("*.jpg")):
            cv2.imwrite(str(root / "images" / "val" / f"{jpg.stem}.png"), cv2.imread(str(jpg)),
                        [cv2.IMWRITE_PNG_FILTER, cv2.IMWRITE_PNG_ALL_FILTERS])
            shutil.copy(src / "labels" / "val" / f"{jpg.stem}.txt", root / "labels" / "val")
    names = "".join(f"  {i}: shape{i}\n" for i in range(REF["dataset_args"]["nc"]))
    (root / "data.yaml").write_text("val: images/val\nnames:\n" + names)
    return root


def _files(root: Path):
    return sorted(p.relative_to(root).as_posix() for p in root.rglob("*") if p.is_file())


@pytest.fixture(scope="module")
def fixture_copy(tmp_path_factory) -> Path:
    """The committed fixture set, copied (the JAX loader writes a label cache)."""
    dst = tmp_path_factory.mktemp("val") / "torch_val_synth"
    shutil.copytree(FIXTURE_SET, dst)
    return dst


def _parity_model(device="cpu"):
    fx = np.load(Path(FIXTURES) / "val_parity_model.npz")
    y = yaml_model_load("yolov8n.yaml")
    y["nc"] = REF["dataset_args"]["nc"]
    model = YOLO(y, device=device)
    model.load_state_dict({k[4:]: fx[k] for k in fx.files if k.startswith("sd::")})
    return model


@pytest.fixture(scope="module")
def port_metrics_on_fixture(fixture_copy):
    return _parity_model().val(data=str(fixture_copy / "data.yaml"), **VAL_KW)


@pytest.fixture(scope="module")
def jax_metrics_on_fixture(fixture_copy):
    from ultralytics_pro_tpu import YOLO as JYOLO
    from ultralytics_pro_tpu.nn.tasks import yaml_model_load as jyaml
    from ultralytics_pro_tpu.utils.torch_import import load_torch_state_dict

    fx = np.load(Path(FIXTURES) / "val_parity_model.npz")
    y = jyaml("yolov8n.yaml")
    y["nc"] = REF["dataset_args"]["nc"]
    model = JYOLO(y)
    variables = model.model.init_params(imgsz=VAL_KW["imgsz"])
    sd = {k[4:]: fx[k] for k in fx.files if k.startswith("sd::")}
    model.model.variables = load_torch_state_dict(variables, sd, strict=True)
    return model.val(data=str(fixture_copy / "data.yaml"), plots=False, **VAL_KW)


# -- the fixture ------------------------------------------------------------

def test_fixture_equals_a_fresh_regeneration(tmp_path):
    fresh = make_torch_val_fixture(tmp_path / "fresh")
    assert _files(fresh) == _files(FIXTURE_SET)
    assert len(list((FIXTURE_SET / "images" / "val").glob("*.png"))) == REF["dataset_args"]["n_images"]
    for rel in _files(fresh):
        if rel.endswith(".png"):
            a, b = cv2.imread(str(fresh / rel)), cv2.imread(str(FIXTURE_SET / rel))
            assert a.shape == b.shape and (a == b).all(), rel
        else:
            assert (fresh / rel).read_text() == (FIXTURE_SET / rel).read_text(), rel


# -- image reading ----------------------------------------------------------

@pytest.mark.parametrize("name", [f"val{i}" for i in range(16)])
def test_imread_equals_cv2_on_fixture(name):
    path = FIXTURE_SET / "images" / "val" / f"{name}.png"
    got, want = imread(path), cv2.imread(str(path))
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("channels", [1, 3, 4], ids=["gray", "rgb", "rgba"])
@pytest.mark.parametrize("row_filter", list(PNG_FILTERS))
def test_imread_equals_cv2_on_cv2_written_png(tmp_path, channels, row_filter):
    rng = np.random.default_rng(channels * 10 + list(PNG_FILTERS).index(row_filter))
    shape = (23, 37) if channels == 1 else (23, 37, channels)  # odd width and height
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    img[5:12, 3:20] = 77  # flat patches give the adaptive writer other filters to pick
    path = tmp_path / "x.png"
    cv2.imwrite(str(path), img, [cv2.IMWRITE_PNG_FILTER, PNG_FILTERS[row_filter]])
    got, want = imread(path), cv2.imread(str(path))
    assert got.shape == want.shape == (23, 37, 3)
    np.testing.assert_array_equal(got, want)


def test_imread_reads_npy_and_names_a_missing_file(tmp_path):
    arr = np.arange(2 * 3 * 5, dtype=np.uint8).reshape(2, 3, 5)
    np.save(tmp_path / "bands.npy", arr)
    np.testing.assert_array_equal(imread(tmp_path / "bands.npy"), arr)
    with pytest.raises(FileNotFoundError, match="nope.png"):
        imread(tmp_path / "nope.png")


def test_imread_takes_other_formats_through_pil_or_names_the_decoder(tmp_path, monkeypatch):
    from PIL import Image

    path = tmp_path / "x.jpg"
    cv2.imwrite(str(path), np.random.default_rng(0).integers(0, 256, (16, 24, 3), dtype=np.uint8))
    want = np.asarray(Image.open(path).convert("RGB"))[..., ::-1]
    np.testing.assert_array_equal(imread(path), want)
    monkeypatch.setitem(sys.modules, "PIL", None)  # PIL absent, as on the card's machine
    with pytest.raises(NotImplementedError, match=r"x\.jpg.*PIL"):
        imread(path)


# -- resizes ----------------------------------------------------------------

@pytest.mark.parametrize("src,dst", [
    ((200, 160), (160, 128)),  # the fixture's 0.8 shrink at imgsz 160
    ((200, 160), (100, 80)),  # 0.5
    ((300, 200), (111, 74)),  # 0.37
    ((300, 200), (240, 100)),  # 0.8 by 0.5
    ((101, 77), (38, 50)),  # odd sizes, 0.376 by 0.649
])
def test_resize_area_within_one_level_of_cv2_inter_area(src, dst):
    img = np.random.default_rng(sum(src + dst)).integers(0, 256, (*src, 3), dtype=np.uint8)
    img[: src[0] // 2] = cv2.GaussianBlur(img[: src[0] // 2], (0, 0), 3)  # smooth half, noisy half
    got = resize_area(img, dst[::-1])
    want = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_AREA)
    assert got.shape == want.shape and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_resize_area_exact_on_the_fixture_shrink():
    img = cv2.imread(str(FIXTURE_SET / "images" / "val" / "val3.png"))
    assert img.shape[:2] == (200, 160)
    np.testing.assert_array_equal(resize_area(img, (128, 160)),
                                  cv2.resize(img, (128, 160), interpolation=cv2.INTER_AREA))


def test_resize_area_refuses_to_grow():
    with pytest.raises(ValueError, match="grows"):
        resize_area(np.zeros((10, 10, 3), np.uint8), (12, 8))


@pytest.mark.parametrize("src,dst", [((200, 160), (640, 512)), ((120, 160), (480, 640))])
def test_resize_bilinear_within_one_level_of_cv2_inter_linear(src, dst):
    img = np.random.default_rng(sum(src)).integers(0, 256, (*src, 3), dtype=np.uint8)
    got = resize_bilinear(img, dst[::-1]).numpy()
    want = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_LINEAR)
    assert got.shape == want.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


# -- metrics ----------------------------------------------------------------

def _metric_inputs(seed=0, n_pred=300, n_gt=40, nc=5):
    rng = np.random.default_rng(seed)
    gt = rng.uniform(0, 100, (n_gt, 2))
    gt = np.concatenate([gt, gt + rng.uniform(5, 40, (n_gt, 2))], 1)
    src = rng.integers(0, n_gt, n_pred)
    pred = gt[src] + rng.normal(0, 3, (n_pred, 4))
    gt_cls = rng.integers(0, nc, n_gt).astype(np.float32)
    pred_cls = np.where(rng.uniform(0, 1, n_pred) < 0.8, gt_cls[src], rng.integers(0, nc, n_pred)).astype(np.float32)
    conf = rng.uniform(0, 1, n_pred).astype(np.float32)
    return gt, gt_cls, pred, pred_cls, conf


def test_ap_per_class_matches_jax_and_the_reference_fixture():
    from ultralytics_pro_tpu.utils import metrics as jm

    fx = np.load(Path(FIXTURES) / "metrics.npz")
    args = (fx["tp"].astype(bool), fx["conf"], fx["pred_cls"], fx["target_cls"])
    got, want = port_metrics.ap_per_class(*args), jm.ap_per_class(*args)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-6, rtol=0, err_msg=k)
    for k in ("ap", "p", "r", "f1", "p_curve", "r_curve", "f1_curve", "prec_values"):
        np.testing.assert_allclose(got[k], fx[k], atol=1e-6, rtol=0, err_msg=k)
    np.testing.assert_array_equal(got["unique_classes"], fx["unique_classes"].astype(int))


@pytest.mark.parametrize("seed", [0, 1])
def test_match_predictions_and_box_iou_match_jax(seed):
    from ultralytics_pro_tpu.utils import metrics as jm

    gt, gt_cls, pred, pred_cls, _ = _metric_inputs(seed)
    iou = port_metrics.box_iou_np(gt, pred)
    np.testing.assert_allclose(iou, jm.box_iou_np(gt, pred), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(port_metrics.match_predictions(pred_cls, gt_cls, iou),
                                  jm.match_predictions(pred_cls, gt_cls, iou))


def test_det_metrics_match_jax():
    from ultralytics_pro_tpu.utils import metrics as jm

    names = {i: f"c{i}" for i in range(5)}
    got, want = port_metrics.DetMetrics(names), jm.DetMetrics(names)
    for seed in range(3):  # three images' statistics
        gt, gt_cls, pred, pred_cls, conf = _metric_inputs(seed, n_pred=120, n_gt=20)
        tp = jm.match_predictions(pred_cls, gt_cls, jm.box_iou_np(gt, pred))
        got.update_stats(tp, conf, pred_cls, gt_cls)
        want.update_stats(tp, conf, pred_cls, gt_cls)
    got.process(), want.process()
    np.testing.assert_allclose(got.mean_results(), want.mean_results(), atol=1e-6, rtol=0)
    np.testing.assert_allclose(got.box.maps, want.box.maps, atol=1e-6, rtol=0)
    assert got.box.map75 == pytest.approx(want.box.map75, abs=1e-6)
    assert got.fitness == pytest.approx(want.fitness, abs=1e-6)
    assert got.results_dict.keys() == want.results_dict.keys()
    np.testing.assert_allclose(list(got.results_dict.values()), list(want.results_dict.values()), atol=1e-6)


def test_confusion_matrix_matches_jax():
    from ultralytics_pro_tpu.utils import metrics as jm

    got, want = port_metrics.ConfusionMatrix(nc=5), jm.ConfusionMatrix(nc=5)
    for seed in range(3):
        gt, gt_cls, pred, pred_cls, conf = _metric_inputs(seed, n_pred=60, n_gt=15)
        det = np.concatenate([pred, conf[:, None], pred_cls[:, None]], 1)
        for cm in (got, want):
            cm.process_batch(det, gt, gt_cls)
            cm.process_batch(det, np.zeros((0, 4)), np.zeros((0,)))  # no ground truth
            cm.process_batch(None, gt, gt_cls)  # no detections
    np.testing.assert_array_equal(got.matrix, want.matrix)
    for a, b in zip(got.tp_fp(), want.tp_fp()):
        np.testing.assert_array_equal(a, b)


# -- dataset, collate, loader -----------------------------------------------

def test_check_det_dataset_matches_jax(fixture_copy, tmp_path, monkeypatch):
    from ultralytics_pro_tpu.data.utils import check_det_dataset as jcheck

    got, want = check_det_dataset(fixture_copy / "data.yaml"), jcheck(fixture_copy / "data.yaml")
    for k in ("path", "val", "names", "nc", "yaml_file"):
        assert got[k] == want[k], k
    assert check_det_dataset({"path": str(fixture_copy), "val": "images/val", "names": ["a", "b"]})["names"] == {0: "a", 1: "b"}
    monkeypatch.chdir(fixture_copy.parent)  # a relative YAML path
    assert check_det_dataset("torch_val_synth/data.yaml")["val"] == got["val"]
    (tmp_path / "synth.yaml").write_text("synth: detect\ntrain: images/train\nval: images/val\nnames: [a]\n")
    with pytest.raises(FileNotFoundError, match="synthetic"):
        check_det_dataset(tmp_path / "synth.yaml")


def _assert_item_close(got, want):
    assert got["im_file"] == want["im_file"]
    assert tuple(got["ori_shape"]) == tuple(want["ori_shape"])
    assert tuple(got["resized_shape"]) == tuple(want["resized_shape"])
    assert got["img"].shape == want["img"].shape and got["img"].dtype == np.uint8
    assert np.abs(got["img"].astype(int) - want["img"].astype(int)).max() <= 1
    np.testing.assert_array_equal(got["cls"], want["cls"])
    np.testing.assert_allclose(got["bboxes"], want["bboxes"], atol=1e-5, rtol=0)
    (g_gain, g_pad), (w_gain, w_pad) = got["ratio_pad"], want["ratio_pad"]
    np.testing.assert_allclose(g_gain, w_gain, atol=1e-5, rtol=0)
    assert tuple(g_pad) == tuple(w_pad)


@pytest.mark.parametrize("imgsz", [160, 256, 96], ids=["as_ref", "grow", "shrink"])
def test_dataset_items_and_collate_match_jax(fixture_copy, imgsz):
    from ultralytics_pro_tpu.data.build import collate_detect as jcollate
    from ultralytics_pro_tpu.data.dataset import YOLODataset as JDataset
    from ultralytics_pro_tpu.data.utils import check_det_dataset as jcheck

    d = check_det_dataset(fixture_copy / "data.yaml")
    got_ds = YOLODataset(d["val"], imgsz=imgsz, data=d)
    want_ds = JDataset(d["val"], imgsz=imgsz, data=jcheck(fixture_copy / "data.yaml"))
    assert got_ds.im_files == want_ds.im_files and len(got_ds) == len(want_ds) == 16
    got = [got_ds[i] for i in range(len(got_ds))]
    want = [want_ds[i] for i in range(len(want_ds))]
    for g, w in zip(got, want):
        _assert_item_close(g, w)
    gb, wb = collate_detect(got[:5], max_gt=8), jcollate(want[:5], max_gt=8)
    assert gb["img"].shape == wb["img"].shape
    assert np.abs(gb["img"].astype(int) - wb["img"].astype(int)).max() <= 1
    for k in ("cls", "mask_gt"):
        np.testing.assert_array_equal(gb[k], wb[k])
    np.testing.assert_allclose(gb["bboxes"], wb["bboxes"], atol=1e-5, rtol=0)
    assert gb["im_files"] == wb["im_files"] and gb["ori_shapes"] == wb["ori_shapes"]
    for (gg, gp), (wg, wp) in zip(gb["ratio_pads"], wb["ratio_pads"]):
        np.testing.assert_allclose(gg, wg, atol=1e-5, rtol=0)
        assert tuple(gp) == tuple(wp)


def test_letterbox_labels_form_matches_jax():
    from ultralytics_pro_tpu.data.augment import LetterBox as JLetterBox

    img = np.random.default_rng(3).integers(0, 256, (100, 60, 3), dtype=np.uint8)
    boxes = np.array([[1.5, 2.0, 30.0, 40.5], [10.0, 50.0, 59.0, 99.0]], np.float32)
    for pre in ((0.5, 0.5), None):
        for scaleup in (True, False):
            labels = {"img": img, "bboxes": boxes.copy(), "cls": np.array([0.0, 1.0], np.float32)}
            if pre is not None:
                labels["ratio_pad"] = pre
            got = LetterBox((128, 128), scaleup=scaleup)(dict(labels))
            want = JLetterBox((128, 128), scaleup=scaleup)(dict(labels))
            assert got["img"].shape == want["img"].shape
            assert np.abs(got["img"].astype(int) - want["img"].astype(int)).max() <= 1
            np.testing.assert_allclose(got["bboxes"], want["bboxes"], atol=1e-5, rtol=0)
            np.testing.assert_allclose(got["ratio_pad"][0], want["ratio_pad"][0], atol=1e-5, rtol=0)
            assert got["ratio_pad"][1] == want["ratio_pad"][1]
            assert tuple(got["resized_shape"]) == tuple(want["resized_shape"])


def test_loader_pads_the_last_batch_in_order(fixture_copy):
    d = check_det_dataset(fixture_copy / "data.yaml")
    ds = YOLODataset(d["val"], imgsz=64, data=d)
    loader = DataLoader(ds, batch_size=6, workers=3)
    batches = list(loader)
    assert len(loader) == len(batches) == 3
    assert [b["pad_count"] for b in batches] == [0, 0, 2]
    files = [f for b in batches for f in b["im_files"]]
    assert files == ds.im_files + [ds.im_files[-1]] * 2
    assert all(b["img"].shape == (6, 64, 64, 3) for b in batches)


@pytest.mark.parametrize("kwargs,match", [
    (dict(augment=True), "augment"), (dict(task="classify"), "classify"), (dict(data={"channels": 1}), "channels"),
])
def test_dataset_refuses_what_it_does_not_port(fixture_copy, kwargs, match):
    """A classify set names the classify dataset. augment=True and
    `channels: 1`, once refused, now give their samples (held to the
    JAX dataset's in tests/test_torch_augment.py and
    test_torch_train_options.py)."""
    path = str(fixture_copy / "images" / "val")
    if match == "classify":
        with pytest.raises(NotImplementedError, match=match):
            YOLODataset(path, imgsz=64, **kwargs)
        return
    img = YOLODataset(path, imgsz=64, **kwargs)[0]["img"]
    assert img.shape == (64, 64, 3)
    if match == "channels":
        assert (img[..., 0] == img[..., 1]).all() and (img[..., 1] == img[..., 2]).all()


# -- NMS at the val size ----------------------------------------------------

def test_multi_label_nms_at_the_val_size_matches_jax():
    """A·nc = 8400·80 = 672,000 candidates a row, K = 30000 kept for greedy
    NMS: anchor and class indices and the class offset exact, outputs equal."""
    import jax.numpy as jnp

    from ultralytics_pro_tpu.ops.nms import non_max_suppression as jnms

    rng = np.random.default_rng(0)
    a, nc = 8400, 80
    xy = rng.uniform(0, 640, (1, a, 2))
    boxes = np.concatenate([xy, rng.uniform(4, 200, (1, a, 2))], -1).astype(np.float32)
    scores = (rng.uniform(0, 1, (1, a, nc)) ** 8).astype(np.float32)
    kw = dict(conf_thres=1e-6, iou_thres=0.7, max_det=300, multi_label=True)
    got = non_max_suppression(torch.from_numpy(boxes), torch.from_numpy(scores), **kw)
    want = jnms(jnp.asarray(boxes), jnp.asarray(scores), use_pallas=False, **kw)
    assert int(got["valid"].sum()) == 300
    for k in ("valid", "cls", "scores", "boxes"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


# -- val, end to end --------------------------------------------------------

def test_val_map_matches_jax_validator_on_the_same_files(port_metrics_on_fixture, jax_metrics_on_fixture):
    got, want = port_metrics_on_fixture, jax_metrics_on_fixture
    assert abs(got.box.map50 - want.box.map50) <= 1e-3, (got.box.map50, want.box.map50)
    assert abs(got.box.map - want.box.map) <= 1e-3, (got.box.map, want.box.map)


def test_val_map_matches_the_reference(port_metrics_on_fixture):
    got = port_metrics_on_fixture
    want50, want = REF["results"]["metrics/mAP50(B)"], REF["results"]["metrics/mAP50-95(B)"]
    assert abs(got.box.map50 - want50) <= 0.005, (got.box.map50, want50)
    assert abs(got.box.map - want) <= 0.005, (got.box.map, want)
    assert set(got.speed) == {"preprocess", "inference", "postprocess"}


def test_val_single_cls_zeroes_ground_truth_too(fixture_copy):
    """single_cls reaches the dataset, as in the torch reference: ground truth
    and predictions are both class 0 (the JAX Model.val zeroes predictions only)."""
    m = _parity_model().val(data=str(fixture_copy / "data.yaml"), single_cls=True, **VAL_KW)
    assert list(m.box.ap_class_index) == [0]
    assert 0.5 < m.box.map50 <= 1


def test_val_refuses_what_it_does_not_port(fixture_copy, tmp_path):
    """plots raises in both facades; RT-DETR's save_json writes an empty
    predictions.json, as the JAX RTDETRValidator does (its matching keeps no
    records)."""
    from tests.test_torch_cuda import NARROW
    from ultralytics_pro_tpu_torch import RTDETR

    model = YOLO("yolov8n.yaml", device="cpu")
    data = str(fixture_copy / "data.yaml")
    with pytest.raises(NotImplementedError, match="plots"):
        model.val(data=data, imgsz=64, plots=True)
    with pytest.raises(ValueError, match="data="):
        model.val()
    detr = RTDETR("rtdetr-l.yaml", device="cpu")  # its val is ported; its validator refuses the same flag
    with pytest.raises(NotImplementedError, match="plots"):
        detr.val(data=data, imgsz=64, plots=True)
    RTDETR(dict(NARROW), device="cpu").val(data=data, imgsz=64, save_json=True, project=str(tmp_path))
    assert json.loads((tmp_path / "predictions.json").read_text()) == []


if __name__ == "__main__":
    shutil.rmtree(FIXTURE_SET, ignore_errors=True)
    print(make_torch_val_fixture(FIXTURE_SET))
