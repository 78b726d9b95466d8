"""Test-time augmentation and the val switches `rect`, `cache` and `save_json`
(with `coco_evaluate`) in the port against the JAX package, on the CPU.

The model is the reference-trained yolov8n of `val_parity_model.npz` (nc 3)
on the committed detect fixture set (16 PNGs of 160x160, 160x120, 120x160
and 200x160; the JAX loader writes a label cache, so the tests work on a
copy), its weights carried to the JAX facade through
`torch_state_dict_to_jax`.

1. TTA (`predict(augment=True)`, the JAX `tta_forward`): the three passes'
   resize, `F.interpolate(bilinear, antialias=True)`, within 1e-5 of
   `jax.image.resize` on the same tensor (read: 1.8e-7 at 160 -> 128, 2.6e-6
   at 640 -> 544). Predict at 160 px: the same detections per image in the
   same order; on the images the letterbox only pads (their long side is
   160), boxes within 1e-3 px and scores within 1e-5 (read: 2.3e-5 px,
   6.6e-7; the resize above accounts for all of it); on the image it
   shrinks (200 -> 160), boxes within 0.05 px and scores within 1e-3 (read:
   0.021 px, 2.9e-4), the letterbox's known one-grey-level gap
   (tests/test_torch_val.py). At 640 the passes keep 8,000 + 6,069 + 980 =
   15,049 candidates. Segment, pose, OBB and YOLOv10's end-to-end head raise
   by name.
2. `rect=True`: the JAX dataset's order and `batch_shapes`, and the val's
   mAPs within 1e-3 of the JAX validator's (read: equal); with PIL refused,
   the sizes come from the PNG headers and the val still runs.
3. `cache="ram"` and `"disk"`: the mAPs equal the uncached val's exactly;
   either package reads the other's disk cache, image for image.
4. `save_json`: `predictions.json` equal to the JAX validator's record for
   record (image_id and category_id equal, bbox within 1e-3, one step of
   its rounding to 3 decimals, score within 1e-5); `COCOEvalNp` equal to
   the JAX copy on that file against the set's COCO ground truth, and on
   the hand cases of tests/test_cocoeval.py.
"""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from chip_smoke import coco_ground_truth
from tests.conftest import FIXTURES
from tests.test_torch_imports import BLOCKED, REPO, _blocker
from tests.test_torch_modules import torch_threads  # noqa: F401 (autouse fixture)
from ultralytics_pro_tpu_torch import YOLO
from ultralytics_pro_tpu_torch.data import YOLODataset, check_det_dataset, imread
from ultralytics_pro_tpu_torch.engine.predictor import tta_forward
from ultralytics_pro_tpu_torch.nn.tasks import yaml_model_load
from ultralytics_pro_tpu_torch.utils.cocoeval import COCOEvalNp
from ultralytics_pro_tpu_torch.utils.weights import torch_state_dict_to_jax

FIXTURE_SET = Path(FIXTURES) / "torch_val_synth"
VAL_KW = dict(imgsz=160, batch=8, conf=0.001, iou=0.7, max_det=300)


@pytest.fixture(scope="module")
def fixture_copy(tmp_path_factory) -> Path:
    return shutil.copytree(FIXTURE_SET, tmp_path_factory.mktemp("options") / "set")


def trained_yolov8n() -> YOLO:
    fx = np.load(Path(FIXTURES) / "val_parity_model.npz")
    model = YOLO({**yaml_model_load("yolov8n.yaml"), "nc": 3}, device="cpu")
    model.load_state_dict({k[4:]: fx[k] for k in fx.files if k.startswith("sd::")})
    return model


@pytest.fixture(scope="module")
def models():
    """(port, JAX facade) on the fixture's trained yolov8n."""
    from ultralytics_pro_tpu import YOLO as JYOLO
    from ultralytics_pro_tpu.nn.tasks import yaml_model_load as jyaml

    port = trained_yolov8n()
    jax_yolo = JYOLO({**jyaml("yolov8n.yaml"), "nc": 3})
    jax_yolo.model.variables = torch_state_dict_to_jax(port.model.state_dict())
    return port, jax_yolo


# -- test-time augmentation -----------------------------------------------------------

@pytest.mark.parametrize("src,dst", [(160, 128), (640, 544)])
def test_tta_resize_matches_jax_image_resize(src, dst):
    import jax

    x = np.random.default_rng(src).uniform(0, 1, (1, src, src, 3)).astype(np.float32)
    want = np.asarray(jax.image.resize(x, (1, dst, dst, 3), "bilinear"))
    got = F.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2), (dst, dst), mode="bilinear", antialias=True,
                        align_corners=False).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_tta_predict_matches_jax(models, monkeypatch):
    """Four images of the set, one of each size, predicted with augment=True
    by both facades at 160 px; the fused single-label NMS is not reached."""
    from ultralytics_pro_tpu_torch.engine import predictor

    port, jax_yolo = models
    files = ["val0.png", "val1.png", "val2.png", "val3.png"]  # 160x160, 120 wide, 120 high, 200 high
    imgs = [imread(FIXTURE_SET / "images" / "val" / f) for f in files]

    def fused(*args, **kwargs):
        raise AssertionError("TTA reached the fused single-label NMS")

    monkeypatch.setattr(predictor, "non_max_suppression_fused", fused)
    got = port.predict(imgs, imgsz=160, augment=True)
    ref = jax_yolo.predict(imgs, imgsz=160, augment=True)
    for f, im, g, r in zip(files, imgs, got, ref):
        rd = np.asarray(r.boxes.data)
        shrunk = max(im.shape[:2]) > 160
        assert len(g.boxes.data) == len(rd) > 0, f
        np.testing.assert_array_equal(g.boxes.cls, rd[:, 5])
        np.testing.assert_allclose(g.boxes.xyxy, rd[:, :4], atol=0.05 if shrunk else 1e-3, rtol=0, err_msg=f)
        np.testing.assert_allclose(g.boxes.conf, rd[:, 4], atol=1e-3 if shrunk else 1e-5, rtol=0, err_msg=f)


def test_tta_keeps_15049_candidates_at_640():
    """Passes at 640, 544 and 448 px: 8,400 - 400 (P5 dropped), 6,069, and
    4,116 - 3,136 (P3 dropped) rows, boxes in the 640 frame."""
    model = YOLO("yolov8n.yaml", device="cpu").model
    x = torch.from_numpy(np.random.default_rng(1).uniform(0, 1, (1, 3, 640, 640)).astype(np.float32))
    with torch.no_grad():
        y = tta_forward(model, x)
    assert y.shape == (1, 15049, 84)
    assert float(y[..., :2].min()) > -64 and float(y[..., :2].max()) < 704


@pytest.mark.parametrize("cfg,head", [("yolov8n-seg.yaml", "Segment"), ("yolov8n-pose.yaml", "Pose"),
                                      ("yolov8n-obb.yaml", "OBB"), ("yolov10n.yaml", "v10Detect")])
def test_tta_raises_by_name_beyond_the_detect_heads(cfg, head):
    img = np.zeros((64, 64, 3), np.uint8)
    model = YOLO(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match=rf"augment=True.*{head}"):
        model.predict([img], imgsz=64, augment=True)


# -- rect ----------------------------------------------------------------------------

@pytest.mark.parametrize("batch", [5, 8])
def test_rect_batches_match_jax(fixture_copy, batch):
    from ultralytics_pro_tpu.data.dataset import YOLODataset as JDataset

    d = check_det_dataset(fixture_copy / "data.yaml")
    port = YOLODataset(d["val"], imgsz=160, data=d, rect=True, batch_size=batch)
    ref = JDataset(d["val"], imgsz=160, data=d, rect=True, batch_size=batch)
    assert port.im_files == ref.im_files
    np.testing.assert_array_equal(port.batch_index, ref.batch_index)
    np.testing.assert_array_equal(port.batch_shapes, ref.batch_shapes)
    assert len({tuple(s) for s in port.batch_shapes}) > 1
    for i in (0, len(port) - 1):
        got, want = port[i], ref[i]
        assert got["img"].shape == want["img"].shape == (*port.batch_shapes[port.batch_index[i]], 3)
        assert got["ratio_pad"][1] == want["ratio_pad"][1]


@pytest.fixture(scope="module")
def rect_json(models, fixture_copy, tmp_path_factory):
    """A rect val with save_json by each facade: (port metrics, JAX metrics,
    port predictions.json, JAX predictions.json)."""
    port, jax_yolo = models
    root = tmp_path_factory.mktemp("rect_json")
    data = str(fixture_copy / "data.yaml")
    got = port.val(data=data, rect=True, save_json=True, project=str(root / "port"), **VAL_KW)
    want = jax_yolo.val(data=data, rect=True, save_json=True, plots=False, project=str(root / "jax"), **VAL_KW)
    return got, want, root / "port" / "predictions.json", root / "jax" / "predictions.json"


def test_rect_val_matches_jax(rect_json):
    got, want, _, _ = rect_json
    for k, v in want.results_dict.items():
        assert got.results_dict[k] == pytest.approx(float(v), abs=1e-3), k


def test_rect_val_reads_png_headers_with_pil_blocked(fixture_copy, tmp_path):
    """With PIL refused as well (the card's machine has none), a rect val of
    the PNG set runs and takes the same batch shapes."""
    then = f"""
import numpy as np
from ultralytics_pro_tpu_torch import YOLO
from ultralytics_pro_tpu_torch.data import YOLODataset, check_det_dataset
from ultralytics_pro_tpu_torch.nn.tasks import yaml_model_load
d = check_det_dataset({str(fixture_copy / 'data.yaml')!r})
shapes = YOLODataset(d['val'], imgsz=160, data=d, rect=True, batch_size=8).batch_shapes
np.save({str(tmp_path / 'shapes.npy')!r}, shapes)
m = YOLO({{**yaml_model_load('yolov8n.yaml'), 'nc': 3}}, device='cpu')
assert m.val(data=d, rect=True, imgsz=160, batch=8, workers=2).box.map50 >= 0
"""
    out = subprocess.run([sys.executable, "-c", _blocker(BLOCKED + ("PIL",), then)], capture_output=True, text=True,
                         cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    d = check_det_dataset(fixture_copy / "data.yaml")
    want = YOLODataset(d["val"], imgsz=160, data=d, rect=True, batch_size=8).batch_shapes
    np.testing.assert_array_equal(np.load(tmp_path / "shapes.npy"), want)


# -- cache ---------------------------------------------------------------------------

@pytest.mark.parametrize("cache", ["ram", "disk"])
def test_cached_val_equals_uncached(models, tmp_path, cache):
    data = shutil.copytree(FIXTURE_SET, tmp_path / "set") / "data.yaml"
    port = models[0]
    plain = port.val(data=str(data), **VAL_KW)
    cached = port.val(data=str(data), cache=cache, **VAL_KW)
    assert len(list((tmp_path / "set" / "images" / "val").glob("*.npz"))) == (16 if cache == "disk" else 0)
    again = port.val(data=str(data), cache=cache, **VAL_KW)  # the disk cache read back
    for k, v in plain.results_dict.items():
        assert cached.results_dict[k] == again.results_dict[k] == v, k


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_disk_cache_is_read_by_the_other_package(tmp_path, writer):
    """One package writes the `.npz` files (im, shape); the other's dataset,
    asked for the disk cache, returns those images and original shapes."""
    from ultralytics_pro_tpu.data.dataset import YOLODataset as JDataset

    shutil.copytree(FIXTURE_SET, tmp_path / "set")
    d = check_det_dataset(tmp_path / "set" / "data.yaml")
    make = {"jax": JDataset, "port": YOLODataset}
    first = make[writer](d["val"], imgsz=128, data=d, cache="disk")
    files = sorted((tmp_path / "set" / "images" / "val").glob("*.npz"))
    assert len(files) == 16
    stamp = [f.stat().st_mtime_ns for f in files]
    second = make["port" if writer == "jax" else "jax"](d["val"], imgsz=128, data=d, cache="disk")
    assert [f.stat().st_mtime_ns for f in files] == stamp  # read, not rewritten
    for i in range(len(first)):
        im, ori, resized = second.load_image(i)
        with np.load(files[i]) as z:
            cached, shape = z["im"], tuple(int(v) for v in z["shape"])
        np.testing.assert_array_equal(im, cached)
        assert tuple(int(v) for v in ori) == shape == imread(first.im_files[i]).shape[:2]
        assert tuple(resized) == cached.shape[:2] and max(resized) == 128


# -- save_json and COCO evaluation ---------------------------------------------------------

def test_predictions_json_matches_jax(rect_json):
    _, _, port_file, jax_file = rect_json
    got, want = json.loads(port_file.read_text()), json.loads(jax_file.read_text())
    assert len(got) == len(want) > 100
    for g, w in zip(got, want):
        assert (g["image_id"], g["category_id"]) == (w["image_id"], w["category_id"])
        assert isinstance(g["image_id"], str) and g["image_id"].startswith("val")
        np.testing.assert_allclose(g["bbox"], w["bbox"], atol=1e-3 + 1e-9, rtol=0)  # one step of the rounding
        assert g["score"] == pytest.approx(w["score"], abs=1e-5)


def test_coco_evaluate_matches_jax_on_the_predictions(rect_json, fixture_copy, tmp_path):
    from ultralytics_pro_tpu.engine.validator import DetectionValidator as JValidator
    from ultralytics_pro_tpu.utils.cocoeval import COCOEvalNp as JCOCOEvalNp
    from ultralytics_pro_tpu_torch.engine.validator import DetectionValidator

    _, _, port_file, _ = rect_json
    gt = tmp_path / "gt.json"
    gt.write_text(json.dumps(coco_ground_truth(fixture_copy)))
    got = DetectionValidator().coco_evaluate(gt, port_file)
    want = JCOCOEvalNp(str(gt), str(port_file)).run()
    assert got == want and 0.3 < got["map50-95"] < got["map50"] <= 1
    assert JValidator().coco_evaluate(gt, port_file) == want  # the JAX validator's numpy branch


def _hand_gt(images, anns, cats=(0, 1)):
    return {"images": [{"id": i, "width": 100, "height": 100} for i in images],
            "annotations": [{"id": k, "image_id": a[0], "category_id": a[1], "bbox": list(a[2]),
                             "area": a[2][2] * a[2][3], "iscrowd": a[3] if len(a) > 3 else 0}
                            for k, a in enumerate(anns)],
            "categories": [{"id": c} for c in cats]}


def _pred(image, cat, box, score):
    return {"image_id": image, "category_id": cat, "bbox": list(box), "score": score}


HAND_CASES = {  # tests/test_cocoeval.py's cases: (gt, predictions, the mAP50-95 there)
    "perfect": (_hand_gt([0, 1], [(0, 0, (10, 10, 20, 20)), (1, 1, (30, 30, 10, 10))]),
                [_pred(0, 0, (10, 10, 20, 20), 0.9), _pred(1, 1, (30, 30, 10, 10), 0.8)], 1.0),
    "false_positive_ranked_first": (_hand_gt([0], [(0, 0, (10, 10, 20, 20))], cats=(0,)),
                                    [_pred(0, 0, (10, 10, 20, 20), 0.5), _pred(0, 0, (60, 60, 10, 10), 0.9)], 0.5),
    "iou_threshold_cut": (_hand_gt([0], [(0, 0, (0, 0, 10, 10))], cats=(0,)), [_pred(0, 0, (2, 0, 10, 10), 0.9)], 0.4),
    "crowd_gt_not_matched": (_hand_gt([0], [(0, 0, (0, 0, 20, 20), 1)], cats=(0,)),
                             [_pred(0, 0, (0, 0, 20, 20), 0.9)], 0.0),
}


@pytest.mark.parametrize("case", list(HAND_CASES))
def test_cocoeval_matches_jax_on_the_hand_cases(case):
    from ultralytics_pro_tpu.utils.cocoeval import COCOEvalNp as JCOCOEvalNp

    gt, pred, map5095 = HAND_CASES[case]
    got = COCOEvalNp(gt, pred).run()
    assert got == JCOCOEvalNp(gt, pred).run()
    assert got["map50-95"] == pytest.approx(map5095, abs=1e-6)
