"""The port's pose path against the JAX package, on the CPU.

Modules: the `Pose` head on weights carried from JAX, with 3-value and
2-value keypoints (within 1e-4 of each output's largest magnitude), and a
YAML dict whose `kpt_shape` is overridden building the matching head, as
tests/test_val_parity.py:76-77 does with [5, 3].

Data: labels with the dataset YAML's `kpt_shape`, letterboxed keypoints
(invisible ones at 0) and the collate's keypoints, cls and boxes against the
JAX dataset and `collate_detect`, equal.

Metrics: `kpt_iou` (OKS) within 1e-6 with COCO's 17 sigmas and with 1/nk,
`PoseMetrics` within 1e-6 of the JAX class.

The slice: the reference-trained yolov8n-pose (`val_parity_pose_model.npz`,
nc 3, kpt_shape [5, 3]) through `YOLO(...).val` on the committed PNG set
`tests/fixtures/torch_val_synth_pose/`: box and pose mAP50 and mAP50-95
within 1e-3 of the JAX validator on the same files and within 0.005 of
`val_parity_pose_ref.json`; predict against the JAX PosePredictor: boxes and
keypoints within 1e-3 px. The fixture set is regenerated by
`tests/test_torch_segment.py:make_task_fixture`.
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
    parity_model,
)
from ultralytics_pro_tpu_torch import YOLO
from ultralytics_pro_tpu_torch.data import LetterBox, YOLODataset, check_det_dataset, collate_detect
from ultralytics_pro_tpu_torch.engine.validator import OKS_SIGMA
from ultralytics_pro_tpu_torch.nn.modules.head import Pose
from ultralytics_pro_tpu_torch.nn.tasks import PoseModel, yaml_model_load
from ultralytics_pro_tpu_torch.utils import metrics as port_metrics
from ultralytics_pro_tpu_torch.utils.weights import jax_to_torch_state_dict

SET = Path(FIXTURES) / "torch_val_synth_pose"
REF = json.loads((Path(FIXTURES) / "val_parity_pose_ref.json").read_text())
VAL_KW = dict(imgsz=REF["val_args"]["imgsz"], batch=8, conf=REF["val_args"]["conf"],
              iou=REF["val_args"]["iou"], max_det=REF["val_args"]["max_det"])


@pytest.fixture(scope="module")
def fixture_copy(tmp_path_factory) -> Path:
    """The committed set, copied (the JAX loader writes a label cache)."""
    return Path(shutil.copytree(SET, tmp_path_factory.mktemp("pose") / "set"))


def test_fixture_equals_a_fresh_regeneration(tmp_path):
    assert_fixture_equals_a_fresh_regeneration(tmp_path, SET, REF)


# -- the head ---------------------------------------------------------------

@pytest.mark.parametrize("kpt_shape", [(17, 3), (5, 2)], ids=["xyv", "xy"])
def test_pose_head_matches_jax_on_carried_weights(kpt_shape):
    import jax

    from ultralytics_pro_tpu.nn.modules.head import Pose as JPose

    rng = np.random.default_rng(5)
    strides, nc, chs = (8, 16, 32), 2, (16, 32, 64)
    feats = [rng.normal(0, 1, (2, 64 // s, 64 // s, c)).astype(np.float32) for s, c in zip(strides, chs)]
    jm = JPose(nc=nc, kpt_shape=kpt_shape, strides=strides)
    v = randomize(jm.init(jax.random.PRNGKey(0), feats), 6)
    tm = Pose(nc=nc, ch=chs, kpt_shape=kpt_shape)
    tm.load_state_dict(jax_to_torch_state_dict(v))
    tm.stride = torch.tensor(strides, dtype=torch.float32)
    tm.eval()
    y_ref, aux = jm.apply(v, feats)
    with torch.no_grad():
        y, got = tm([nchw(f) for f in feats])
    nk = kpt_shape[0] * kpt_shape[1]
    assert y.shape == (2, sum((64 // s) ** 2 for s in strides), 4 + nc + nk)
    assert_close_to_largest(y.numpy(), y_ref, what="y")
    assert_close_to_largest(y[..., 4 + nc:].numpy(), np.asarray(y_ref)[..., 4 + nc:], what="keypoints")
    assert_close_to_largest(got["kpt"].numpy(), aux["kpt"], what="kpt")


def test_kpt_shape_override_builds_the_matching_head():
    import jax.numpy as jnp

    from ultralytics_pro_tpu.nn.tasks import PoseModel as JModel

    d = yaml_model_load("yolov8n-pose.yaml")
    assert d["kpt_shape"] == [17, 3] and PoseModel(d).model[-1].kpt_shape == (17, 3)
    d["kpt_shape"] = [5, 3]
    tm = PoseModel(d)
    head = tm.model[-1]
    assert head.kpt_shape == (5, 3) and head.cv4[0][2].out_channels == 15
    jm = JModel(dict(d))
    v = randomize(jm.init_params(imgsz=64), 3)
    tm.load_state_dict(jax_to_torch_state_dict(v))  # strict: the head's shapes agree
    x = np.random.default_rng(2).uniform(0, 1, (1, 64, 64, 3)).astype(np.float32)
    y_ref, _ = jm.apply(v, jnp.asarray(x), train=False)
    with torch.no_grad():
        y, _ = tm(nchw(x))
    assert y.shape == (1, 84, 4 + 1 + 15)
    assert_close_to_largest(y.numpy(), y_ref)


# -- data -------------------------------------------------------------------

def test_letterbox_moves_keypoints_and_keeps_invisible_ones_at_zero():
    from ultralytics_pro_tpu.data.augment import LetterBox as JLetterBox

    img = np.random.default_rng(3).integers(0, 256, (100, 60, 3), dtype=np.uint8)
    k = np.random.default_rng(4).uniform(0, 60, (2, 5, 3)).astype(np.float32)
    k[0, 1, 2] = 0  # invisible
    labels = {"img": img, "bboxes": np.array([[1, 2, 30, 40]], np.float32), "keypoints": k,
              "cls": np.zeros(1, np.float32)}
    got, want = LetterBox((128, 128))(dict(labels)), JLetterBox((128, 128))(dict(labels))
    np.testing.assert_allclose(got["keypoints"], want["keypoints"], atol=1e-5, rtol=0)
    assert (got["keypoints"][0, 1, :2] == 0).all()


def test_dataset_items_and_collate_match_jax(fixture_copy):
    from ultralytics_pro_tpu.data.build import collate_detect as jcollate
    from ultralytics_pro_tpu.data.dataset import YOLODataset as JDataset
    from ultralytics_pro_tpu.data.utils import check_det_dataset as jcheck

    d = check_det_dataset(fixture_copy / "data.yaml")
    assert d["kpt_shape"] == [5, 3]
    got_ds = YOLODataset(d["val"], imgsz=160, data=d, task="pose")
    want_ds = JDataset(d["val"], imgsz=160, data=jcheck(fixture_copy / "data.yaml"), task="pose")
    got = [got_ds[i] for i in range(len(got_ds))]
    want = [want_ds[i] for i in range(len(want_ds))]
    for g, w in zip(got, want):
        assert g["keypoints"].shape == w["keypoints"].shape and g["keypoints"].shape[1:] == (5, 3)
        np.testing.assert_allclose(g["keypoints"], w["keypoints"], atol=1e-5, rtol=0)
        np.testing.assert_allclose(g["bboxes"], w["bboxes"], atol=1e-5, rtol=0)
    gb, wb = collate_detect(got[:8], max_gt=8), jcollate(want[:8], max_gt=8)
    assert gb["keypoints"].shape == wb["keypoints"].shape == (8, 8, 5, 3)
    for k in ("keypoints", "cls", "mask_gt", "bboxes"):
        np.testing.assert_array_equal(gb[k], wb[k], err_msg=k)


def test_two_value_keypoints_get_visibility_two(tmp_path):
    for sub in ("images", "labels"):
        (tmp_path / sub / "val").mkdir(parents=True)
    shutil.copy(SET / "images" / "val" / "val0.png", tmp_path / "images" / "val")
    (tmp_path / "labels" / "val" / "val0.txt").write_text("0 0.5 0.5 0.2 0.2 0.4 0.45 0.6 0.55\n")
    d = {"kpt_shape": [2, 2], "names": {0: "a"}}
    k = YOLODataset(str(tmp_path / "images" / "val"), imgsz=160, data=d, task="pose").labels[0]["keypoints_n"]
    np.testing.assert_allclose(k, [[[0.4, 0.45, 2], [0.6, 0.55, 2]]], atol=1e-6)


# -- metrics ----------------------------------------------------------------

@pytest.mark.parametrize("nk", [17, 5])
def test_kpt_iou_matches_jax(nk):
    from ultralytics_pro_tpu.ops.iou import kpt_iou as jkpt_iou

    rng = np.random.default_rng(nk)
    gt = rng.uniform(0, 160, (6, nk, 3)).astype(np.float32)
    gt[..., 2] = rng.integers(0, 3, (6, nk))
    pred = (gt[None, :, :, :2] + rng.normal(0, 4, (3, 6, nk, 2))).reshape(18, nk, 2).astype(np.float32)
    area = rng.uniform(100, 3000, 6).astype(np.float32)
    sigma = OKS_SIGMA if nk == 17 else np.ones(nk, np.float32) / nk
    got = port_metrics.kpt_iou(gt, pred, area, sigma)
    np.testing.assert_allclose(got, np.asarray(jkpt_iou(gt, pred, area, sigma)), atol=1e-6, rtol=0)
    assert got.shape == (6, 18) and got.max() > 0.5


def test_pose_metrics_match_jax():
    from ultralytics_pro_tpu.utils import metrics as jm

    names = {i: f"c{i}" for i in range(3)}
    got, want = port_metrics.PoseMetrics(names), jm.PoseMetrics(names)
    rng = np.random.default_rng(2)
    for _ in range(3):
        n, m = 40, 9
        tp, tp_p = rng.uniform(0, 1, (n, 10)) < 0.5, rng.uniform(0, 1, (n, 10)) < 0.6
        conf = rng.uniform(0, 1, n).astype(np.float32)
        pred_cls, gt_cls = rng.integers(0, 3, n).astype(np.float32), rng.integers(0, 3, m).astype(np.float32)
        for mt in (got, want):
            mt.update_stats(tp, conf, pred_cls, gt_cls, tp_p=tp_p)
    got.process(), want.process()
    np.testing.assert_allclose(got.pose.mean_results(), want.pose.mean_results(), atol=1e-6)
    np.testing.assert_allclose(got.box.mean_results(), want.box.mean_results(), atol=1e-6)
    assert got.fitness == pytest.approx(want.fitness, abs=1e-6)


# -- the slice: val and predict ---------------------------------------------

@pytest.fixture(scope="module")
def port_val(fixture_copy):
    return parity_model("val_parity_pose", "yolov8n-pose.yaml", REF).val(data=str(fixture_copy / "data.yaml"),
                                                                        **VAL_KW)


@pytest.fixture(scope="module")
def jax_val(fixture_copy):
    model = jax_parity_model("val_parity_pose", "yolov8n-pose.yaml", REF)
    return model.val(data=str(fixture_copy / "data.yaml"), plots=False, **VAL_KW)


MAPS = (("box.map50", "metrics/mAP50(B)"), ("box.map", "metrics/mAP50-95(B)"),
        ("pose.map50", "metrics/mAP50(P)"), ("pose.map", "metrics/mAP50-95(P)"))


@pytest.mark.parametrize("attr,key", MAPS, ids=[a for a, _ in MAPS])
def test_val_map_matches_jax_validator_and_the_reference(port_val, jax_val, attr, key):
    got = metric(port_val, attr)
    assert abs(got - metric(jax_val, attr)) <= 1e-3, (attr, got, metric(jax_val, attr))
    assert abs(got - REF["results"][key]) <= 0.005, (attr, got, REF["results"][key])


def test_predict_matches_jax_predictor():
    imgs = [cv2.imread(str(SET / "images" / "val" / f"val{i}.png")) for i in (0, 1, 2)]
    assert {im.shape[:2] for im in imgs} == {(160, 160), (160, 120), (120, 160)}  # padded only
    kw = dict(imgsz=160, conf=0.25)
    ref = jax_parity_model("val_parity_pose", "yolov8n-pose.yaml", REF).predict(imgs, **kw)
    got = parity_model("val_parity_pose", "yolov8n-pose.yaml", REF).predict(imgs, **kw)
    for g, r in zip(got, ref):
        rd = np.asarray(r.boxes.data)
        assert 0 < len(g) == len(rd)
        np.testing.assert_array_equal(g.boxes.cls, rd[:, 5])
        np.testing.assert_allclose(g.boxes.xyxy, rd[:, :4], atol=1e-3, rtol=0)
        gk, rk = g.keypoints.data, np.asarray(r.keypoints.data)
        assert gk.shape == rk.shape == (len(rd), 5, 3)
        np.testing.assert_allclose(gk[..., :2], rk[..., :2], atol=1e-3, rtol=0)
        np.testing.assert_allclose(gk[..., 2], rk[..., 2], atol=1e-5, rtol=0)


def test_results_keypoints_surface():
    img = np.random.default_rng(0).integers(0, 256, (90, 70, 3), dtype=np.uint8)
    r = YOLO("yolov8n-pose.yaml", device="cpu").predict([img], imgsz=64, conf=1e-6)[0]
    k = r.keypoints
    assert len(k) == len(r.boxes) > 0 and k.data.shape[1:] == (17, 3)
    np.testing.assert_array_equal(k.xy, k.data[..., :2])
    np.testing.assert_allclose(k.xyn, k.data[..., :2] / np.array([70, 90]))
    np.testing.assert_array_equal(k.conf, k.data[..., 2])
    assert k[:1].data.shape == (1, 17, 3)
