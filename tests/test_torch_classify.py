"""The port's classify task (head, model, data, predict, val, criterion and
trainer) against the JAX package, on the CPU.

Weights are seeded numpy values (`randomize`) or the JAX-trained yolov8n-cls
of `tests/fixtures/val_parity_cls_model.npz` (nc 3), carried between the
packages by the weight carrier; data is the committed PNG set
`tests/fixtures/torch_cls_synth/` (80 x 64 images, 3 classes), made by
`tests/fixtures/make_cls_fixture.py`.

Tolerances, stated where they are checked: 1e-5 absolute on the head's and
a narrow model's outputs and on predict's probabilities (f32 values of order
1); the transform and the dataset's images exactly; top-1 and top-5 exactly;
the criterion within 1e-5 relative and its gradient within 1e-4 of its
largest entry; the trainer as tests/test_torch_train.py holds detect's.
"""

import contextlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from chip_smoke import cls_fixture_model
from tests.conftest import FIXTURES
from tests.test_torch_modules import nchw, randomize, torch_threads  # noqa: F401 (autouse fixture)
from tests.test_torch_train import TREES, assert_trees_close
from ultralytics_pro_tpu_torch import YOLO
from ultralytics_pro_tpu_torch.data import (
    ClassificationDataset,
    DataLoader,
    check_cls_dataset,
    classify_transforms,
    collate_classify,
)
from ultralytics_pro_tpu_torch.engine.trainer import _ClassifyCriterion, load_pickle, param_group
from ultralytics_pro_tpu_torch.nn.modules import Classify
from ultralytics_pro_tpu_torch.nn.tasks import ClassificationModel, yaml_model_load
from ultralytics_pro_tpu_torch.utils.weights import jax_to_torch_state_dict, torch_state_dict_to_jax

ATOL = 1e-5
SET = Path(FIXTURES) / "torch_cls_synth"
REF = json.loads((Path(FIXTURES) / "val_parity_cls_ref.json").read_text())
NC = REF["nc"]
# 64 px: at 32 px the P5 map is 1 x 1, and train-mode BN over a batch's 4
# values amplifies the two frameworks' f32 rounding to 4e-5 in the logits
TRAIN_KW = dict(epochs=2, imgsz=64, batch=4, nbs=8, warmup_epochs=0.0, val=False, workers=2, save_period=1)


def cls_yaml(nc: int = NC) -> dict:
    y = yaml_model_load("yolov8n-cls.yaml")
    y["nc"] = nc
    return y


def fixture_model() -> YOLO:
    """The JAX-trained yolov8n-cls (nc 3) in the port, on the CPU."""
    return cls_fixture_model(YOLO, yaml_model_load, "cpu")


def jax_facade(port: YOLO):
    """The JAX YOLO facade with the port model's weights."""
    from ultralytics_pro_tpu import YOLO as JYOLO

    model = JYOLO(dict(port.model.yaml))
    model.model.variables = torch_state_dict_to_jax(port.model.state_dict())
    return model


@contextlib.contextmanager
def two_pass_bn_variance():
    """The JAX BN's two-pass batch variance (torch's form) inside the block;
    its default one-pass form differs by f32 cancellation in train mode."""
    from ultralytics_pro_tpu.nn.modules import conv as jconv

    saved = jconv.BN_FAST_VARIANCE[0]
    jconv.BN_FAST_VARIANCE[0] = False
    try:
        yield
    finally:
        jconv.BN_FAST_VARIANCE[0] = saved


@pytest.fixture(scope="module")
def pair():
    """(port fixture model, JAX facade on the same weights)."""
    port = fixture_model()
    return port, jax_facade(port)


def test_classify_head_matches_jax():
    """Conv to 1280, mean, linear: eval gives the softmax, train the logits;
    two inputs are concatenated along the channels."""
    import jax

    from ultralytics_pro_tpu.nn.modules.head import Classify as JClassify

    rng = np.random.default_rng(1)
    xs = [rng.normal(0, 1, (2, 6, 5, c)).astype(np.float32) for c in (8, 4)]
    jm = JClassify(c2=10)
    v = randomize(jm.init(jax.random.PRNGKey(0), xs, train=False), seed=2)
    tm = Classify(12, 10)
    tm.load_state_dict(jax_to_torch_state_dict(v))  # strict: conv.conv, conv.bn, linear
    with torch.no_grad():
        got = tm.eval()([nchw(x) for x in xs])
        ref = jm.apply(v, xs, train=False)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
        logits = tm.train()([nchw(x) for x in xs])
    ref_logits, _ = jm.apply(v, xs, train=True, mutable=["batch_stats"])
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), atol=ATOL, rtol=0)


def test_narrow_classify_model_matches_jax_and_carries_its_linear_layer():
    """yolov8n-cls at nc 10 on seeded weights: eval probabilities and
    train-mode logits (two-pass BN variance) within 1e-5, at 64 px (see
    TRAIN_KW). The carrier maps flax's Dense kernel (in, out) to
    Linear.weight (out, in) and back exactly, and the trainer
    decays the linear weight (group 0) and not its bias, as the JAX trainer
    groups `kernel` and `bias`."""
    import jax

    from ultralytics_pro_tpu.engine.trainer import param_group as jparam_group
    from ultralytics_pro_tpu.nn.tasks import ClassificationModel as JModel

    jm = JModel(cls_yaml(10))
    v = randomize(jm.init_params(imgsz=32), seed=3)
    tm = ClassificationModel(cls_yaml(10))
    tm.load_state_dict(jax_to_torch_state_dict(v))
    assert tm.model[-1].linear.weight.shape == (10, 1280) and v["params"]["layers_9"]["linear"]["kernel"].shape == (
        1280, 10)
    np.testing.assert_array_equal(tm.model[-1].linear.weight.detach().numpy(),
                                  v["params"]["layers_9"]["linear"]["kernel"].T)
    back = torch_state_dict_to_jax(tm.state_dict())
    assert_trees_close(back, v, 0.0, "round trip")
    owners = dict(tm.named_modules())
    assert [param_group(owners["model.9.linear"], leaf) for leaf in ("weight", "bias")] == \
        [jparam_group(("layers_9", "linear", leaf)) for leaf in ("kernel", "bias")] == [0, 2]

    x = np.random.default_rng(4).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    with torch.no_grad():
        got = tm.eval()(nchw(x))
        logits = tm.train()(nchw(x))
    ref = jax.jit(lambda vv, xx: jm.apply(vv, xx, train=False))(v, x)
    with two_pass_bn_variance():
        ref_logits, _ = jm.module.apply(v, x, train=True, mutable=["batch_stats"])
    assert got.shape == (2, 10) and torch.allclose(got.sum(-1), torch.ones(2))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), atol=ATOL, rtol=0)


def test_classify_predict_matches_jax(pair):
    """Images already at imgsz (the square resize is the identity on both
    sides): probabilities within 1e-5, top1 and top5 equal."""
    port, jax_yolo = pair
    rng = np.random.default_rng(5)
    imgs = [rng.integers(0, 256, (64, 64, 3), dtype=np.uint8) for _ in range(2)]
    imgs.append(np.ascontiguousarray(ClassificationDataset(SET / "val", imgsz=64)[6]["img"]))
    got, ref = port.predict(imgs, imgsz=64), jax_yolo.predict(imgs, imgsz=64)
    for g, r in zip(got, ref):
        rp = np.asarray(r.probs.data)
        assert g.boxes is None and g.probs.data.shape == (NC,)
        np.testing.assert_allclose(g.probs.data, rp, atol=ATOL, rtol=0)
        assert g.probs.top1 == r.probs.top1 and g.probs.top5 == list(np.argsort(-rp, kind="stable")[:5])
    assert got[2].probs.top1 == 1  # a val image of class1


@pytest.mark.parametrize("hw", [(64, 80), (80, 64), (64, 64), (65, 97)])
def test_classify_transforms_match_jax(hw):
    """Short side 64 at size 64 (the resize is the identity, the crop cuts
    the long side): equal to the JAX transform exactly. (65, 97) resizes:
    to (96, 64) on both sides, pixels within one grey level (cv2's
    fixed-point bilinear against resize_bilinear)."""
    from ultralytics_pro_tpu.data.augment import classify_transforms as jtf

    im = np.random.default_rng(6).integers(0, 256, (*hw, 3), dtype=np.uint8)
    got, want = classify_transforms(64)(im), jtf(64)(im)
    assert got.shape == want.shape == (64, 64, 3)
    if min(hw) == 64:
        np.testing.assert_array_equal(got, want)
    else:
        assert np.abs(got.astype(int) - want).max() <= 1


def test_classification_dataset_and_loader_match_jax():
    """The same samples in the same order (sorted classes, sorted files),
    the same images at 64 px, and the same batches at batch 6, the last
    padded by 2 copies."""
    from ultralytics_pro_tpu.data.build import DataLoader as JLoader
    from ultralytics_pro_tpu.data.build import collate_classify as jcollate
    from ultralytics_pro_tpu.data.dataset import ClassificationDataset as JDataset
    from ultralytics_pro_tpu.data.utils import check_cls_dataset as jcheck

    d, dj = check_cls_dataset(SET), jcheck(SET)
    assert {k: d[k] for k in ("train", "val", "names", "nc")} == {k: dj[k] for k in ("train", "val", "names", "nc")}
    ours, theirs = ClassificationDataset(d["val"], imgsz=64), JDataset(dj["val"], imgsz=64)
    assert ours.samples == theirs.samples and len(ours) == 16
    mine = list(DataLoader(ours, batch_size=6, workers=2, collate_fn=collate_classify))
    want = list(JLoader(theirs, batch_size=6, workers=2, collate_fn=jcollate))
    assert [b["pad_count"] for b in mine] == [b["pad_count"] for b in want] == [0, 0, 2]
    for g, w in zip(mine, want):
        np.testing.assert_array_equal(g["img"], w["img"])
        np.testing.assert_array_equal(g["cls"], w["cls"])
        assert g["img"].shape == (6, 64, 64, 3) and g["cls"].dtype == np.int64


@pytest.mark.parametrize("what", ["augment", "synth", "yolo_dataset"])
def test_classify_data_refuses_what_it_does_not_port(what, tmp_path):
    """A missing synthetic set names item 10, and YOLODataset(task='classify')
    the classify dataset; augment=True, once refused, now gives augmented
    samples (tests/test_torch_augment.py holds them to
    the JAX dataset's)."""
    from ultralytics_pro_tpu_torch.data import YOLODataset

    if what == "augment":
        item = ClassificationDataset(SET / "train", imgsz=64, augment=True)[0]
        assert item["img"].shape == (64, 64, 3) and item["img"].dtype == np.uint8
    elif what == "synth":
        (tmp_path / "cls.yaml").write_text("path: missing\nsynth: classify\n")
        with pytest.raises(FileNotFoundError, match="item 10"):
            check_cls_dataset(tmp_path / "cls.yaml")
    else:
        with pytest.raises(NotImplementedError, match="ClassificationDataset"):
            YOLODataset(str(SET / "val"), imgsz=64, task="classify")


def _correct_rows(metrics) -> int:
    return len(np.concatenate(metrics._correct))


def test_classify_val_matches_jax_and_skips_the_pad(pair):
    """At batch 16 (no pad) top1 and top5 equal the JAX validator's and the
    reference json's. At batch 6 the last batch holds 2 copies of the last
    image: the port scores 16 images and keeps the same numbers; the JAX
    ClassificationValidator scores the copies too (18 rows), a JAX-side
    difference (ROADMAP.md section 3)."""
    port, jax_yolo = pair
    got16 = port.val(data=str(SET), imgsz=64, batch=16)
    want16 = jax_yolo.val(data=str(SET), imgsz=64, batch=16)
    assert (got16.top1, got16.top5) == (want16.top1, want16.top5) == (REF["results"]["top1"], REF["results"]["top5"])
    assert got16.fitness == (got16.top1 + got16.top5) / 2
    assert got16.results_dict["metrics/accuracy_top1"] == got16.top1
    got6 = port.val(data=str(SET), imgsz=64, batch=6)
    want6 = jax_yolo.val(data=str(SET), imgsz=64, batch=6)
    assert (got6.top1, got6.top5) == (got16.top1, got16.top5)
    assert _correct_rows(got6) == _correct_rows(got16) == _correct_rows(want16) == 16
    assert _correct_rows(want6) == 18


def test_classify_criterion_and_its_gradient_match_jax():
    """Mean NLL of the log-softmax, times B, part 'cls' the mean."""
    import jax
    import jax.numpy as jnp

    from ultralytics_pro_tpu.engine.trainer import _ClassifyCriterion as JCriterion

    rng = np.random.default_rng(7)
    logits = rng.normal(0, 3, (8, 10)).astype(np.float32)
    labels = rng.integers(0, 10, 8)
    x = torch.from_numpy(logits).requires_grad_(True)
    total, parts = _ClassifyCriterion()(x, {"cls": torch.from_numpy(labels)}, (32, 32))
    total.backward()

    def jfn(p):
        return JCriterion()(p, {"cls": jnp.asarray(labels)}, (32, 32))

    (jtotal, jparts), jgrad = jax.value_and_grad(jfn, has_aux=True)(jnp.asarray(logits))
    assert float(total) == pytest.approx(float(jtotal), rel=1e-5)
    assert list(parts) == list(jparts) == ["cls"]
    assert float(parts["cls"]) == pytest.approx(float(jparts["cls"]), rel=1e-5)
    g = np.asarray(jgrad)
    np.testing.assert_allclose(x.grad.numpy(), g, atol=1e-4 * np.abs(g).max(), rtol=0)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Both trainers from the fixture weights on the fixture set: 2 epochs at
    64 px, batch 4, nbs 8 (accumulate 2), no warmup: 6 micro-batches and 3
    optimizer steps an epoch."""
    root = tmp_path_factory.mktemp("cls_runs")
    port = fixture_model()
    jax_yolo = jax_facade(port)
    port.train(data=str(SET), project=str(root / "port"), **TRAIN_KW)
    with two_pass_bn_variance():
        jax_yolo.train(data=str(SET), project=str(root / "jax"), device=1, **TRAIN_KW)
    return port, jax_yolo


def test_classification_trainer_matches_jax_step_for_step(trained):
    """Per-epoch mean losses within 1e-4 relative; parameters, EMA, BN
    statistics and momentum buffers within tests/test_torch_train.py's
    TREES; the EMA parameters left on the model; nc kept at the set's 3."""
    port, jax_yolo = trained
    tp, tj = port.trainer, jax_yolo.trainer
    assert (tp.accumulate, tp.opt_steps) == (tj.accumulate, tj.opt_steps) == (2, 6)
    assert len(tp.loss_history) == len(tj.loss_history) == 2
    for got, want in zip(tp.loss_history, tj.loss_history):
        assert list(got) == list(want) == ["cls"]
        assert got["cls"] == pytest.approx(want["cls"], rel=1e-4)
    cp, cj = load_pickle(tp.wdir / "last.ckpt"), load_pickle(tj.wdir / "last.ckpt")
    assert cp["ema_updates"] == cj["ema_updates"] == 6 and cp["model_yaml"]["nc"] == NC
    for key, tol in TREES.items():
        assert_trees_close(cp[key], cj[key], tol, key)
    on_model = torch_state_dict_to_jax(port.model.state_dict())
    assert_trees_close(on_model["params"], cp["ema"], 0.0, "params on the model vs ema")


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_classify_checkpoint_loads_in_both_packages(trained, writer):
    """A last.ckpt of either package: YOLO(ckpt) in the port and in JAX give
    the same probabilities (1e-5), at the checkpoint's imgsz by default,
    and the port's val() finds its training set."""
    from ultralytics_pro_tpu import YOLO as JYOLO

    port, jax_yolo = trained
    path = str((port if writer == "port" else jax_yolo).trainer.wdir / "last.ckpt")
    model, ref = YOLO(path, device="cpu"), JYOLO(path)
    assert model.task == "classify" and model.model.nc == NC and model.overrides["imgsz"] == 64
    imgs = [np.random.default_rng(8).integers(0, 256, (64, 64, 3), dtype=np.uint8)]
    np.testing.assert_allclose(model.predict(imgs)[0].probs.data, np.asarray(ref.predict(imgs)[0].probs.data),
                               atol=ATOL, rtol=0)
    if writer == "port":
        assert 0 <= model.val().top1 <= 1
