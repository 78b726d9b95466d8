"""The port's detect training against the JAX trainer, on the CPU.

Both packages start from the same weights (the reference-trained yolov8n of
`val_parity_model.npz`, nc = 3, carried to JAX through
`torch_state_dict_to_jax`) and train with the same arguments on a copy of
the committed PNG fixture set (`tests/fixtures/torch_val_synth/`, used as
train and val): `YOLO(...).train(data=..., epochs=2, imgsz=64, batch=2,
nbs=8, ...)`. The JAX side runs with its two-pass BN variance
(`BN_FAST_VARIANCE[0] = False`, set for the run and restored) on one device.
The images of both loaders differ by at most one grey level (cv2's INTER_AREA
against `resize_area`, tests/test_torch_val.py).

Tolerances, stated where they are checked: per-epoch mean losses within
1e-4 relative; after the run, parameters, EMA and BN statistics within 1e-4
and momentum buffers within 2e-3 of each tensor's largest magnitude (the
buffer holds the last gradients, whose small entries carry the two
frameworks' f32 rounding); predictions of a checkpoint loaded in either
package within the eval-parity tolerance of tests/test_torch_model.py.
"""

import contextlib
import json
import logging
import pickle
import shutil
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from chip_smoke import TASKS, parity_yolov8n
from tests.conftest import FIXTURES
from tests.test_torch_imports import BLOCKED, REPO, _blocker
from tests.test_torch_modules import torch_threads  # noqa: F401 (autouse fixture)
from ultralytics_pro_tpu_torch import YOLO
from ultralytics_pro_tpu_torch.cfg import DEFAULT_CFG_DICT
from ultralytics_pro_tpu_torch.data import DataLoader, YOLODataset, check_det_dataset
from ultralytics_pro_tpu_torch.engine.model import Model
from ultralytics_pro_tpu_torch.engine.trainer import DetectionTrainer, EarlyStopping, load_pickle
from ultralytics_pro_tpu_torch.nn.tasks import yaml_model_load
from ultralytics_pro_tpu_torch.utils import LOGGER
from ultralytics_pro_tpu_torch.utils.git import GIT
from ultralytics_pro_tpu_torch.utils.weights import jax_to_torch_state_dict, torch_key_to_flax, torch_state_dict_to_jax

NC = 3
TRAIN_KW = dict(epochs=2, imgsz=64, batch=2, nbs=8, warmup_epochs=0.0, val=False, workers=2, max_gt=32,
                save_period=1)
TREES = {"params": 1e-4, "ema": 1e-4, "batch_stats": 1e-4, "momentum_buffer": 2e-3}
SETS = {"detect": {"stem": "val_parity", "fixture_yaml": "yolov8n.yaml", "set": "torch_val_synth"}, **TASKS}
LOSS_PARTS = {"detect": ("box", "cls", "dfl"), "segment": ("box", "seg", "cls", "dfl"),
              "pose": ("box", "pose", "kobj", "cls", "dfl"), "obb": ("box", "cls", "dfl")}


def leaves(tree, path=()):
    for k, v in tree.items():
        yield from leaves(v, (*path, k)) if isinstance(v, dict) else [((*path, k), np.asarray(v))]


def assert_trees_close(got: dict, want: dict, tol: float, what: str):
    got, want = dict(leaves(got)), dict(leaves(want))
    assert got.keys() == want.keys(), what
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0, atol=tol * max(np.abs(w).max(), 1e-12),
                                   err_msg=f"{what} {'/'.join(k)}")


def task_data_yaml(root: Path, task: str = "detect") -> Path:
    """A task's fixture set copied to root (the JAX loader writes a label
    cache), with a train.yaml whose train and val are its images."""
    shutil.copytree(Path(FIXTURES) / SETS[task]["set"], root)
    names = "".join(f"  {i}: shape{i}\n" for i in range(NC))
    kpt = "kpt_shape: [5, 3]\n" if task == "pose" else ""
    (root / "train.yaml").write_text("train: images/val\nval: images/val\n" + kpt + "names:\n" + names)
    return root / "train.yaml"


@pytest.fixture(scope="module")
def data_yaml(tmp_path_factory) -> Path:
    """The fixture set copied, train = val."""
    return task_data_yaml(tmp_path_factory.mktemp("train") / "set")


def port_model(task: str = "detect") -> YOLO:
    """The reference-trained yolov8n of a task (nc 3; pose's top-level
    kpt_shape [5, 3]) on the CPU, as chip_smoke.py builds it."""
    spec = SETS[task]
    ref = json.loads((Path(FIXTURES) / f"{spec['stem']}_ref.json").read_text())
    return parity_yolov8n(YOLO, yaml_model_load, ref, "cpu", spec["stem"], spec["fixture_yaml"])


def jax_model(port: YOLO, task: str = "detect"):
    """The JAX facade at nc = 3 with the port model's weights. Pose's head
    row names its [5, 3] itself: the JAX facade's train rebuilds (and
    re-initialises) a model whose Pose row holds the YAML's `kpt_shape`
    name, even where that is the dataset's shape (ROADMAP.md section 3)."""
    from ultralytics_pro_tpu import YOLO as JYOLO
    from ultralytics_pro_tpu.nn.tasks import yaml_model_load as jyaml

    y = jyaml(SETS[task]["fixture_yaml"])
    y["nc"] = NC
    if task == "pose":
        y["kpt_shape"] = [5, 3]
        y["head"][-1] = [*y["head"][-1][:3], ["nc", [5, 3]]]
    model = JYOLO(y)
    model.model.variables = torch_state_dict_to_jax(port.model.state_dict())
    return model


@contextlib.contextmanager
def same_images_as_jax():
    """The port's loader shrinks images with cv2's INTER_AREA inside the
    block, so both packages train on the same pixels. Its own copy,
    `resize_area`, is within one grey level of cv2's (tests/test_torch_val.py),
    and at 64 px a few values of the detect, segment and pose sets differ by
    one: over 2 epochs the segment and pose steps carry that past the
    momentum buffers' 2e-3, which they hold on the same pixels."""
    import cv2

    from ultralytics_pro_tpu_torch.data import dataset

    saved = dataset.resize_area
    dataset.resize_area = lambda im, size: cv2.resize(im, size, interpolation=cv2.INTER_AREA)
    try:
        yield
    finally:
        dataset.resize_area = saved


def train_both(data_yaml: Path, root: Path, task: str = "detect", **kw):
    """The same training in both packages from the same weights; returns
    (port facade, JAX facade)."""
    from ultralytics_pro_tpu.nn.modules import conv as jconv

    port = port_model(task)
    jax_yolo = jax_model(port, task)
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))  # as torch_threads, which module fixtures run outside of
    saved = jconv.BN_FAST_VARIANCE[0]
    jconv.BN_FAST_VARIANCE[0] = False
    try:
        port.train(data=str(data_yaml), project=str(root / "port"), **kw)
        jax_yolo.train(data=str(data_yaml), project=str(root / "jax"), device=1, **kw)
    finally:
        jconv.BN_FAST_VARIANCE[0] = saved
        torch.set_num_threads(threads)
    return port, jax_yolo


@pytest.fixture(scope="module")
def trained(data_yaml, tmp_path_factory):
    return train_both(data_yaml, tmp_path_factory.mktemp("runs"), **TRAIN_KW)


def assert_same_training(port, jax_yolo):
    tp, tj = port.trainer, jax_yolo.trainer
    assert (tp.accumulate, tp.opt_steps) == (tj.accumulate, tj.opt_steps)
    assert len(tp.loss_history) == len(tj.loss_history) == TRAIN_KW["epochs"]
    for got, want in zip(tp.loss_history, tj.loss_history):
        assert list(got) == list(LOSS_PARTS[port.task]) and got.keys() == want.keys()
        for k in want:
            assert got[k] == pytest.approx(want[k], rel=1e-4), (k, got, want)
    cp, cj = load_pickle(tp.wdir / "last.ckpt"), load_pickle(tj.wdir / "last.ckpt")
    assert cp["ema_updates"] == cj["ema_updates"] == tp.opt_steps
    for key, tol in TREES.items():
        assert_trees_close(cp[key], cj[key], tol, key)
    # the EMA parameters are left on the model, with the live statistics
    on_model = torch_state_dict_to_jax(port.model.state_dict())
    assert_trees_close(on_model["params"], cp["ema"], 0.0, "params on the model vs ema")
    assert_trees_close(on_model["batch_stats"], cp["batch_stats"], 0.0, "statistics on the model")
    return cp, cj


def test_train_matches_jax_step_for_step(trained):
    """batch 2, nbs 8 -> accumulate 4; no warmup; 16 images -> 8 micro-batches an epoch."""
    port, jax_yolo = trained
    assert port.trainer.accumulate == 4 and port.trainer.opt_steps == 4
    cp, cj = assert_same_training(port, jax_yolo)
    assert sorted(cp) == sorted(cj)
    assert cp["epoch"] == cj["epoch"] == 1
    assert cp["model_yaml"]["nc"] == NC


def test_train_with_warmup_matches_jax(data_yaml, tmp_path):
    """warmup_epochs > 0: nw = max(round(1.0 * 8), 100) = 100 micro-batches
    of warmup, so every step ramps lr (bias from warmup_bias_lr), momentum
    and, with nbs 64 at batch 2, accumulate from 1 towards 32: 5 optimizer
    steps in 16 micro-batches (at 0, 1, 3, 6 and 10)."""
    kw = {**TRAIN_KW, "nbs": 64, "warmup_epochs": 1.0}
    port, jax_yolo = train_both(data_yaml, tmp_path, **kw)
    assert port.trainer.opt_steps == 5 and port.trainer.accumulate == 32
    assert_same_training(port, jax_yolo)


def test_loader_order_matches_jax(data_yaml):
    """shuffle with random.Random(seed + epoch), drop_last, epoch counted per pass."""
    from ultralytics_pro_tpu.data.build import DataLoader as JLoader
    from ultralytics_pro_tpu.data.dataset import YOLODataset as JDataset
    from ultralytics_pro_tpu.data.utils import check_det_dataset as jcheck

    d, dj = check_det_dataset(str(data_yaml)), jcheck(str(data_yaml))
    mine = DataLoader(YOLODataset(d["train"], imgsz=32, data=d), batch_size=3, shuffle=True, drop_last=True,
                      workers=2)
    theirs = JLoader(JDataset(dj["train"], imgsz=32, data=dj), batch_size=3, shuffle=True, drop_last=True,
                     workers=2)
    assert len(mine) == len(theirs) == 5
    for _ in range(3):
        got, want = [b["im_files"] for b in mine], [b["im_files"] for b in theirs]
        assert got == want and len(got) == 5
    assert mine.epoch == theirs.epoch == 3
    assert {b["pad_count"] for b in mine} == {0}


def assert_checkpoint_predicts_the_same(path: Path, conf: float = 0.01):
    """A checkpoint loaded by both facades (EMA parameters and BN
    statistics) predicts the same on two seeded images that are only padded
    at 64 px: detections agree in count and class, boxes within 1e-3 px and
    scores within 1e-5 (tests/test_torch_model.py's limits); segment's masks
    differ in at most 1e-3 of their pixels, pose's keypoints within 1e-3 px
    and 1e-5 in visibility, OBB's angles within 1e-5 rad. Below conf 0.01
    (a pose model of random weights) only the keypoints' layout is compared.
    Returns the two facades."""
    from ultralytics_pro_tpu import YOLO as JYOLO

    rng = np.random.default_rng(8)
    imgs = [rng.integers(0, 256, (64, 48, 3), dtype=np.uint8), rng.integers(0, 256, (40, 64, 3), dtype=np.uint8)]
    kw = dict(imgsz=64, conf=conf, iou=0.6)
    port, jax_yolo = YOLO(str(path), device="cpu"), JYOLO(str(path))
    if conf < 0.01:  # random weights: many near-equal scores, so only the layouts are compared
        for r in (*port.predict(imgs, **kw), *jax_yolo.predict(imgs, **kw)):
            assert len(r) > 0 and np.asarray(r.keypoints.data).shape[1:] == port.model.model[-1].kpt_shape
        return port, jax_yolo
    got, ref = port.predict(imgs, **kw), jax_yolo.predict(imgs, **kw)
    assert sum(len(r) for r in got) > 0
    for g, r in zip(got, ref):
        if port.task == "obb":
            rd = np.asarray(r.obb.data)
            assert len(g) == len(rd)
            np.testing.assert_array_equal(g.obb.cls, rd[:, 6])
            np.testing.assert_allclose(g.obb.xywhr[:, :4], rd[:, :4], atol=1e-3, rtol=0)
            np.testing.assert_allclose(g.obb.xywhr[:, 4], rd[:, 4], atol=1e-5, rtol=0)
            np.testing.assert_allclose(g.obb.conf, rd[:, 5], atol=1e-5, rtol=0)
            continue
        rd = np.asarray(r.boxes.data)
        assert len(g.boxes.data) == len(rd)
        np.testing.assert_array_equal(g.boxes.cls, rd[:, 5])
        np.testing.assert_allclose(g.boxes.xyxy, rd[:, :4], atol=1e-3, rtol=0)
        np.testing.assert_allclose(g.boxes.conf, rd[:, 4], atol=1e-5, rtol=0)
        if port.task == "segment":
            gm, rm = g.masks.data, np.asarray(r.masks.data)
            assert gm.shape == rm.shape and (gm != rm).mean() <= 1e-3
        if port.task == "pose":
            gk, rk = g.keypoints.data, np.asarray(r.keypoints.data)
            assert gk.shape == rk.shape == (len(rd), 5, 3)
            np.testing.assert_allclose(gk[..., :2], rk[..., :2], atol=1e-3, rtol=0)
            np.testing.assert_allclose(gk[..., 2], rk[..., 2], atol=1e-5, rtol=0)
    return port, jax_yolo


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoint_predicts_the_same_in_both_packages(trained, writer):
    """A last.ckpt of either package, loaded by both facades."""
    port, jax_yolo = trained
    assert_checkpoint_predicts_the_same((port if writer == "port" else jax_yolo).trainer.wdir / "last.ckpt")


def test_checkpoint_train_args_are_the_facade_defaults(trained, monkeypatch):
    """YOLO(ckpt) takes the checkpoint's train_args (less save_dir and plots)
    as the defaults of predict, val and train, under the caller's arguments,
    as the JAX facade does: the run trained at 64 px validates at 64 on its
    training YAML when val() is given no data, with the mAPs of the JAX
    facade's val() of the same checkpoint (within 1e-3, the val tests' bound:
    the loaders' images differ by a grey level)."""
    from ultralytics_pro_tpu import YOLO as JYOLO
    from ultralytics_pro_tpu_torch import data

    port, _ = trained
    path = str(port.trainer.wdir / "last.ckpt")
    model = YOLO(path, device="cpu")
    assert model.overrides["imgsz"] == 64 and model.overrides["batch"] == 2
    assert model.overrides["data"] == port.trainer.args["data"] and "save_dir" not in model.overrides
    assert model._merged_args(imgsz=96)["imgsz"] == 96 and "plots" not in model.overrides
    sizes = []
    dataset = data.YOLODataset
    monkeypatch.setattr(data, "YOLODataset", lambda *a, **k: sizes.append(k["imgsz"]) or dataset(*a, **k))
    got = model.val()
    assert sizes == [64]
    want = JYOLO(path).val()
    assert got.box.map50 > 0.1
    for k in ("map50", "map"):
        assert getattr(got.box, k) == pytest.approx(float(getattr(want.box, k)), abs=1e-3), k
    model.predict([np.zeros((48, 64, 3), np.uint8)])
    assert model.predictor.args["imgsz"] == 64


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_resume_continues_from_a_checkpoint_of_either_package(trained, data_yaml, tmp_path, writer):
    """epoch1.ckpt (save_period=1) resumed with epochs=2: the trainer takes
    its parameters, statistics, momentum buffers, EMA and EMA count, and
    trains epoch 2 on from there."""
    port, jax_yolo = trained
    path = (port if writer == "port" else jax_yolo).trainer.wdir / "epoch1.ckpt"
    ckpt = load_pickle(path)
    assert ckpt["epoch"] == 0

    model = port_model()
    trainer = DetectionTrainer(model.model, {**DEFAULT_CFG_DICT, **TRAIN_KW, "project": str(tmp_path)})
    trainer.load_state(path)
    assert trainer.ema_updates == ckpt["ema_updates"] > 0
    moms = [trainer.optimizer.state[p]["momentum_buffer"] for p in trainer.params]
    assert_trees_close(trainer._tree(moms), ckpt["momentum_buffer"], 0.0, "momentum")
    assert_trees_close(trainer._tree(trainer.ema), ckpt["ema"], 0.0, "ema")
    assert_trees_close(torch_state_dict_to_jax(model.model.state_dict())["params"], ckpt["params"], 0.0, "params")

    fresh = port_model()
    other = DetectionTrainer(fresh.model, {**DEFAULT_CFG_DICT, **TRAIN_KW, "project": str(tmp_path)})
    other.resume_from(path)  # parameters and statistics only, and where to start
    assert other.start_epoch == 1 and other.ema_updates == 0
    assert_trees_close(torch_state_dict_to_jax(fresh.model.state_dict())["batch_stats"], ckpt["batch_stats"], 0.0,
                       "statistics")

    model = port_model()
    model.train(data=str(data_yaml), project=str(tmp_path / "resumed"), resume=str(path), **TRAIN_KW)
    tr = model.trainer
    assert tr.start_epoch == 1 and len(tr.loss_history) == 1
    last = load_pickle(tr.wdir / "last.ckpt")
    assert last["epoch"] == 1 and last["ema_updates"] == ckpt["ema_updates"] + tr.opt_steps


def test_jax_checkpoint_unpickles_and_loads_with_jax_blocked(trained):
    """Unpickling a JAX-written checkpoint imports no jax or flax: the port
    loads it into a model in a process that refuses them."""
    path = trained[1].trainer.wdir / "last.ckpt"
    then = ("from ultralytics_pro_tpu_torch import YOLO\n"
            f"m = YOLO({str(path)!r}, device='cpu')\n"
            f"assert m.model.nc == {NC} and m.ckpt['epoch'] == 1")
    out = subprocess.run([sys.executable, "-c", _blocker(BLOCKED, then)], capture_output=True, text=True,
                         cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]


def test_checkpoint_layout_and_run_files(trained):
    port, jax_yolo = trained
    tr = port.trainer
    ckpt = load_pickle(tr.wdir / "last.ckpt")
    assert {"git_branch", "git_commit", "git_origin", "date", "train_args"} <= set(ckpt)
    assert all(isinstance(ckpt[k], str) for k in ("git_branch", "git_commit", "git_origin"))
    assert ckpt["train_args"]["imgsz"] == 64 and ckpt["fitness"] is None
    assert all(isinstance(v, np.ndarray) for _, v in leaves(ckpt["params"]))
    assert not (tr.wdir / "best.ckpt").exists()  # val=False: no fitness, no best
    rows = (tr.save_dir / "results.csv").read_text().splitlines()
    assert rows[0] == "epoch,train/box,train/cls,train/dfl,metrics/fitness" and len(rows) == 3
    assert (tr.save_dir / "results.csv").read_text().count(",") == \
        (jax_yolo.trainer.save_dir / "results.csv").read_text().count(",")


def test_git_fields_are_empty_outside_a_repository(tmp_path):
    assert GIT(tmp_path).as_dict() == {"git_branch": "", "git_commit": "", "git_origin": ""}


def test_param_groups_match_jax():
    """Conv weights decayed (0), BN weights (1) and biases (2), as the JAX
    trainer labels flax's kernel, scale and bias leaves; DFL's bins are not
    trained."""
    from ultralytics_pro_tpu.engine.trainer import make_group_labels

    model = port_model()
    trainer = DetectionTrainer(model.model, {**DEFAULT_CFG_DICT, "batch": 2, "nbs": 8, "project": "unused"})
    want = dict(leaves(make_group_labels(torch_state_dict_to_jax(model.model.state_dict())["params"])))
    got = {}
    for g, group in enumerate(trainer.optimizer.param_groups):
        for p in group["params"]:
            name = trainer.param_names[[q is p for q in trainer.params].index(True)]
            path, leaf, _ = torch_key_to_flax(name, p.ndim)
            got[(*path, leaf)] = g
    assert got == {k: int(v) for k, v in want.items()}
    assert "model.22.dfl.conv.weight" not in trainer.param_names
    wd = [g["weight_decay"] for g in trainer.optimizer.param_groups]
    assert wd == [0.0005 * 2 * 4 / 8, 0.0, 0.0]
    assert all(g["nesterov"] for g in trainer.optimizer.param_groups)
    # `optimizer` is read by nothing: the 3-group SGD runs whatever it says, as in the JAX trainer
    other = DetectionTrainer(model.model, {**DEFAULT_CFG_DICT, "optimizer": "AdamW", "project": "unused"})
    assert type(other.optimizer) is torch.optim.SGD


def test_carried_trees_do_not_alias_the_model():
    """torch_state_dict_to_jax copies: training the model after carrying its
    weights leaves the carried trees (and so a JAX model or a checkpoint
    built from them) as they were."""
    model = port_model()
    tree = torch_state_dict_to_jax(model.model.state_dict())
    before = tree["params"]["layers_0"]["conv"]["kernel"].copy()
    with torch.no_grad():
        model.model.model[0].conv.weight.add_(1.0)
    np.testing.assert_array_equal(tree["params"]["layers_0"]["conv"]["kernel"], before)


def test_schedule_and_early_stopping_match_jax():
    from ultralytics_pro_tpu.engine.trainer import BaseTrainer as JTrainer
    from ultralytics_pro_tpu.engine.trainer import EarlyStopping as JStop

    for cos in (False, True):
        ns = SimpleNamespace(epochs=7, lrf=0.05, cos_lr=cos)
        assert [DetectionTrainer.lr_lambda(ns, e) for e in range(7)] == [JTrainer.lr_lambda(ns, e) for e in range(7)]
    fits = [0.1, None, 0.3, 0.2, 0.25, 0.3, 0.1, 0.05]
    mine, theirs = EarlyStopping(patience=3), JStop(patience=3)
    assert [mine(e, f) for e, f in enumerate(fits)] == [theirs(e, f) for e, f in enumerate(fits)]


def _v8n_with_head(name: str) -> dict:
    y = yaml_model_load("yolov8n.yaml")
    y["head"][-1] = [*y["head"][-1][:2], name, y["head"][-1][3]]
    return y


@pytest.mark.parametrize("case", ["augment", "multi_scale", "remat", "orbax", "device2", "v5_head", "v10_head"])
def test_left_for_later_switches_raise(data_yaml, tmp_path, case):
    """Each names where the port takes it up; none trains a step."""
    kw = dict(TRAIN_KW, project=str(tmp_path))
    calls = {
        "augment": (lambda: port_model().train(data=str(data_yaml), augment=True, **kw), "v8_transforms"),
        "multi_scale": (lambda: port_model().train(data=str(data_yaml), multi_scale=True, **kw), "antialiased"),
        "remat": (lambda: port_model().train(data=str(data_yaml), remat=True, **kw), "torch.utils.checkpoint"),
        "orbax": (lambda: port_model().train(data=str(data_yaml), ckpt_format="orbax", **kw), "orbax"),
        "device2": (lambda: port_model().train(data=str(data_yaml), device=2, **kw), "item 7"),
        "v5_head": (lambda: YOLO(_v8n_with_head("AnchorDetect"), device="cpu"), "item 9"),
        "v10_head": (lambda: YOLO(_v8n_with_head("v10Detect"), device="cpu"), "item 9"),
    }
    call, match = calls[case]
    with pytest.raises(NotImplementedError, match=match):
        call()
    assert not list(tmp_path.rglob("*.ckpt"))


def test_failed_val_is_logged_and_training_goes_on(data_yaml, tmp_path, monkeypatch):
    """The JAX facade trains on when the epoch-end val raises (fitness
    None); the port does so too, and logs the exception. The default
    yolov8n (80 classes) is rebuilt at the dataset's 3."""
    def broken(*args, **kwargs):
        raise RuntimeError("val exploded")

    monkeypatch.setattr(Model, "_quick_val", staticmethod(broken))
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    LOGGER.addHandler(handler)
    try:
        model = YOLO("yolov8n.yaml", device="cpu")
        model.train(data=str(data_yaml), **dict(TRAIN_KW, epochs=1, val=True, project=str(tmp_path)))
    finally:
        LOGGER.removeHandler(handler)
    assert model.model.nc == NC and model.trainer.last_fitness is None
    assert any("val failed" in r.getMessage() and r.exc_info and "val exploded" in str(r.exc_info[1])
               for r in records)
    assert len(model.trainer.loss_history) == 1


def test_val_runs_on_the_ema_parameters_and_restores_the_live_ones(data_yaml, tmp_path):
    """The val function sees the EMA parameters in eval mode; training then
    goes on from the live parameters."""
    model = port_model()
    seen = []

    def val_fn(m):
        seen.append((m.training, torch_state_dict_to_jax(m.state_dict())))
        return 0.5

    loader = DataLoader(YOLODataset(check_det_dataset(str(data_yaml))["train"], imgsz=64), batch_size=2,
                        shuffle=True, drop_last=True, workers=2, max_gt=32)
    trainer = DetectionTrainer(model.model, {**DEFAULT_CFG_DICT, **TRAIN_KW, "epochs": 1,
                                             "project": str(tmp_path)})
    trainer.train(loader, val_fn=val_fn)
    ckpt = load_pickle(trainer.wdir / "best.ckpt")
    assert ckpt["fitness"] == 0.5 == trainer.best_fitness
    training, trees = seen[0]
    assert training is False
    assert_trees_close(trees["params"], ckpt["ema"], 0.0, "val saw the EMA")
    live = jax_to_torch_state_dict({"params": ckpt["params"]})
    assert not torch.equal(live["model.0.conv.weight"], torch.as_tensor(
        jax_to_torch_state_dict({"params": ckpt["ema"]})["model.0.conv.weight"]))
    assert pickle.loads(pickle.dumps(ckpt))["epoch"] == 0


def small_trainer(data_yaml, tmp_path, **args):
    """A 3-epoch trainer at 32 px, batch 8 (2 micro-batches an epoch, a step each), and its loader."""
    loader = DataLoader(YOLODataset(check_det_dataset(str(data_yaml))["train"], imgsz=32), batch_size=8,
                        shuffle=True, drop_last=True, workers=2, max_gt=32)
    trainer = DetectionTrainer(port_model().model, {**DEFAULT_CFG_DICT, **TRAIN_KW, "imgsz": 32, "batch": 8,
                                                    "epochs": 3, "project": str(tmp_path), **args})
    return trainer, loader


@pytest.mark.parametrize("stop", ["time", "patience"])
def test_time_limit_and_patience_end_training_early(data_yaml, tmp_path, stop):
    """`time` (hours) ends training after the epoch that passes it; patience
    ends it after that many epochs without a better fitness."""
    trainer, loader = small_trainer(data_yaml, tmp_path, **({"time": 1e-12} if stop == "time" else {"patience": 1}))
    fits = iter([0.5, 0.4, 0.3])
    trainer.train(loader, val_fn=lambda m: next(fits))
    assert len(trainer.loss_history) == (1 if stop == "time" else 2)
    assert trainer.best_fitness == 0.5 and load_pickle(trainer.wdir / "best.ckpt")["epoch"] == 0


@pytest.mark.parametrize("nan_epoch", [0, 1], ids=["first_epoch", "later_epoch"])
def test_non_finite_loss_restores_the_last_checkpoint(data_yaml, tmp_path, nan_epoch):
    """An epoch whose mean loss is not finite reloads last.ckpt (parameters,
    statistics, momentum, EMA) and goes on with the next epoch, as the JAX
    trainer does; with no checkpoint yet it raises FloatingPointError."""
    trainer, loader = small_trainer(data_yaml, tmp_path)
    criterion = trainer.criterion

    def poisoned(feats, batch, hw):
        total, parts = criterion(feats, batch, hw)
        if trainer._epoch == nan_epoch:
            total, parts = total * torch.nan, {k: v * torch.nan for k, v in parts.items()}
        return total, parts

    trainer.criterion = poisoned
    if nan_epoch == 0:
        with pytest.raises(FloatingPointError, match="non-finite"):
            trainer.train(loader)
        return
    trainer.train(loader)
    assert trainer._nan_attempts == 1 and len(trainer.loss_history) == 3
    assert not np.isfinite(trainer.loss_history[1]["box"]) and np.isfinite(trainer.loss_history[2]["box"])
    last = load_pickle(trainer.wdir / "last.ckpt")
    assert last["epoch"] == 2 and all(np.isfinite(v).all() for _, v in leaves(last["params"]))
    # 2 steps an epoch (batch 8 = nbs): epoch 0's 2, then epoch 1's undone by the restore, then epoch 2's
    assert last["ema_updates"] == 4 and trainer.opt_steps == 6


@pytest.mark.parametrize("trainer", ["DetectionTrainer", "ClassificationTrainer"])
def test_put_batch_gives_contiguous_nchw_images(trainer):
    """On the CPU the device images are RGB / 255 in contiguous NCHW
    (`engine/trainer.py:device_images`). A permuted view of the NHWC batch
    would carry channels-last strides into the model, the CPU's convolutions
    keep that layout, and PyTorch's channels-last train-mode BatchNorm there
    folds the normalisation into x * (g / s) + (b - m * g / s), which loses
    digits where a channel's mean is large against its spread
    (tools/torch_rtdetr_step_precision.py reads it on rtdetr-l's step)."""
    from ultralytics_pro_tpu_torch.engine import trainer as ptrainer

    tr = getattr(ptrainer, trainer).__new__(getattr(ptrainer, trainer))
    tr.device = torch.device("cpu")
    img = np.random.default_rng(0).integers(0, 256, (2, 6, 5, 3), dtype=np.uint8)
    out = tr.put_batch({"img": img, "cls": np.zeros((2, 1), np.float32), "bboxes": np.zeros((2, 1, 4), np.float32),
                        "mask_gt": np.zeros((2, 1), bool)})
    assert out["img"].shape == (2, 3, 6, 5) and out["img"].is_contiguous()
    np.testing.assert_array_equal(out["img"].numpy(), img[..., ::-1].transpose(0, 3, 1, 2).astype(np.float32) / 255.0)
