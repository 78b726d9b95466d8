"""Training of yolo11n and yolov10n in the port against the JAX trainer, on the CPU.

Both packages start from the port's seeded weights at nc 3 (carried to JAX
through `torch_state_dict_to_jax`) and train one epoch of the detect
fixture set (16 images, train = val) at 160 px, batch 8, nbs 16: two
micro-batches, one optimizer step, no warmup. Both loaders shrink with cv2's
INTER_AREA (`same_images_as_jax`), and the JAX side runs with its two-pass
BN variance on one device, as tests/test_torch_train.py runs them. yolov10n
trains with E2EDetectLoss (parts `o2m_*` and `o2o_*`).

At random initialisation on these flat synthetic images the JAX package's
float32 train-mode forward is some 2e-4 to 6e-4 of each map's largest value
from the port's float64 forward, where the port's float32 forward is within
5e-5 (`test_train_forward_precision_against_float64`): train-mode BatchNorm
amplifies the statistics' rounding where a channel's spread is small, and
PyTorch's CPU BatchNorm accumulates its statistics in float64. The step
compounds that through near-ties of the assigner. So the step is held to
the JAX one as tests/test_torch_rtdetr_train.py holds RT-DETR's (its
JAX_STEP_TOL): loss parts within 1e-3 relative (read: 3.2e-4 for yolo11n,
3.9e-5 for yolov10n); parameters, EMA and BN statistics within 1e-4 of the
tree's largest magnitude (read: 1.25e-5 at most); momentum buffers, the
step's gradient, within JAX_STEP_TOL as relative L2 distances (read: tree
0.004 and 0.008, worst leaf 0.008 and 0.016). A checkpoint loaded in either
package predicts the same: detections in the same order, boxes within 1e-3
px and scores within 1e-5.
"""

import numpy as np
import pytest
import torch

from tests.test_torch_modules import torch_threads  # noqa: F401 (autouse fixture)
from tests.test_torch_rtdetr_train import JAX_STEP_TOL, rel_l2
from tests.test_torch_train import leaves, same_images_as_jax, task_data_yaml
from ultralytics_pro_tpu_torch import YOLO
from ultralytics_pro_tpu_torch.cfg import DEFAULT_CFG_DICT
from ultralytics_pro_tpu_torch.engine.trainer import DetectionTrainer, load_pickle
from ultralytics_pro_tpu_torch.nn.modules.head import v10Detect
from ultralytics_pro_tpu_torch.nn.tasks import yaml_model_load
from ultralytics_pro_tpu_torch.utils.loss import E2EDetectLoss, v8DetectionLoss
from ultralytics_pro_tpu_torch.utils.weights import torch_key_to_flax, torch_state_dict_to_jax

NC = 3
KW = dict(epochs=1, imgsz=160, batch=8, nbs=16, warmup_epochs=0.0, val=False, workers=2, max_gt=32)
PARTS = {"yolo11n.yaml": ["box", "cls", "dfl"],
         "yolov10n.yaml": [f"{a}_{p}" for a in ("o2m", "o2o") for p in ("box", "cls", "dfl")]}


def port_model(cfg: str) -> YOLO:
    return YOLO({**yaml_model_load(cfg), "nc": NC}, device="cpu", seed=3)


def jax_model(port: YOLO, cfg: str):
    from ultralytics_pro_tpu import YOLO as JYOLO
    from ultralytics_pro_tpu.nn.tasks import yaml_model_load as jyaml

    y = jyaml(cfg)
    y["nc"] = NC
    model = JYOLO(y)
    model.model.variables = torch_state_dict_to_jax(port.model.state_dict())
    return model


@pytest.fixture(scope="module")
def data_yaml(tmp_path_factory):
    return task_data_yaml(tmp_path_factory.mktemp("zoo_train") / "set")


_RUNS = {}


def run(cfg: str, who: str, data_yaml, root):
    """One epoch of cfg (KW) from the port's seeded weights, by the port's
    facade (who "port") or the JAX one ("jax"); each runs once a test process."""
    from ultralytics_pro_tpu.nn.modules import conv as jconv

    if (cfg, who) in _RUNS:
        return _RUNS[cfg, who]
    model = port_model(cfg)
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    out = root / f"{cfg[:-5]}_{who}"
    try:
        if who == "jax":
            model = jax_model(model, cfg)
            saved = jconv.BN_FAST_VARIANCE[0]
            jconv.BN_FAST_VARIANCE[0] = False
            try:
                model.train(data=str(data_yaml), project=str(out), device=1, **KW)
            finally:
                jconv.BN_FAST_VARIANCE[0] = saved
        else:
            with same_images_as_jax():
                model.train(data=str(data_yaml), project=str(out), **KW)
    finally:
        torch.set_num_threads(threads)
    _RUNS[cfg, who] = model
    return model


@pytest.fixture(scope="module")
def runs(data_yaml, tmp_path_factory):
    root = tmp_path_factory.mktemp("zoo_runs")
    return lambda cfg, who: run(cfg, who, data_yaml, root)


def tree_max_rel(got: dict, want: dict) -> float:
    """max |got - want| over a flax tree, over the tree's largest magnitude."""
    got, want = dict(leaves(got)), dict(leaves(want))
    assert got.keys() == want.keys()
    return max(np.abs(got[k] - w).max() for k, w in want.items()) / max(np.abs(w).max() for w in want.values())


@pytest.mark.parametrize("cfg", list(PARTS))
def test_trainer_step_matches_jax(runs, cfg):
    port, jax_yolo = runs(cfg, "port"), runs(cfg, "jax")
    tp, tj = port.trainer, jax_yolo.trainer
    assert isinstance(tp.criterion, E2EDetectLoss if cfg == "yolov10n.yaml" else v8DetectionLoss)
    assert (tp.accumulate, tp.opt_steps) == (tj.accumulate, tj.opt_steps) == (2, 1)
    (got,), (want,) = tp.loss_history, tj.loss_history
    assert list(got) == PARTS[cfg] and set(want) == set(got)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-3), (k, got, want)
    cp, cj = load_pickle(tp.wdir / "last.ckpt"), load_pickle(tj.wdir / "last.ckpt")
    assert cp["ema_updates"] == cj["ema_updates"] == 1
    for key in ("params", "ema", "batch_stats"):
        assert tree_max_rel(cp[key], cj[key]) <= 1e-4, key
    tree, (leaf, where) = rel_l2(cp["momentum_buffer"], cj["momentum_buffer"])
    assert tree <= JAX_STEP_TOL["tree"] and leaf <= JAX_STEP_TOL["leaf"], (tree, leaf, where)
    header = (tp.save_dir / "results.csv").read_text().splitlines()[0]
    assert header == ",".join(["epoch", *[f"train/{k}" for k in sorted(PARTS[cfg])], "metrics/fitness"])


def test_train_forward_precision_against_float64(data_yaml):
    """yolo11n in train mode on the first fixture batch at 160 px: each
    level's raw maps of the port in float32 within 5e-5 of their largest
    value from the port in float64, the JAX package's within 1e-3 (the
    module docstring: the source of the step's tolerances)."""
    import copy

    import jax

    from ultralytics_pro_tpu.nn.modules import conv as jconv
    from ultralytics_pro_tpu.nn.tasks import DetectionModel as JModel
    from ultralytics_pro_tpu.nn.tasks import yaml_model_load as jyaml
    from ultralytics_pro_tpu_torch.data import DataLoader, YOLODataset, check_det_dataset
    from ultralytics_pro_tpu_torch.engine.trainer import device_images

    port = port_model("yolo11n.yaml").model
    port64 = copy.deepcopy(port).double().train()
    d = check_det_dataset(str(data_yaml))
    with same_images_as_jax():
        hb = next(iter(DataLoader(YOLODataset(d["train"], imgsz=160, data=d), batch_size=8, max_gt=32)))
    img = device_images(hb["img"], "cpu")
    y = jyaml("yolo11n.yaml")
    y["nc"] = NC
    jm = JModel(y)
    saved = jconv.BN_FAST_VARIANCE[0]
    jconv.BN_FAST_VARIANCE[0] = False
    try:
        (preds, _) = jax.jit(lambda v, x: jm.module.apply(v, x, train=True, mutable=["batch_stats"]))(
            torch_state_dict_to_jax(port.state_dict()), img.numpy().transpose(0, 2, 3, 1))
    finally:
        jconv.BN_FAST_VARIANCE[0] = saved
    with torch.no_grad():
        got, ref = port.train()(img), port64(img.double())
    for g, w, r in zip(got, preds["feats"], ref):
        r = r.numpy()
        scale = np.abs(r).max()
        assert np.abs(g.numpy() - r).max() <= 5e-5 * scale
        assert np.abs(np.asarray(w).transpose(0, 3, 1, 2) - r).max() <= 1e-3 * scale


def test_v10_one2one_branch_trains_and_carries_both_ways(runs):
    """The one-to-one branch's parameters and BN statistics moved in the
    step, under the flax names `one2one_cv2_i_j` and `one2one_cv3_i_j_k`
    (the light class branch) of both packages' checkpoints."""
    cfg = "yolov10n.yaml"
    fresh = torch_state_dict_to_jax(port_model(cfg).model.state_dict())
    names = {f"one2one_cv2_{i}_{j}" for i in range(3) for j in range(3)} | \
        {f"one2one_cv3_{i}_{j}_{k}" for i in range(3) for j in range(2) for k in range(2)} | \
        {f"one2one_cv3_{i}_2" for i in range(3)}
    for who in ("port", "jax"):
        ckpt = load_pickle(runs(cfg, who).trainer.wdir / "last.ckpt")
        head = ckpt["params"]["layers_23"]
        assert names <= set(head), sorted(names - set(head))
        w = head["one2one_cv3_0_2"]["kernel"]
        assert np.abs(w - fresh["params"]["layers_23"]["one2one_cv3_0_2"]["kernel"]).max() > 0
        m = ckpt["batch_stats"]["layers_23"]["one2one_cv2_0_0"]["bn"]["mean"]
        assert np.abs(m - fresh["batch_stats"]["layers_23"]["one2one_cv2_0_0"]["bn"]["mean"]).max() > 0


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_v10_checkpoint_predicts_the_same_in_both_packages(runs, writer):
    """yolov10n's last.ckpt of either package (its EMA parameters and BN
    statistics), loaded by both facades, predicts the same on two seeded
    images that are only padded at 64 px (no NMS: the top 300 rows above
    conf)."""
    from ultralytics_pro_tpu import YOLO as JYOLO

    path = str(runs("yolov10n.yaml", writer).trainer.wdir / "last.ckpt")
    rng = np.random.default_rng(8)
    imgs = [rng.integers(0, 256, (64, 48, 3), dtype=np.uint8), rng.integers(0, 256, (40, 64, 3), dtype=np.uint8)]
    kw = dict(imgsz=64, conf=1e-3)
    a, b = YOLO(path, device="cpu"), JYOLO(path)
    got, ref = a.predict(imgs, **kw), b.predict(imgs, **kw)
    assert sum(len(r) for r in got) > 0 and isinstance(a.model.model[-1], v10Detect)
    for g, r in zip(got, ref):
        rd = np.asarray(r.boxes.data)
        assert len(g.boxes.data) == len(rd)
        np.testing.assert_array_equal(g.boxes.cls, rd[:, 5])
        np.testing.assert_allclose(g.boxes.xyxy, rd[:, :4], atol=1e-3, rtol=0)
        np.testing.assert_allclose(g.boxes.conf, rd[:, 4], atol=1e-5, rtol=0)


def test_v10_param_groups_match_jax():
    """The one-to-one branch's conv weights decayed (0), BN weights (1),
    biases (2), as the JAX trainer labels its flax leaves."""
    from ultralytics_pro_tpu.engine.trainer import make_group_labels

    model = port_model("yolov10n.yaml")
    trainer = DetectionTrainer(model.model, {**DEFAULT_CFG_DICT, "batch": 2, "nbs": 8, "project": "unused"})
    want = dict(leaves(make_group_labels(torch_state_dict_to_jax(model.model.state_dict())["params"])))
    got = {}
    for g, group in enumerate(trainer.optimizer.param_groups):
        for p in group["params"]:
            name = trainer.param_names[[q is p for q in trainer.params].index(True)]
            path, leaf, _ = torch_key_to_flax(name, p.ndim)
            got[(*path, leaf)] = g
    assert got == {k: int(v) for k, v in want.items()}
    assert got[("layers_23", "one2one_cv3_1_1_1", "bn", "scale")] == 1
    assert got[("layers_23", "one2one_cv2_0_2", "bias")] == 2
    assert isinstance(trainer.criterion, E2EDetectLoss)
