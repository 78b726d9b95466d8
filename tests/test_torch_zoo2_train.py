"""Training of a narrowed yolov5-anchor and a narrowed gelan-c-dseg in the
port against the JAX trainer, on the CPU.

As tests/test_torch_zoo_train.py does it: both packages start from the
port's seeded weights at nc 3 (carried to JAX through
`torch_state_dict_to_jax`), the fixed-width YAMLs narrowed to depth 0.33 and
width 0.25, and train one epoch of a fixture set (16 images, train = val) at
160 px, batch 8, nbs 16: two micro-batches, one optimizer step, no warmup.
yolov5-anchor trains on the detect set with v5AnchorLoss (parts box, obj,
cls; box gain 0.05, as the JAX trainer takes it when `box` is the v8
default), gelan-c-dseg on the segment set with v8SegmentationLoss through
its DSegment head. Both loaders shrink with cv2's INTER_AREA
(`same_images_as_jax`), and the JAX side runs with its two-pass BN variance
on one device.

The loaders pad the GT slots with 0 x 0 boxes, where the JAX v5AnchorLoss's
gradient is NaN (tests/test_torch_zoo2.py); its criterion here sees them as
0.5 boxes (masked as before), which changes none of its values.

Tolerances are the zoo trainer tests': loss parts within 1e-3 relative;
parameters, EMA and BN statistics within 1e-4 of the tree's largest
magnitude; momentum buffers within JAX_STEP_TOL as relative L2 distances.
One part is held otherwise: gelan-c-dseg's mask part. On this model the JAX
package's float32 train-mode forward is 1.5e-3 to 4e-3 of each map's
largest value from the port's float64 forward (the mask coefficients 3.3e-3,
the prototypes 2.6e-3), where the port's float32 forward is within 6e-5,
and the mask loss reads both at every anchor: the JAX run's part is 4.7e-3
from the port's. So it is held to the JAX run within 1e-2, and the port's
float32 run is held to its own float64 run (the model and the images in
float64) within 1e-4 on every part, the JAX run being the further of the two
(`test_dseg_parts_against_float64`), as tests/test_torch_rtdetr_train.py
holds RT-DETR's step. The criteria alone are held within 1e-3 on every part
on the same inputs: the JAX v8SegmentationLoss fed the port's own
train-mode outputs of gelan-c-dseg and a batch of the segment set
(`test_dseg_criterion_matches_jax_on_the_ports_outputs`).
"""

import numpy as np
import pytest
import torch

from tests.test_torch_modules import torch_threads  # noqa: F401 (autouse fixture)
from tests.test_torch_rtdetr_train import JAX_STEP_TOL, rel_l2
from tests.test_torch_train import same_images_as_jax, task_data_yaml
from tests.test_torch_zoo_train import tree_max_rel
from ultralytics_pro_tpu_torch import YOLO
from ultralytics_pro_tpu_torch.engine.trainer import load_pickle
from ultralytics_pro_tpu_torch.nn.tasks import yaml_model_load
from ultralytics_pro_tpu_torch.utils.loss import v5AnchorLoss, v8SegmentationLoss
from ultralytics_pro_tpu_torch.utils.weights import torch_state_dict_to_jax

NC = 3
NARROW = {"depth_multiple": 0.33, "width_multiple": 0.25}
KW = dict(epochs=1, imgsz=160, batch=8, nbs=16, warmup_epochs=0.0, val=False, workers=2, max_gt=32)
CASES = {  # YAML: (task, criterion, its parts)
    "yolov5-anchor.yaml": ("detect", v5AnchorLoss, ["box", "obj", "cls"]),
    "gelan-c-dseg.yaml": ("segment", v8SegmentationLoss, ["box", "seg", "cls", "dfl"]),
}


def port_model(cfg: str) -> YOLO:
    return YOLO({**yaml_model_load(cfg), **NARROW, "nc": NC}, device="cpu", seed=3)


def jax_model(port: YOLO, cfg: str):
    from ultralytics_pro_tpu import YOLO as JYOLO
    from ultralytics_pro_tpu.nn.tasks import yaml_model_load as jyaml

    model = JYOLO({**jyaml(cfg), **NARROW, "nc": NC})
    model.model.variables = torch_state_dict_to_jax(port.model.state_dict())
    return model


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One epoch of each YAML by each facade, run once a test process."""
    import jax.numpy as jnp

    from ultralytics_pro_tpu.nn.modules import conv as jconv
    from ultralytics_pro_tpu.utils import loss as jloss

    root = tmp_path_factory.mktemp("zoo2_runs")
    done = {}

    def run(cfg: str, who: str):
        if (cfg, who) in done:
            return done[cfg, who]
        task = CASES[cfg][0]
        data = task_data_yaml(root / f"{cfg[:-5]}_{who}_set", task)
        model = port_model(cfg)
        out = root / f"{cfg[:-5]}_{who}"
        if who == "jax":
            model = jax_model(model, cfg)
            saved = jconv.BN_FAST_VARIANCE[0]
            jconv.BN_FAST_VARIANCE[0] = False
            call = jloss.v5AnchorLoss.__call__

            def unit_padded(self, preds, batch, imgsz):
                pad = batch["mask_gt"][..., None] > 0
                return call(self, preds, {**batch, "bboxes": jnp.where(pad, batch["bboxes"], 0.5)}, imgsz)

            try:
                with pytest.MonkeyPatch.context() as mp:
                    mp.setattr(jloss.v5AnchorLoss, "__call__", unit_padded)
                    model.train(data=str(data), project=str(out), device=1, **KW)
            finally:
                jconv.BN_FAST_VARIANCE[0] = saved
        elif who == "port64":
            from ultralytics_pro_tpu_torch.engine.trainer import BaseTrainer

            model.model.double()
            put = BaseTrainer.put_batch
            with same_images_as_jax(), pytest.MonkeyPatch.context() as mp:
                mp.setattr(BaseTrainer, "put_batch", lambda self, b: {**(o := put(self, b)), "img": o["img"].double()})
                model.train(data=str(data), project=str(out), **KW)
        else:
            with same_images_as_jax():
                model.train(data=str(data), project=str(out), **KW)
        done[cfg, who] = model
        return model

    return run


@pytest.mark.parametrize("cfg", list(CASES))
def test_trainer_step_matches_jax(runs, cfg):
    port, jax_yolo = runs(cfg, "port"), runs(cfg, "jax")
    tp, tj = port.trainer, jax_yolo.trainer
    _, criterion, parts = CASES[cfg]
    assert type(tp.criterion) is criterion
    if criterion is v5AnchorLoss:
        assert (tp.criterion.box_gain, tp.criterion.obj_gain) == (0.05, 1.0)
    assert (tp.accumulate, tp.opt_steps) == (tj.accumulate, tj.opt_steps) == (2, 1)
    (got,), (want,) = tp.loss_history, tj.loss_history
    assert list(got) == parts and set(want) == set(got)
    assert all(np.isfinite(v) and v > 0 for v in got.values())
    for k in want:
        rel = 1e-2 if (cfg, k) == ("gelan-c-dseg.yaml", "seg") else 1e-3  # the JAX f32 forward (docstring)
        assert got[k] == pytest.approx(want[k], rel=rel), (k, got, want)
    cp, cj = load_pickle(tp.wdir / "last.ckpt"), load_pickle(tj.wdir / "last.ckpt")
    assert cp["ema_updates"] == cj["ema_updates"] == 1
    for key in ("params", "ema", "batch_stats"):
        assert tree_max_rel(cp[key], cj[key]) <= 1e-4, key
    tree, (leaf, where) = rel_l2(cp["momentum_buffer"], cj["momentum_buffer"])
    assert tree <= JAX_STEP_TOL["tree"] and leaf <= JAX_STEP_TOL["leaf"], (tree, leaf, where)


def test_dseg_parts_against_float64(runs):
    """gelan-c-dseg's loss parts of the port's float32 run within 1e-4 of its
    float64 run; the JAX run's mask part further from it than the port's."""
    cfg = "gelan-c-dseg.yaml"
    (got,), (want,), (ref,) = (runs(cfg, who).trainer.loss_history for who in ("port", "jax", "port64"))
    for k in ref:
        assert got[k] == pytest.approx(ref[k], rel=1e-4), (k, got, ref)
    assert abs(want["seg"] - ref["seg"]) > abs(got["seg"] - ref["seg"])


def test_dseg_criterion_matches_jax_on_the_ports_outputs(tmp_path):
    """The port's v8SegmentationLoss and the JAX one fed the same inputs: the
    narrowed gelan-c-dseg's train-mode outputs in the port (DSegment's head
    maps, mask coefficients and prototypes) on the first batch of 8 images
    of the segment set at 160 px. Each part, the mask part among them, and
    the total within 1e-3 relative."""
    import jax.numpy as jnp

    from ultralytics_pro_tpu.utils import loss as jloss
    from ultralytics_pro_tpu_torch.data import DataLoader, YOLODataset, check_det_dataset
    from ultralytics_pro_tpu_torch.engine.trainer import device_images

    cfg, imgsz = "gelan-c-dseg.yaml", KW["imgsz"]
    d = check_det_dataset(str(task_data_yaml(tmp_path / "set", "segment")))
    with same_images_as_jax():
        host = next(iter(DataLoader(YOLODataset(d["train"], imgsz=imgsz, data=d, task="segment"),
                                    batch_size=KW["batch"], workers=0, max_gt=KW["max_gt"])))
    batch = {k: np.asarray(host[k]) for k in ("cls", "bboxes", "mask_gt", "masks")}
    model = port_model(cfg).model.train()
    with torch.no_grad():
        preds = model(device_images(host["img"], torch.device("cpu")))
    hyp = {"box": 7.5, "cls": 0.5, "dfl": 1.5}
    kw = dict(nc=NC, reg_max=16, strides=model.stride.tolist(), hyp=hyp)
    total, got = v8SegmentationLoss(**kw)(preds, {k: torch.from_numpy(v) for k, v in batch.items()}, (imgsz, imgsz))
    jpreds = {"feats": [jnp.asarray(f.numpy().transpose(0, 2, 3, 1)) for f in preds["feats"]],
              "mc": jnp.asarray(preds["mc"].numpy()), "protos": jnp.asarray(preds["protos"].numpy().transpose(0, 2, 3, 1))}
    want_total, want = jloss.v8SegmentationLoss(**kw)(jpreds, {k: jnp.asarray(v) for k, v in batch.items()},
                                                      (imgsz, imgsz))
    assert set(got) == set(want) == {"box", "seg", "cls", "dfl"} and float(got["seg"]) > 0
    for k in want:
        assert float(got[k]) == pytest.approx(float(want[k]), rel=1e-3), (k, got, want)
    assert float(total) == pytest.approx(float(want_total), rel=1e-3)
