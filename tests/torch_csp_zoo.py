"""Whole-model checks of the RTMDet, YOLOv7, YOLOv4-CSP and YOLOR-CSP YAMLs,
shared by tests/test_torch_csp_zoo_{rtmdet,v7,v7_tasks,v4r}.py, each of
which takes one family (`model_tests(names)`).

Each YAML (the fixed-width ones narrowed to depth 0.33 and width 0.25 as
dicts, rtmdet at scale t) at 64 px: the JAX package's seeded variables
(their layout from `jax.eval_shape` of the flax module's init, no compile;
every ImplicitM's `implicit` drawn around 1, as it starts) load into the
port strictly and carry back to the same flax tree; the port's forward
meets the JAX flax module's `apply` (the task model's module without its
stride probe, at strides 8, 16, 32) on two seeded images: decoded boxes
within 1e-3 px, scores within 1e-5, the other columns (mask coefficients,
keypoints, angles), the prototypes and each level's raw map within 1e-5 of
their largest magnitude.
"""

from functools import partial

import numpy as np
import pytest
import torch

from tests.test_torch_modules import randomize, to_nhwc
from tests.test_torch_train import leaves
from tests.torch_attn_zoo import STRIDES, jax_module
from ultralytics_pro_tpu_torch.nn.tasks import guess_model_task, model_class_for, yaml_model_load
from ultralytics_pro_tpu_torch.utils.weights import jax_to_torch_state_dict, torch_state_dict_to_jax

IMGSZ = 64
NARROW = {"depth_multiple": 0.33, "width_multiple": 0.25}
# the name given to YOLO(...): (its file under cfg/models, its head, its task)
YAMLS = {
    "rtmdet-t.yaml": ("rtmdet/rtmdet.yaml", "Detect", "detect"),
    "rtmdet-t-seg.yaml": ("rtmdet/rtmdet-seg.yaml", "Segment", "segment"),
    "rtmdet-t-pose.yaml": ("rtmdet/rtmdet-pose.yaml", "Pose", "pose"),
    "yolov7.yaml": ("v7/yolov7.yaml", "IDetect", "detect"),
    "yolov7-anchor.yaml": ("v7/yolov7-anchor.yaml", "AnchorDetect", "detect"),
    "yolov7-seg.yaml": ("v7/yolov7-seg.yaml", "ISegment", "segment"),
    "yolov7-pose.yaml": ("v7/yolov7-pose.yaml", "IPose", "pose"),
    "yolov7-obb.yaml": ("v7/yolov7-obb.yaml", "IOBB", "obb"),
    "yolov4-csp.yaml": ("v4/yolov4-csp.yaml", "Detect", "detect"),
    "yolov4-csp-seg.yaml": ("v4/yolov4-csp-seg.yaml", "Segment", "segment"),
    "yolor-csp.yaml": ("R/yolor-csp.yaml", "IDetect", "detect"),
}
TOL = 1e-5


def narrowed(d: dict) -> dict:
    """A fixed-width YAML (no `scales`) at depth 0.33 and width 0.25."""
    return d if d.get("scales") else {**d, **NARROW}


def implicit_around_one(variables: dict) -> dict:
    """The tree with every ImplicitM's `implicit` (`im*` modules) moved by +1,
    around the value it starts at (randomize draws it around 0)."""
    def walk(tree, name=""):
        return {k: walk(v, k) if hasattr(v, "items") else
                v + 1.0 if k == "implicit" and name.startswith("im") else v for k, v in tree.items()}

    return walk(variables)


def jax_variables(module, seed: int) -> dict:
    """Seeded variables of a flax module, their layout from `jax.eval_shape`
    of its init at IMGSZ."""
    import jax

    shapes = jax.eval_shape(partial(module.init, train=True), jax.random.PRNGKey(0),
                            jax.ShapeDtypeStruct((1, IMGSZ, IMGSZ, 3), np.float32))
    return implicit_around_one(randomize(jax.tree_util.tree_map(lambda a: np.zeros(a.shape, np.float32), shapes),
                                         seed))


def jax_and_port(name: str, seed: int, d: dict | None = None):
    """(JAX flax module, its seeded variables, the port's task model with
    them loaded strictly) of YAML name, narrowed (or the dict d, given to
    both packages)."""
    from ultralytics_pro_tpu.nn.tasks import yaml_model_load as jyaml
    from ultralytics_pro_tpu_torch.nn import tasks

    jd = d if d is not None else narrowed(jyaml(name))
    jm = jax_module(jd)
    variables = jax_variables(jm, seed)
    pd = d if d is not None else narrowed(yaml_model_load(name))
    with pytest.MonkeyPatch.context() as mp:  # the load replaces every value
        mp.setattr(tasks, "init_weights", lambda model, generator: None)
        port = model_class_for(guess_model_task(pd))(pd)
    port.load_state_dict(jax_to_torch_state_dict(variables))  # strict
    return jm, variables, port


def assert_round_trip(port, variables):
    back = dict(leaves(torch_state_dict_to_jax(port.state_dict())))
    assert back.keys() == dict(leaves(variables)).keys()  # every name both ways
    for k, w in leaves(variables):
        np.testing.assert_array_equal(back[k], w, err_msg="/".join(k))


def close(got, want, tol: float = TOL):
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=tol * np.abs(want).max(), rtol=0)


def model_tests(names):
    """The whole-model test of each YAML of `names`."""

    @pytest.mark.parametrize("name", names)
    def test_model_forward_matches_jax(name):
        import jax

        _, head, task = YAMLS[name]
        jm, variables, port = jax_and_port(name, seed=8)
        assert type(port.model[-1]).__name__ == head and port.task == guess_model_task(port.yaml) == task
        assert_round_trip(port, variables)
        assert port.stride.tolist() == list(STRIDES)
        x = np.random.default_rng(9).uniform(0, 1, (2, 3, IMGSZ, IMGSZ)).astype(np.float32)
        want, aux = jax.jit(lambda v, xx: jm.apply(v, xx, train=False))(variables, x.transpose(0, 2, 3, 1))
        want = np.asarray(want)
        with torch.no_grad():
            got, got_aux = port(torch.from_numpy(x))
        got, nc = got.numpy(), port.nc
        assert got.shape == want.shape
        np.testing.assert_allclose(got[..., :4], want[..., :4], atol=1e-3, rtol=0)
        np.testing.assert_allclose(got[..., 4:4 + nc], want[..., 4:4 + nc], atol=TOL, rtol=0)
        if got.shape[-1] > 4 + nc:
            close(got[..., 4 + nc:], want[..., 4 + nc:])
        feats = got_aux["feats"] if isinstance(got_aux, dict) else got_aux
        for g, w in zip(feats, aux["feats"], strict=True):
            close(to_nhwc(g), w)
        if isinstance(got_aux, dict) and "protos" in got_aux:
            close(to_nhwc(got_aux["protos"]), aux["protos"])

    return test_model_forward_matches_jax


# -- one trainer step against the JAX trainer -------------------------------------------------

def train_tests(cfg: str, criterion, parts, jax_params_tol: float = 1e-4):
    """The trainer test of narrowed YAML cfg, as tests/test_torch_zoo2_train.py
    holds yolov5-anchor's: both facades from the port's seed-3 weights at nc
    3, one epoch of the detect fixture set (16 images, train = val) at 160
    px, batch 8, nbs 16: two micro-batches, one optimizer step, no warmup;
    the port's loader on cv2's INTER_AREA, the JAX BN's two-pass variance on
    one device, the JAX v5AnchorLoss seeing the padded GT slots as 0.5 boxes
    (its gradient is NaN at 0 x 0 ones). Loss parts within 1e-3 relative;
    parameters and EMA within `jax_params_tol` of the tree's largest
    magnitude, BN statistics within 1e-4; momentum buffers within
    JAX_STEP_TOL; every implicit leaf moved in both steps.

    Where `jax_params_tol` is above 1e-4, the JAX package's float32 step is
    the imprecise one: the port's float32 run is also held to its own
    float64 run (the model and the images in float64) within 1e-4 on the
    parameters and EMA, and the JAX run must be further from it than the
    port's. The known cause is the JAX f32 train-mode forward on the flat
    fixture images (tests/test_torch_zoo_train.py's trap)."""
    from tests.test_torch_rtdetr_train import JAX_STEP_TOL, rel_l2
    from tests.test_torch_train import same_images_as_jax, task_data_yaml
    from tests.test_torch_zoo2_train import KW, jax_model, port_model
    from tests.test_torch_zoo_train import tree_max_rel
    from ultralytics_pro_tpu_torch.engine.trainer import load_pickle

    @pytest.fixture(scope="module")
    def trained(tmp_path_factory):
        import jax.numpy as jnp

        from ultralytics_pro_tpu.nn.modules import conv as jconv
        from ultralytics_pro_tpu.utils import loss as jloss

        root = tmp_path_factory.mktemp("csp_train")
        data = task_data_yaml(root / "set")
        port = port_model(cfg)
        jax_yolo = jax_model(port, cfg)
        start = torch_state_dict_to_jax(port.model.state_dict())
        with same_images_as_jax():
            port.train(data=str(data), project=str(root / "port"), **KW)
        saved, call = jconv.BN_FAST_VARIANCE[0], jloss.v5AnchorLoss.__call__

        def unit_padded(self, preds, batch, imgsz):
            pad = batch["mask_gt"][..., None] > 0
            return call(self, preds, {**batch, "bboxes": jnp.where(pad, batch["bboxes"], 0.5)}, imgsz)

        jconv.BN_FAST_VARIANCE[0] = False
        try:
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(jloss.v5AnchorLoss, "__call__", unit_padded)
                jax_yolo.train(data=str(data), project=str(root / "jax"), device=1, **KW)
        finally:
            jconv.BN_FAST_VARIANCE[0] = saved
        port64 = None
        if jax_params_tol > 1e-4:
            from ultralytics_pro_tpu_torch.engine.trainer import BaseTrainer

            port64 = port_model(cfg)
            port64.model.double()
            put = BaseTrainer.put_batch
            with same_images_as_jax(), pytest.MonkeyPatch.context() as mp:
                mp.setattr(BaseTrainer, "put_batch", lambda self, b: {**(o := put(self, b)), "img": o["img"].double()})
                port64.train(data=str(data), project=str(root / "port64"), **KW)
        return port, jax_yolo, start, port64

    def test_trainer_step_matches_jax(trained):
        port, jax_yolo, start, port64 = trained
        tp, tj = port.trainer, jax_yolo.trainer
        assert type(tp.criterion) is criterion
        assert (tp.accumulate, tp.opt_steps) == (tj.accumulate, tj.opt_steps) == (2, 1)
        (got,), (want,) = tp.loss_history, tj.loss_history
        assert list(got) == parts and set(want) == set(got)
        assert all(np.isfinite(v) and v > 0 for v in got.values())
        for k in want:
            assert got[k] == pytest.approx(want[k], rel=1e-3), (k, got, want)
        cp, cj = load_pickle(tp.wdir / "last.ckpt"), load_pickle(tj.wdir / "last.ckpt")
        assert cp["ema_updates"] == cj["ema_updates"] == 1
        for key in ("params", "ema", "batch_stats"):
            assert tree_max_rel(cp[key], cj[key]) <= (1e-4 if key == "batch_stats" else jax_params_tol), key
        if port64 is not None:
            c64 = load_pickle(port64.trainer.wdir / "last.ckpt")
            for key in ("params", "ema"):
                assert tree_max_rel(cp[key], c64[key]) <= 1e-4, key
                assert tree_max_rel(cj[key], c64[key]) > tree_max_rel(cp[key], c64[key]), key
        tree, (leaf, where) = rel_l2(cp["momentum_buffer"], cj["momentum_buffer"])
        assert tree <= JAX_STEP_TOL["tree"] and leaf <= JAX_STEP_TOL["leaf"], (tree, leaf, where)
        before = {k: w for k, w in leaves(start["params"]) if k[-1] == "implicit"}
        assert before
        for ckpt in (cp, cj):
            after = dict(leaves(ckpt["params"]))
            assert all(np.abs(after[k] - w).max() > 0 for k, w in before.items())

    return trained, test_trainer_step_matches_jax
