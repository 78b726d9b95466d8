"""Shared code of the CPU tests of YOLO11's whole-backbone zoo, Bi_FPN and
the slim neck (tests/test_torch_yolo11_bb_*.py): the fourteen
cfg/models/11/yolo11-<name>.yaml besides yolo11.yaml.

Seeding. The JAX variables come from `tests/torch_att_maf_hyper.py:
jax_variables` (seeded numpy over the layout of `jax.eval_shape` of the
init), so the layer scales (`gamma`, `layer_scale_*`), Swin's `rel_bias`,
EfficientFormerV2's `attention_biases` and talking heads are N(0, 0.2);
Bi_FPN's 1-D `weight` is redrawn in [0.5, 1.5] (`fusion_weights`), as its
normalisation by the sum of silu(w) would divide by nearly zero at N(0, 0.2).

`module_tests`: each block and backbone of the slice (narrow widths where
the class takes them) against its JAX flax module on seeded input, in
eval mode and in train mode (the JAX YOLO Conv's BatchNorm with its two-pass
variance): the outputs, and in train mode the updated BatchNorm statistics,
within MODULE_TOL of their largest magnitude.

`model_tests`: each YAML at a scale and image size: the JAX package's
variables load into the port strictly and carry back to the same flax
tree; the port's forward meets the JAX flax module's `apply` (the task
model's module without its stride probe, at strides 8, 16, 32) on two
seeded images: decoded boxes and each level's raw map within MODEL_TOL of
their largest magnitude, scores within MODEL_TOL.

`train_tests` is tests/torch_att_maf_hyper.py's (one trainer step against
the JAX trainer), with the moved-parameter check on a block of the backbone.
"""

from functools import partial

import numpy as np
import pytest
import torch

from tests.test_torch_modules import to_nhwc
from tests.test_torch_train import leaves
from tests.torch_att_maf_hyper import assert_round_trip, close
from tests.torch_att_maf_hyper import jax_variables as seeded_variables
from tests.torch_attn_zoo import JAX_MODELS, STRIDES, jax_module
from ultralytics_pro_tpu_torch.nn.tasks import DetectionModel, yaml_model_load
from ultralytics_pro_tpu_torch.utils import PKG_ROOT
from ultralytics_pro_tpu_torch.utils.weights import jax_to_torch_state_dict

NAMES = ("bifpn", "convnext", "efficientformerv2", "efficientnetv2", "efficientvit", "fasternet", "ghostnetv2",
         "lsknet", "mobilenetv4", "pvtv2", "repvit", "slimneck", "starnet", "swin")
IMGSZ = 64
MODULE_TOL = 1e-5
MODEL_TOL = 1e-4


def fusion_weights(variables: dict) -> dict:
    """The tree with every 1-D bare `weight` (Bi_FPN's) drawn in [0.5, 1.5]."""
    def walk(tree):
        return {k: walk(v) if hasattr(v, "items") else
                np.random.default_rng(7 + np.size(v)).uniform(0.5, 1.5, np.shape(v)).astype(np.float32)
                if k == "weight" and np.ndim(v) == 1 else v for k, v in tree.items()}

    return {c: walk(t) for c, t in variables.items()}


def jax_variables(module, seed: int, x_shape, **init_kw) -> dict:
    return fusion_weights(seeded_variables(module, seed, x_shape, **init_kw))


# -- the YAMLs and the parse ------------------------------------------------------------------

def yaml_and_parse_tests(names):
    """The copies byte for byte, and each YAML's parse (of `names`) against the JAX
    package's: (i, f, type) of every layer, the save list, and the width of
    every feature slot against the JAX model's layer outputs
    (`capture_intermediates` under `jax.eval_shape`: nothing runs)."""

    @pytest.mark.parametrize("name", names)
    def test_yaml_copy_is_the_jax_package_file(name):
        rel = f"11/yolo11-{name}.yaml"
        assert (PKG_ROOT / "cfg" / "models" / rel).read_bytes() == (JAX_MODELS / rel).read_bytes()

    @pytest.mark.parametrize("name", names)
    def test_parse_matches_the_jax_specs(name):
        import jax

        from ultralytics_pro_tpu.nn.tasks import parse_model as jparse
        from ultralytics_pro_tpu.nn.tasks import yaml_model_load as jyaml
        from ultralytics_pro_tpu_torch.nn.tasks import parse_model

        cfg = f"yolo11n-{name}.yaml"
        layers, save, meta = parse_model(yaml_model_load(cfg))
        jd = jyaml(cfg)
        specs, jsave, _ = jparse(jd, ch=3, nc=jd.get("nc"), scale=jd.get("scale"))

        def table(rows):
            return [(i, tuple(f) if isinstance(f, (list, tuple)) else f, t) for i, f, t in rows]

        assert table((m.i, m.f, m.type) for m in layers) == table((s.i, s.f, s.type_name) for s in specs)
        assert save == jsave
        assert [m.multi for m in layers] == [s.multi for s in specs]
        jm = jax_module(jd)
        x = jax.ShapeDtypeStruct((1, IMGSZ, IMGSZ, 3), np.float32)
        shapes = jax.eval_shape(partial(jm.init, train=False), jax.random.PRNGKey(0), x)
        _, state = jax.eval_shape(lambda v, xx: jm.apply(v, xx, train=False, capture_intermediates=True,
                                                         mutable=["intermediates"]), shapes, x)
        want = {}
        for k, spec in enumerate(specs[:-1]):
            out = state["intermediates"][f"layers_{k}"]["__call__"][0]
            for j, o in enumerate(out if spec.multi else [out]):
                want[spec.i - len(out) + 1 + j if spec.multi else spec.i] = o.shape[-1]
        chs = meta["channels"]
        assert {slot: chs[slot] for slot in want} == want
        assert [slot for slot, c in enumerate(chs[:-1]) if c is None] == sorted(set(range(len(chs) - 1)) - set(want))

    return test_yaml_copy_is_the_jax_package_file, test_parse_matches_the_jax_specs


# -- blocks and backbones ---------------------------------------------------------------------

def run_jax(module, variables, x, train: bool):
    """(output, updated batch_stats or None) of a flax module's jitted apply."""
    import jax

    if train:
        out, upd = jax.jit(lambda v, xx: module.apply(v, xx, train=True, mutable=["batch_stats"]))(variables, x)
        return out, upd.get("batch_stats")
    return jax.jit(lambda v, xx: module.apply(v, xx, train=False))(variables, x), None


def as_list(out):
    return list(out) if isinstance(out, (list, tuple)) else [out]


def module_tests(cases: dict):
    """The eval- and train-mode test of each case: id -> (JAX module factory,
    port module factory, input shape (B, C, H, W), layout). The layout is
    "nchw" (the port takes NCHW), "nhwc" (the port takes the JAX NHWC
    array: Swin's and PVTv2's blocks) or an int n (a list of n maps,
    Bi_FPN)."""

    @pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
    @pytest.mark.parametrize("case", list(cases))
    def test_module_matches_jax(case, train, monkeypatch):
        from ultralytics_pro_tpu.nn.modules import conv as jconv
        from ultralytics_pro_tpu_torch.utils.weights import torch_state_dict_to_jax

        monkeypatch.setattr(jconv, "BN_FAST_VARIANCE", [False])
        jax_factory, port_factory, shape, layout = cases[case]
        jm, port = jax_factory(), port_factory()
        n = layout if isinstance(layout, int) else 0
        rng = np.random.default_rng(11)
        xs = [rng.normal(0, 1, shape).astype(np.float32) for _ in range(max(n, 1))]
        x_nhwc = [x.transpose(0, 2, 3, 1) for x in xs]
        jx = x_nhwc if n else x_nhwc[0]
        variables = fusion_weights(_list_variables(jm, jx)) if n else jax_variables(jm, 5, jx.shape, train=False)
        port.load_state_dict(jax_to_torch_state_dict(variables))  # strict
        port.train(train)
        want, stats = run_jax(jm, variables, jx, train)
        if layout == "nhwc":
            tx = torch.from_numpy(x_nhwc[0])
        elif n:
            tx = [torch.from_numpy(x) for x in xs]
        else:
            tx = torch.from_numpy(xs[0])
        with torch.set_grad_enabled(False):
            got = port(tx)
        got, want = as_list(got), as_list(want)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            close(g.numpy() if layout == "nhwc" else to_nhwc(g), np.asarray(w), MODULE_TOL)
        if train and stats:
            back = dict(leaves(torch_state_dict_to_jax(port.state_dict())["batch_stats"]))
            for k, w in leaves(stats):
                close(back[k], np.asarray(w), MODULE_TOL)

    return test_module_matches_jax


def _list_variables(module, xs):
    import jax

    from tests.test_torch_modules import randomize

    shapes = jax.eval_shape(partial(module.init, train=False), jax.random.PRNGKey(0),
                            [jax.ShapeDtypeStruct(x.shape, np.float32) for x in xs])
    return randomize(jax.tree_util.tree_map(lambda a: np.zeros(a.shape, np.float32), shapes), 5)


def bound(module, h: int, w: int):
    """module (Attention4D, Attention4DDownsample) bound to an h x w input map."""
    module.bind(h, w)
    return module


def bound_at(module, shape):
    """module with each size-bound layer bound to the map it sees on an input of shape (B, C, H, W)."""
    hooks = [m.register_forward_pre_hook(lambda m, a: m.bind(*a[0].shape[-2:])) for m in module.modules()
             if getattr(m, "size_params", ())]
    with torch.no_grad():
        module.eval()(torch.zeros(shape))
    for h in hooks:
        h.remove()
    return module


# -- whole models -----------------------------------------------------------------------------

def jax_and_port(cfg: str, seed: int, imgsz: int = IMGSZ):
    """(JAX flax module, its seeded variables, the port's model at imgsz
    with them loaded strictly) of YAML cfg."""
    from ultralytics_pro_tpu.nn.tasks import yaml_model_load as jyaml
    from ultralytics_pro_tpu_torch.nn import tasks

    jm = jax_module(jyaml(cfg))
    variables = jax_variables(jm, seed, (1, imgsz, imgsz, 3), train=True)
    with pytest.MonkeyPatch.context() as mp:  # the load replaces every value
        mp.setattr(tasks, "init_weights", lambda model, generator: None)
        port = DetectionModel(cfg, imgsz=imgsz)
    port.load_state_dict(jax_to_torch_state_dict(variables))  # strict
    return jm, variables, port


def model_tests(cfgs, imgsz: int = IMGSZ):
    """The whole-model test of each YAML name of `cfgs` at imgsz."""

    @pytest.mark.parametrize("cfg", cfgs)
    def test_model_forward_matches_jax(cfg):
        import jax

        jm, variables, port = jax_and_port(cfg, seed=8, imgsz=imgsz)
        assert_round_trip(port, variables)
        assert port.stride.tolist() == list(STRIDES)
        x = np.random.default_rng(9).uniform(0, 1, (2, 3, imgsz, imgsz)).astype(np.float32)
        want, aux = jax.jit(lambda v, xx: jm.apply(v, xx, train=False))(variables, x.transpose(0, 2, 3, 1))
        want = np.asarray(want)
        with torch.no_grad():
            got, feats = port(torch.from_numpy(x))
        got = got.numpy()
        close(got[..., :4], want[..., :4], MODEL_TOL)
        np.testing.assert_allclose(got[..., 4:], want[..., 4:], atol=MODEL_TOL, rtol=0)
        for g, w in zip(feats, aux["feats"], strict=True):
            close(to_nhwc(g), w, MODEL_TOL)

    return test_model_forward_matches_jax


# -- one trainer step -------------------------------------------------------------------------

TRAIN_NC = 3
ZERO_FLOOR = 1e-12  # a momentum leaf below this share of the largest in the float64 step: its gradient is 0
ROUNDING = 1e-5  # such a leaf in a float32 step: below this share of the largest (3.5e-6 seen, the first conv's bias)


def train_tests(cfg: str, imgsz: int, layer, jax_tol: float = 1e-4):
    """One trainer step of YAML cfg at imgsz in the port, in the port at
    float64 (the model and the images) and in the JAX trainer, as
    tests/torch_att_maf_hyper.py's `train_tests` runs it: all from the
    port's seed-3 weights at nc 3 (the layer scales at their 1e-5 and
    1e-6: each leaf's momentum is compared relative to its own norm), one epoch of the detect fixture set (16
    images, train = val, batch 8, nbs 16: one optimizer step, no warmup),
    the port's loader on cv2's INTER_AREA, the JAX BN's two-pass variance.

    Loss parts within 1e-3 relative of the JAX step's; parameters, EMA and
    BN statistics within 1e-4 of the tree's largest magnitude of the port's
    float64 step, and within `jax_tol` of the JAX step's (above 1e-4 only
    where the JAX step is the further from the float64 one). Momentum
    buffers: a leaf whose float64 buffer is below
    ZERO_FLOOR of the largest leaf's has a gradient of 0 (a conv's or a
    norm's bias before a train-mode BatchNorm, which takes the batch mean
    out), and its float32 buffers hold rounding alone: both below ROUNDING
    of the largest leaf's. Over the others, the port's buffers are within
    F64_STEP_TOL (tree, worst leaf; tests/test_torch_rtdetr_train.py) of its
    float64 step's and within JAX_STEP_TOL of the JAX step's. Every
    parameter under the flax path `layer` has a non-zero momentum buffer
    (its gradient, plus its decay) in all three steps and moved in the
    float64 one: a float32 step leaves a parameter near 1 in place where
    its update is below half an ulp, as BatchNorm scales behind
    EfficientFormerV2's 1e-5 layer scales are."""
    import copy

    from tests.test_torch_rtdetr_train import F64_STEP_TOL, JAX_STEP_TOL, rel_l2
    from tests.test_torch_train import same_images_as_jax, task_data_yaml
    from tests.test_torch_zoo_train import tree_max_rel
    from tests.torch_att_maf_hyper import DETECT_PARTS, subtree
    from ultralytics_pro_tpu_torch import YOLO
    from ultralytics_pro_tpu_torch.engine.trainer import BaseTrainer, load_pickle
    from ultralytics_pro_tpu_torch.utils.weights import torch_state_dict_to_jax

    kw = dict(epochs=1, imgsz=imgsz, batch=8, nbs=16, warmup_epochs=0.0, val=False, workers=2, max_gt=32)

    @pytest.fixture(scope="module")
    def trained(tmp_path_factory):
        from ultralytics_pro_tpu import YOLO as JYOLO
        from ultralytics_pro_tpu.nn.modules import conv as jconv
        from ultralytics_pro_tpu.nn.tasks import yaml_model_load as jyaml

        root = tmp_path_factory.mktemp("bb_train")
        data = task_data_yaml(root / "set")
        port = YOLO({**yaml_model_load(cfg), "nc": TRAIN_NC}, device="cpu", seed=3)
        port._bind_size(imgsz)  # the size-bound layers at the step's maps, as the JAX facade initialises them
        port64 = copy.deepcopy(port)
        port64.model.double()
        jax_yolo = JYOLO({**jyaml(cfg), "nc": TRAIN_NC})
        jax_yolo.model.variables = start = torch_state_dict_to_jax(port.model.state_dict())
        put = BaseTrainer.put_batch
        with same_images_as_jax():
            port.train(data=str(data), project=str(root / "port"), **kw)
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(BaseTrainer, "put_batch", lambda self, b: {**(o := put(self, b)), "img": o["img"].double()})
                port64.train(data=str(data), project=str(root / "port64"), **kw)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jconv, "BN_FAST_VARIANCE", [False])
            jax_yolo.train(data=str(data), project=str(root / "jax"), device=1, **kw)
        return port, port64, jax_yolo, start

    def test_trainer_step_matches_jax(trained):
        port, port64, jax_yolo, start = trained
        tp, tj = port.trainer, jax_yolo.trainer
        assert (tp.accumulate, tp.opt_steps) == (tj.accumulate, tj.opt_steps) == (2, 1)
        (got,), (want,) = tp.loss_history, tj.loss_history
        assert list(got) == DETECT_PARTS and set(want) == set(got)
        for k in want:
            assert got[k] == pytest.approx(want[k], rel=1e-3), (k, got, want)
        cp, cj, c64 = (load_pickle(t.wdir / "last.ckpt") for t in (tp, tj, port64.trainer))
        for key in ("params", "ema", "batch_stats"):
            assert tree_max_rel(cp[key], c64[key]) <= 1e-4, key
            assert tree_max_rel(cp[key], cj[key]) <= jax_tol, key
            if jax_tol > 1e-4:
                assert tree_max_rel(cj[key], c64[key]) > tree_max_rel(cp[key], c64[key]), key
        m32, mj, m64 = (dict(leaves(c["momentum_buffer"])) for c in (cp, cj, c64))
        norm = {k: float(np.linalg.norm(w)) for k, w in m64.items()}
        zero = {k for k, n in norm.items() if n < ZERO_FLOOR * max(norm.values())}
        for m in (m32, mj):
            top = max(float(np.linalg.norm(w)) for w in m.values())
            assert all(np.linalg.norm(m[k]) < ROUNDING * top for k in zero)
        live = {k: m64[k] for k in m64 if k not in zero}
        tree, (leaf, where) = rel_l2({k: m32[k] for k in live}, live)
        assert tree <= F64_STEP_TOL["tree"] and leaf <= F64_STEP_TOL["leaf"], (tree, leaf, where)
        tree, (leaf, where) = rel_l2({k: m32[k] for k in live}, {k: mj[k] for k in live})
        assert tree <= JAX_STEP_TOL["tree"] and leaf <= JAX_STEP_TOL["leaf"], (tree, leaf, where)
        before = dict(leaves(subtree(start["params"], layer)))
        assert before
        after = dict(leaves(subtree(c64["params"], layer)))
        assert after.keys() == before.keys()
        assert all(np.abs(after[k] - w).max() > 0 for k, w in before.items()), \
            [k for k, w in before.items() if not np.abs(after[k] - w).max() > 0]
        for ckpt in (cp, cj, c64):
            grads = dict(leaves(subtree(ckpt["momentum_buffer"], layer)))
            assert grads.keys() == before.keys() and all(np.abs(g).max() > 0 for g in grads.values())

    return trained, test_trainer_step_matches_jax
