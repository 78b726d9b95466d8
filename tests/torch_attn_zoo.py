"""Whole-model checks of the 40 attention YAMLs (v5 and v8, one per
attention module each), shared by tests/test_torch_attn_zoo_{1,...,5}.py,
each of which takes a fifth of the 20 modules (`model_tests(part)`).

1. Each YAML's copy in the port equals the JAX package's file byte for byte.
2. One YAML per module, v8 and v5 in turn by the module's place in
   `MODULES` (the other is its partner), at scale n and 64 px: the JAX
   package's seeded variables (their layout from `jax.eval_shape` of the
   init at 64 px, where MHSA's `rel_h` and `rel_w` are 2 x 2; every
   zero-initialised parameter non-zero) load into the port strictly, carry
   back to the same flax tree, and the port's forward meets the JAX flax
   module's `apply` (`jax_module`: the task model's module without its
   stride probe) on two seeded images: decoded boxes within 1e-4 of their
   largest magnitude (px), scores within 1e-4, each level's raw map within
   1e-4 of its largest magnitude.
3. Every YAML at scales n and s (the partner's at n too) builds in the port
   at 64 px and loads the JAX package's seeded variables strictly; at n
   they carry back to the same flax tree.
"""

from functools import partial
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.test_torch_modules import randomize, to_nhwc
from tests.test_torch_train import leaves
from ultralytics_pro_tpu_torch.nn.tasks import DetectionModel, yaml_model_load
from ultralytics_pro_tpu_torch.utils import PKG_ROOT
from ultralytics_pro_tpu_torch.utils.weights import jax_to_torch_state_dict, torch_state_dict_to_jax

MODULES = ("BiLevelRoutingAttention", "CBAM", "CPCA", "CoordAtt", "CrissCrossAttention", "DAttention",
           "ECAAttention", "EMA", "EffectiveSE", "FocusedLinearAttention", "GAMAttention", "LSKA", "LSKblock",
           "MHSA", "SEAttention", "SKAttention", "SegNext_Attention", "ShuffleAttention", "SimAM",
           "TripletAttention")
PARTS = 5
IMGSZ = 64
STRIDES = (8, 16, 32)
TOL = 1e-4
JAX_MODELS = Path(__file__).resolve().parents[1] / "ultralytics_pro_tpu" / "cfg" / "models"


def yaml_name(module: str, family: str, scale: str = "n") -> str:
    return f"yolov{family}{scale}-{module}.yaml"


def forward_family(module: str) -> str:
    """v8 for the even places of MODULES, v5 for the odd."""
    return "8" if MODULES.index(module) % 2 == 0 else "5"


def jax_module(jd: dict):
    """The JAX package's flax module of YAML dict jd, its Detect head at
    strides 8, 16, 32 (what the JAX model's stride probe finds for these
    YAMLs), without building a DetectionModel (the probe traces the model
    twice)."""
    from ultralytics_pro_tpu.nn.tasks import HEAD_TYPES, LayerSpec, YOLOModule, parse_model

    specs, save, meta = parse_model(jd, ch=3, nc=jd.get("nc"), scale=jd.get("scale"))
    specs = [LayerSpec(i=s.i, f=s.f, cls=s.cls, kwargs=tuple({**dict(s.kwargs), "strides": STRIDES}.items()),
                       type_name=s.type_name, n=s.n, multi=s.multi) if s.type_name in HEAD_TYPES else s
             for s in specs]
    return YOLOModule(specs=tuple(specs), save=tuple(save), act_name=meta.get("activation"))


def jax_variables(module, seed: int):
    """Seeded variables of a JAX model's flax module, their layout from
    `jax.eval_shape` of its init at IMGSZ."""
    import jax

    shapes = jax.eval_shape(partial(module.init, train=True), jax.random.PRNGKey(0),
                            jax.ShapeDtypeStruct((1, IMGSZ, IMGSZ, 3), np.float32))
    return randomize(jax.tree_util.tree_map(lambda a: np.zeros(a.shape, np.float32), shapes), seed)


def port_loaded(name: str, variables) -> DetectionModel:
    """The port's model of YAML name at IMGSZ with variables loaded strictly
    (its own seeded initialisation skipped: the load replaces every value)."""
    from ultralytics_pro_tpu_torch.nn import tasks

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tasks, "init_weights", lambda model, generator: None)
        port = DetectionModel(name, imgsz=IMGSZ)
    port.load_state_dict(jax_to_torch_state_dict(variables))  # strict
    return port


def assert_round_trip(port, variables):
    back = dict(leaves(torch_state_dict_to_jax(port.state_dict())))
    assert back.keys() == dict(leaves(variables)).keys()  # every name both ways
    for k, w in leaves(variables):
        np.testing.assert_array_equal(back[k], w, err_msg="/".join(k))


def close(got, want):
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=TOL * np.abs(want).max(), rtol=0)


def model_tests(part: int):
    """The three tests of module fifth `part` (0-4) of MODULES."""
    mods = MODULES[part * len(MODULES) // PARTS:(part + 1) * len(MODULES) // PARTS]
    files = [(m, f) for m in mods for f in ("5", "8")]

    @pytest.mark.parametrize("module,family", files)
    def test_yaml_copy_is_the_jax_package_file(module, family):
        rel = f"v{family}/yolov{family}-{module}.yaml"
        assert (PKG_ROOT / "cfg" / "models" / rel).read_bytes() == (JAX_MODELS / rel).read_bytes()

    @pytest.mark.parametrize("module", mods)
    def test_model_forward_matches_jax(module):
        import jax

        from ultralytics_pro_tpu.nn.tasks import yaml_model_load as jyaml

        name = yaml_name(module, forward_family(module))
        jm = jax_module(jyaml(name))
        variables = jax_variables(jm, seed=8)
        port = port_loaded(name, variables)
        assert_round_trip(port, variables)
        assert type(port.model[10]).__name__ == module
        assert port.stride.tolist() == list(STRIDES)
        x = np.random.default_rng(9).uniform(0, 1, (2, 3, IMGSZ, IMGSZ)).astype(np.float32)
        want, aux = jax.jit(lambda v, xx: jm.apply(v, xx, train=False))(variables, x.transpose(0, 2, 3, 1))
        want = np.asarray(want)
        with torch.no_grad():
            got, feats = port(torch.from_numpy(x))
        got = got.numpy()
        close(got[..., :4], want[..., :4])
        np.testing.assert_allclose(got[..., 4:], want[..., 4:], atol=TOL, rtol=0)
        for g, w in zip(feats, aux["feats"]):
            close(to_nhwc(g), w)

    @pytest.mark.parametrize("module,family,scale", [(m, f, s) for m, f in files for s in ("n", "s")
                                                     if (f, s) != (forward_family(m), "n")])
    def test_model_loads_the_jax_variables(module, family, scale):
        from ultralytics_pro_tpu.nn.tasks import yaml_model_load as jyaml

        name = yaml_name(module, family, scale)
        variables = jax_variables(jax_module(jyaml(name)), seed=10)
        port = port_loaded(name, variables)
        assert port.yaml["scale"] == scale == yaml_model_load(name)["scale"]
        if scale == "n":
            assert_round_trip(port, variables)

    return test_yaml_copy_is_the_jax_package_file, test_model_forward_matches_jax, test_model_loads_the_jax_variables


# -- one trainer step against the JAX trainer -------------------------------------------------

TRAIN_NC = 3


def train_tests(cfg: str, imgsz: int):
    """The trainer test of YAML cfg at imgsz, as tests/test_torch_v13.py
    holds yolov13n's: both facades from the port's seed-3 weights at nc 3
    (their zero-initialised parameters seeded, `chip_smoke.seed_gates`),
    one epoch of the detect fixture set (16 images, train = val, batch 8,
    nbs 16: one optimizer step, no warmup), the port's loader on cv2's
    INTER_AREA and the JAX BN's two-pass variance on one device. Loss parts
    within 1e-3 relative; parameters, EMA and BN statistics within 1e-4 of
    the tree's largest magnitude; momentum buffers within JAX_STEP_TOL (the
    zoo trainer tests' bounds, tests/test_torch_zoo_train.py); the attention
    layer's parameters moved in both steps."""
    from tests.test_torch_rtdetr_train import JAX_STEP_TOL, rel_l2
    from tests.test_torch_train import same_images_as_jax, task_data_yaml
    from tests.test_torch_zoo_train import tree_max_rel
    from ultralytics_pro_tpu_torch import YOLO
    from ultralytics_pro_tpu_torch.engine.trainer import load_pickle

    kw = dict(epochs=1, imgsz=imgsz, batch=8, nbs=16, warmup_epochs=0.0, val=False, workers=2, max_gt=32)

    @pytest.fixture(scope="module")
    def trained(tmp_path_factory):
        from chip_smoke import seed_gates
        from ultralytics_pro_tpu import YOLO as JYOLO
        from ultralytics_pro_tpu.nn.modules import conv as jconv
        from ultralytics_pro_tpu.nn.tasks import yaml_model_load as jyaml

        root = tmp_path_factory.mktemp("attn_train")
        data = task_data_yaml(root / "set")
        port = YOLO({**yaml_model_load(cfg), "nc": TRAIN_NC}, device="cpu", seed=3)
        seed_gates(port.model, 4)
        jax_yolo = JYOLO({**jyaml(cfg), "nc": TRAIN_NC})
        jax_yolo.model.variables = start = torch_state_dict_to_jax(port.model.state_dict())
        with same_images_as_jax():
            port.train(data=str(data), project=str(root / "port"), **kw)
        saved = jconv.BN_FAST_VARIANCE[0]
        jconv.BN_FAST_VARIANCE[0] = False
        try:
            jax_yolo.train(data=str(data), project=str(root / "jax"), device=1, **kw)
        finally:
            jconv.BN_FAST_VARIANCE[0] = saved
        return port, jax_yolo, start

    def test_trainer_step_matches_jax(trained):
        port, jax_yolo, start = trained
        tp, tj = port.trainer, jax_yolo.trainer
        assert (tp.accumulate, tp.opt_steps) == (tj.accumulate, tj.opt_steps) == (2, 1)
        (got,), (want,) = tp.loss_history, tj.loss_history
        assert list(got) == ["box", "cls", "dfl"] and set(want) == set(got)
        for k in want:
            assert got[k] == pytest.approx(want[k], rel=1e-3), (k, got, want)
        cp, cj = load_pickle(tp.wdir / "last.ckpt"), load_pickle(tj.wdir / "last.ckpt")
        for key in ("params", "ema", "batch_stats"):
            assert tree_max_rel(cp[key], cj[key]) <= 1e-4, key
        tree, (leaf, where) = rel_l2(cp["momentum_buffer"], cj["momentum_buffer"])
        assert tree <= JAX_STEP_TOL["tree"] and leaf <= JAX_STEP_TOL["leaf"], (tree, leaf, where)
        before = dict(leaves(start["params"]["layers_10"]))
        for ckpt in (cp, cj):
            after = dict(leaves(ckpt["params"]["layers_10"]))
            assert after.keys() == before.keys()
            assert all(np.abs(after[k] - w).max() > 0 for k, w in before.items()), \
                [k for k, w in before.items() if not np.abs(after[k] - w).max() > 0]

    return trained, test_trainer_step_matches_jax
