"""YOLOv13 (HyperACE, FullPAD) in the port against the JAX package, on the CPU.

1. The YAML: the port's copy parses to what `yaml.safe_load` gives for the
   JAX package's file.
2. Blocks: DSConv, DSBottleneck, DSC3k, DSC3k2 (DSBottleneck and DSC3k
   inside), AdaHGComputation under each context, C3AH at a width that
   rounds down to a multiple of 16, HyperACE at n = 1 and 2, DownsampleConv
   and FullPAD_Tunnel with a non-zero gate, each against its JAX module on
   seeded random variables carried through `jax_to_torch_state_dict` (a
   strict load), NHWC for JAX and NCHW for the port. Tolerance: 1e-5 times
   the output's largest magnitude (f32, summation order differs).
3. yolov13n: loads the JAX package's seeded variables strictly, carries them
   back to the same flax tree, and meets the JAX `apply` at 64 and 96 px,
   boxes within 1e-3 px, scores within 1e-5.

The trap: every FullPAD_Tunnel gate starts at 0, and every path from
HyperACE (layer 9) to the head runs through one (layers 12, 13, 14, 18, 23
through 22, 27, 31), so at initialisation HyperACE, DownsampleConv and layer
22 change no output. Every comparison of a whole model here therefore sets
each gate to a seeded value in [0.5, 1.5] (`seed_gates`), in the JAX tree
and through the carrier in the port; `test_zero_gates_cut_hyperace_off`
pins the trap.

4. One trainer epoch of yolov13n at 64 px (16 images, batch 8, nbs 16: one
   optimizer step) against the JAX trainer from the same weights, at the zoo
   trainer tests' tolerances (tests/test_torch_zoo_train.py): loss parts
   within 1e-3 relative, parameters, EMA and BN statistics within 1e-4 of
   the tree's largest magnitude, momentum buffers within JAX_STEP_TOL.
5. Predict and val of yolov13n at 64 px against the JAX facade (K1's plain
   version as the NMS on the CPU): the same detections in the same order,
   boxes within 1e-3 px, scores within 1e-5; every metric within 1e-6.
"""

import shutil

import numpy as np
import pytest
import torch

from tests.conftest import FIXTURES
from tests.test_torch_modules import carry, nchw, to_nhwc, torch_threads  # noqa: F401 (autouse fixture)
from tests.test_torch_rtdetr_train import JAX_STEP_TOL, rel_l2
from tests.test_torch_train import leaves, same_images_as_jax, task_data_yaml
from tests.test_torch_zoo import _close
from tests.test_torch_zoo2 import JAX_MODELS, jax_and_port
from tests.test_torch_zoo_train import tree_max_rel
from ultralytics_pro_tpu_torch import YOLO
from ultralytics_pro_tpu_torch.engine.trainer import load_pickle, param_group
from ultralytics_pro_tpu_torch.nn.modules import v13 as V
from ultralytics_pro_tpu_torch.nn.tasks import yaml_model_load
from ultralytics_pro_tpu_torch.utils import PKG_ROOT, miniyaml
from ultralytics_pro_tpu_torch.utils.weights import jax_to_torch_state_dict, torch_state_dict_to_jax

GATES = (0.5, 1.5)  # the seeded gates' range
NC = 3


def test_yaml_copy_equals_the_jax_package_file():
    import yaml

    rel = "13/yolov13.yaml"
    assert miniyaml.load(PKG_ROOT / "cfg" / "models" / rel) == yaml.safe_load((JAX_MODELS / rel).read_text())


def seed_gates(variables: dict, seed: int) -> dict:
    """The flax tree with every FullPAD_Tunnel `gate` set to a seeded value in GATES."""
    rng = np.random.default_rng(seed)

    def walk(tree):
        return {k: np.float32(rng.uniform(*GATES)) if k == "gate" else walk(v) if hasattr(v, "items") else v
                for k, v in tree.items()}

    return {**variables, "params": walk(variables["params"])}


# -- blocks -----------------------------------------------------------------------

def _jv13():
    from ultralytics_pro_tpu.nn.modules import v13

    return v13


def _jdsconv(**kw):
    from ultralytics_pro_tpu.nn.modules.attention import DSConv

    return DSConv(**kw)


# (JAX module factory, port module factory, input channels (a tuple for HyperACE's three maps), map size)
BLOCKS = {
    "DSConv": (lambda: _jdsconv(c2=32, k=3), lambda: V.DSConv(16, 32, 3), 16, 8),
    "DSConv_s2_k5": (lambda: _jdsconv(c2=32, k=5, s=2), lambda: V.DSConv(16, 32, 5, 2), 16, 9),
    "DSBottleneck": (lambda: _jv13().DSBottleneck(c2=32), lambda: V.DSBottleneck(32, 32), 32, 8),
    "DSBottleneck_37_no_shortcut": (lambda: _jv13().DSBottleneck(c2=32, shortcut=False, e=1.0, k1=3, k2=7),
                                    lambda: V.DSBottleneck(32, 32, False, 1.0, 3, 7), 32, 8),
    "DSC3k": (lambda: _jv13().DSC3k(c2=32, n=2), lambda: V.DSC3k(16, 32, 2), 16, 8),
    "DSC3k2": (lambda: _jv13().DSC3k2(c2=64, n=2, e=0.25), lambda: V.DSC3k2(32, 64, 2, False, 0.25), 32, 8),
    "DSC3k2_dsc3k": (lambda: _jv13().DSC3k2(c2=64, n=1, dsc3k=True), lambda: V.DSC3k2(32, 64, 1, True), 32, 8),
    "AdaHG_both": (lambda: _jv13().AdaHGComputation(num_hyperedges=8, num_heads=2, context="both"),
                   lambda: V.AdaHGComputation(32, 8, 2, "both"), 32, 6),
    "AdaHG_mean": (lambda: _jv13().AdaHGComputation(num_hyperedges=4, num_heads=4, context="mean"),
                   lambda: V.AdaHGComputation(32, 4, 4, "mean"), 32, 5),
    "AdaHG_max": (lambda: _jv13().AdaHGComputation(num_hyperedges=8, num_heads=1, context="max"),
                  lambda: V.AdaHGComputation(32, 8, 1, "max"), 32, 6),
    "C3AH_rounds_to_32": (lambda: _jv13().C3AH(c2=40), lambda: V.C3AH(24, 40), 24, 6),
    "HyperACE_n1": (lambda: _jv13().HyperACE(c2=32, n=1, shortcut=True),
                    lambda: V.HyperACE((16, 24, 32), 32, 1, shortcut=True), (16, 24, 32), 8),
    "HyperACE_n2": (lambda: _jv13().HyperACE(c2=64, n=2, num_hyperedges=4),
                    lambda: V.HyperACE((16, 24, 32), 64, 2, 4), (16, 24, 32), 8),
    "DownsampleConv": (lambda: _jv13().DownsampleConv(), lambda: V.DownsampleConv(16), 16, 8),
    "DownsampleConv_odd_no_adjust": (lambda: _jv13().DownsampleConv(channel_adjust=False),
                                     lambda: V.DownsampleConv(16, False), 16, 7),
    "FullPAD_Tunnel": (lambda: _jv13().FullPAD_Tunnel(), lambda: V.FullPAD_Tunnel(), (16, 16), 8),
}


def _block_inputs(c1, hw: int):
    """One NHWC array, or HyperACE's (P3, P4, P5) at 2hw, hw, hw/2, or FullPAD's two maps."""
    rng = np.random.default_rng(1)
    if not isinstance(c1, tuple):
        return rng.normal(0, 1, (2, hw, hw, c1)).astype(np.float32)
    sizes = (2 * hw, hw, hw // 2) if len(c1) == 3 else (hw, hw)
    return [rng.normal(0, 1, (2, s, s, c)).astype(np.float32) for s, c in zip(sizes, c1)]


@pytest.mark.parametrize("case", list(BLOCKS))
def test_block_matches_jax(case):
    make_jax, make, c1, hw = BLOCKS[case]
    x = _block_inputs(c1, hw)
    jm, tm = make_jax(), make()
    v = carry(jm, x, tm, seed=2)
    if case == "FullPAD_Tunnel":
        v = seed_gates(v, 3)
        tm.load_state_dict(jax_to_torch_state_dict(v))
        assert GATES[0] <= float(tm.gate.detach()) <= GATES[1]
    want = jm.apply(v, x, train=False)
    with torch.no_grad():
        got = to_nhwc(tm([nchw(a) for a in x] if isinstance(x, list) else nchw(x)))
    assert got.shape == want.shape
    _close(got, want)


def test_block_names_and_shapes_are_the_jax_ones():
    """DSConv's `dwconv` (depth-wise, groups c1) and `pwconv`; C3AH's width
    (40 -> 32) and heads (32 // 16); AdaHGComputation's prototypes (ne, C)
    and dense layers directly under it; HyperACE's names; the gate a 0-d
    parameter at 0."""
    ds = V.DSConv(16, 32, 5, 2)
    assert ds.dwconv.conv.groups == 16 and ds.dwconv.conv.stride == (2, 2) and ds.pwconv.conv.kernel_size == (1, 1)
    c3ah = V.C3AH(24, 40)
    assert c3ah.m.num_heads == 2 and c3ah.m.prototype_base.shape == (8, 32)
    assert {"m.prototype_base", "m.context_net.weight", "m.pre_head_proj.bias", "m.edge_proj.weight",
            "m.node_proj.weight", "cv3.conv.weight"} <= set(c3ah.state_dict())
    names = set(V.HyperACE((16, 24, 32), 32, 2).state_dict())
    assert {"fuse_conv.conv.weight", "branch1.m.prototype_base", "branch2.cv1.bn.running_var",
            "m.1.m.1.cv2.dwconv.conv.weight", "cv2.conv.weight"} <= names
    gate = V.FullPAD_Tunnel().gate
    assert gate.shape == () and float(gate.detach()) == 0.0 and gate.requires_grad


def test_hyperace_needs_p5_at_half_p4():
    """The nearest resize of P5 is exact only at 2x (JAX samples at the half pixel, torch at the floor)."""
    m = V.HyperACE((8, 8, 8), 16).eval()
    with pytest.raises(ValueError, match="twice"):
        m([torch.zeros(1, 8, 12, 12), torch.zeros(1, 8, 6, 6), torch.zeros(1, 8, 2, 2)])


# -- yolov13n, whole ------------------------------------------------------------------

@pytest.fixture(scope="module")
def v13_pair():
    """(JAX model, its seeded variables with seeded gates, the port model loaded from them)."""
    jm, variables, port = jax_and_port("yolov13n.yaml", seed=8)
    variables = seed_gates(variables, 9)
    port.load_state_dict(jax_to_torch_state_dict(variables))  # strict
    return jm, variables, port


def test_yolov13n_builds_as_the_jax_package_builds_it(v13_pair):
    """The carrier maps every name both ways; the strides; the grouped stem
    convs of rows [128, 3, 2, 1, 2] and [256, 3, 2, 1, 4] with their JAX
    kernels; HyperACE's n from the repeats (2 x depth 0.5); the head's light
    class branch (HyperACE in the YAML)."""
    jm, variables, port = v13_pair
    back = dict(leaves(torch_state_dict_to_jax(port.state_dict())))
    assert back.keys() == dict(leaves(variables)).keys()
    for k, w in leaves(variables):
        np.testing.assert_array_equal(back[k], w, err_msg="/".join(k))
    assert port.stride.tolist() == [float(s) for s in jm.stride] == [8.0, 16.0, 32.0]
    for i, g in ((1, 2), (3, 4)):
        conv = port.model[i].conv
        assert conv.groups == g and conv.padding == (1, 1) and conv.stride == (2, 2)
        kernel = variables["params"][f"layers_{i}"]["conv"]["kernel"]  # HWIO, I = c1 / g
        np.testing.assert_array_equal(conv.weight.detach().numpy(), kernel.transpose(3, 2, 0, 1))
    assert len(port.model[9].m) == 1 and port.model[-1].legacy is False
    assert [type(port.model[i]).__name__ for i in (11, 12, 31)] == ["DownsampleConv", "FullPAD_Tunnel",
                                                                    "FullPAD_Tunnel"]


@pytest.mark.parametrize("size", [64, 96])
def test_yolov13n_forward_matches_jax(v13_pair, size):
    import jax

    jm, variables, port = v13_pair
    x = np.random.default_rng(10).uniform(0, 1, (2, 3, size, size)).astype(np.float32)
    want, _ = jax.jit(lambda v, xx: jm.apply(v, xx, train=False))(variables, x.transpose(0, 2, 3, 1))
    want = np.asarray(want)
    with torch.no_grad():
        got, _ = port(torch.from_numpy(x))
    got = got.numpy()
    assert got.shape == want.shape == (2, 21 * size * size // 1024, 4 + 80)
    np.testing.assert_allclose(got[..., :4], want[..., :4], atol=1e-3, rtol=0)
    np.testing.assert_allclose(got[..., 4:], want[..., 4:], atol=1e-5, rtol=0)


def test_zero_gates_cut_hyperace_off(v13_pair):
    """With every gate at 0, HyperACE's weights (layer 9) change no output;
    with the seeded gates they do."""
    import copy

    _, _, port = v13_pair
    x = torch.from_numpy(np.random.default_rng(11).uniform(0, 1, (1, 3, 64, 64)).astype(np.float32))

    def outputs(model, gates_zero: bool, perturb: bool):
        m = copy.deepcopy(model)
        with torch.no_grad():
            for mod in m.modules():
                if isinstance(mod, V.FullPAD_Tunnel) and gates_zero:
                    mod.gate.zero_()
            if perturb:
                for p in m.model[9].parameters():
                    p.add_(torch.randn(p.shape, generator=torch.Generator().manual_seed(12)))
            return m(x)[0]

    for gates_zero in (True, False):
        same = torch.equal(outputs(port, gates_zero, False), outputs(port, gates_zero, True))
        assert same is gates_zero


def test_gate_and_prototypes_are_decayed_as_jax_groups_them():
    """FullPAD's `gate` and AdaHG's `prototype_base` are flax `self.param`
    leaves, neither `scale` nor `bias`: group 0 (decayed) in both packages."""
    from ultralytics_pro_tpu.engine.trainer import param_group as jgroup

    model = YOLO("yolov13n.yaml", device="cpu").model
    groups = {name: param_group(mod, name.rsplit(".", 1)[-1])
              for mod_name, mod in model.named_modules() for name, _ in mod.named_parameters(mod_name, recurse=False)}
    for leaf in ("gate", "prototype_base"):
        names = [n for n in groups if n.endswith(leaf)]
        assert names and {groups[n] for n in names} == {jgroup((leaf,))} == {0}


# -- predict, val and training against the JAX facade ----------------------------------------

KW = dict(epochs=1, imgsz=64, batch=8, nbs=16, warmup_epochs=0.0, val=False, workers=2, max_gt=32)


def port_model() -> YOLO:
    """yolov13n at nc 3 from seed 3, its gates seeded."""
    model = YOLO({**yaml_model_load("yolov13n.yaml"), "nc": NC}, device="cpu", seed=3)
    variables = seed_gates(torch_state_dict_to_jax(model.model.state_dict()), 4)
    model.load_state_dict(jax_to_torch_state_dict(variables))
    return model


def jax_model(port: YOLO):
    from ultralytics_pro_tpu import YOLO as JYOLO
    from ultralytics_pro_tpu.nn.tasks import yaml_model_load as jyaml

    model = JYOLO({**jyaml("yolov13n.yaml"), "nc": NC})
    model.model.variables = torch_state_dict_to_jax(port.model.state_dict())
    return model


@pytest.fixture(scope="module")
def pair():
    """yolov13n (seeded gates) in both facades on the same weights; the
    predict and val tests read it before `trained` trains it."""
    port = port_model()
    return port, jax_model(port)


def test_predict_matches_jax(pair):
    rng = np.random.default_rng(13)
    imgs = [rng.integers(0, 256, (64, 48, 3), dtype=np.uint8), rng.integers(0, 256, (40, 64, 3), dtype=np.uint8)]
    port, jax_yolo = pair
    kw = dict(imgsz=64, conf=1e-3)
    got, ref = port.predict(imgs, **kw), jax_yolo.predict(imgs, **kw)
    assert all(len(r.boxes.data) for r in got)
    for g, r in zip(got, ref):
        rd = np.asarray(r.boxes.data)
        assert len(g.boxes.data) == len(rd)
        np.testing.assert_array_equal(g.boxes.cls, rd[:, 5])
        np.testing.assert_allclose(g.boxes.xyxy, rd[:, :4], atol=1e-3, rtol=0)
        np.testing.assert_allclose(g.boxes.conf, rd[:, 4], atol=1e-5, rtol=0)


def test_val_matches_jax(pair, tmp_path):
    data = shutil.copytree(f"{FIXTURES}/torch_val_synth", tmp_path / "set") / "data.yaml"
    port, jax_yolo = pair
    kw = dict(imgsz=64, batch=8, conf=0.001)
    with same_images_as_jax():
        got = port.val(data=str(data), **kw)
    want = jax_yolo.val(data=str(data), plots=False, **kw)
    assert sum(len(c) for c in got.stats["conf"]) > 0
    for k, v in want.results_dict.items():
        assert got.results_dict[k] == pytest.approx(float(v), abs=1e-6), k


@pytest.fixture(scope="module")
def trained(pair, tmp_path_factory):
    """One epoch of yolov13n (KW) by each facade of `pair`, from the same
    weights; also the parameters before it, as a flax tree."""
    from ultralytics_pro_tpu.nn.modules import conv as jconv

    root = tmp_path_factory.mktemp("v13_train")
    data = task_data_yaml(root / "set")
    port, jax_yolo = pair
    start = torch_state_dict_to_jax(port.model.state_dict())["params"]
    with same_images_as_jax():
        port.train(data=str(data), project=str(root / "port"), **KW)
    saved = jconv.BN_FAST_VARIANCE[0]
    jconv.BN_FAST_VARIANCE[0] = False
    try:
        jax_yolo.train(data=str(data), project=str(root / "jax"), device=1, **KW)
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
    # the seeded gates pass HyperACE's gradient: the gates and its prototypes moved in both steps
    for ckpt in (cp, cj):
        assert ckpt["params"]["layers_12"]["gate"] != start["layers_12"]["gate"]
        moved = ckpt["params"]["layers_9"]["branch1"]["m"]["prototype_base"] - start["layers_9"]["branch1"]["m"][
            "prototype_base"]
        assert np.abs(moved).max() > 0
