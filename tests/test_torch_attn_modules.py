"""The attention modules of the v5/v8 attention YAMLs in the port against the
JAX package's, on the CPU.

1. Each module (and the three helpers ChannelAttention, SpatialAttention and
   _ZPoolGate) against its JAX module on seeded random variables carried
   through `jax_to_torch_state_dict` (a strict load), NHWC for JAX and NCHW
   for the port, on maps that are not square; in eval mode, and in train
   mode where it holds a BatchNorm (its updated statistics too). Every
   zero-initialised parameter (CrissCrossAttention's `gamma`,
   ShuffleAttention's `cweight` and `sweight`, FocusedLinearAttention's
   `pos` and `scale`) takes a seeded non-zero value there. Tolerance: f32,
   1e-4 of the output's largest magnitude.
2. The traps: MHSA off the map size it was built for raises in both
   packages (the module; the facades after their first call, which sets the
   size; TTA's scales in the port); CrissCrossAttention at `gamma` = 0 is
   its input, bit for bit, in both; BiLevelRoutingAttention's routing breaks
   ties to the lower region as `lax.top_k` does, and its window count falls
   back to 2 and 1 as the JAX module's does; the optimizer groups of the new
   parameters are the JAX trainer's, leaf by leaf.
"""

import numpy as np
import pytest
import torch

from tests.test_torch_modules import nchw, randomize, to_nhwc, torch_threads  # noqa: F401 (autouse fixture)
from ultralytics_pro_tpu_torch.nn.modules import attention as A
from ultralytics_pro_tpu_torch.nn.modules import conv as C
from ultralytics_pro_tpu_torch.nn.modules.families import BiLevelRoutingAttention, top_regions
from ultralytics_pro_tpu_torch.utils.weights import jax_to_torch_state_dict

TOL = 1e-4  # of the output's largest magnitude


def _ja():
    from ultralytics_pro_tpu.nn.modules import attention

    return attention


def _jc():
    from ultralytics_pro_tpu.nn.modules import conv

    return conv


def _jf():
    from ultralytics_pro_tpu.nn.modules import families

    return families


def bound_mhsa(c: int, heads: int, h: int, w: int) -> A.MHSA:
    m = A.MHSA(c, heads)
    m.bind(h, w)
    return m


# case -> (JAX module factory, port module factory, input channels, (H, W), holds a BatchNorm)
CASES = {
    "ChannelAttention": (lambda: _jc().ChannelAttention(), lambda: C.ChannelAttention(16), 16, (6, 8), False),
    "SpatialAttention": (lambda: _jc().SpatialAttention(k=7), lambda: C.SpatialAttention(7), 16, (6, 8), False),
    "CBAM": (lambda: _jc().CBAM(k=7), lambda: C.CBAM(16, 7), 16, (6, 8), False),
    "CBAM_k3": (lambda: _jc().CBAM(k=3), lambda: C.CBAM(16, 3), 16, (5, 7), False),
    "_ZPoolGate": (lambda: _ja()._ZPoolGate(), lambda: A._ZPoolGate(), 16, (6, 8), True),
    "MHSA": (lambda: _ja().MHSA(heads=4), lambda: bound_mhsa(32, 4, 6, 8), 32, (6, 8), False),
    "CoordAtt": (lambda: _ja().CoordAtt(reduction=32), lambda: A.CoordAtt(32, 32), 32, (6, 8), True),
    "CoordAtt_r4": (lambda: _ja().CoordAtt(reduction=4), lambda: A.CoordAtt(64, 4), 64, (5, 7), True),
    "SEAttention": (lambda: _ja().SEAttention(reduction=16), lambda: A.SEAttention(64, 16), 64, (6, 8), False),
    "ECAAttention": (lambda: _ja().ECAAttention(kernel_size=3), lambda: A.ECAAttention(3), 16, (6, 8), False),
    "ECAAttention_k5": (lambda: _ja().ECAAttention(kernel_size=5), lambda: A.ECAAttention(5), 16, (6, 8), False),
    "SimAM": (lambda: _ja().SimAM(), lambda: A.SimAM(), 8, (6, 8), False),
    "EMA": (lambda: _ja().EMA(factor=8), lambda: A.EMA(32, 8), 32, (6, 8), False),
    "GAMAttention": (lambda: _ja().GAMAttention(c2=16), lambda: A.GAMAttention(16, 16), 16, (6, 8), True),
    "GAMAttention_no_group": (lambda: _ja().GAMAttention(group=False), lambda: A.GAMAttention(16, 0, False), 16,
                              (5, 7), True),
    "CrissCrossAttention": (lambda: _ja().CrissCrossAttention(), lambda: A.CrissCrossAttention(16), 16, (6, 8),
                            False),
    "SKAttention": (lambda: _ja().SKAttention(reduction=16), lambda: A.SKAttention(16, reduction=16), 16, (6, 8),
                    True),
    "TripletAttention": (lambda: _ja().TripletAttention(), lambda: A.TripletAttention(), 16, (6, 8), True),
    "TripletAttention_no_spatial": (lambda: _ja().TripletAttention(no_spatial=1024),
                                    lambda: A.TripletAttention(1024), 16, (6, 8), True),
    "ShuffleAttention": (lambda: _ja().ShuffleAttention(G=8), lambda: A.ShuffleAttention(32, 8), 32, (6, 8), False),
    "LSKblock": (lambda: _ja().LSKblock(), lambda: A.LSKblock(16), 16, (6, 8), False),
    "EffectiveSE": (lambda: _ja().EffectiveSE(), lambda: A.EffectiveSE(16), 16, (6, 8), False),
    "EffectiveSE_maxpool": (lambda: _ja().EffectiveSE(add_maxpool=True), lambda: A.EffectiveSE(16, True), 16,
                            (6, 8), False),
    "SegNext_Attention": (lambda: _ja().SegNext_Attention(), lambda: A.SegNext_Attention(8), 8, (6, 8), False),
    "DAttention": (lambda: _ja().DAttention(), lambda: A.DAttention(16), 16, (6, 8), False),
    "LSKA": (lambda: _ja().LSKA(k=11), lambda: A.LSKA(8, 11), 8, (6, 8), False),
    "LSKA_k7": (lambda: _ja().LSKA(k=7), lambda: A.LSKA(8, 7), 8, (9, 7), False),
    "CPCA": (lambda: _ja().CPCA(), lambda: A.CPCA(16), 16, (6, 8), False),
    "FocusedLinearAttention": (lambda: _ja().FocusedLinearAttention(num_heads=8),
                               lambda: A.FocusedLinearAttention(16, 8), 16, (6, 8), False),
    "FocusedLinearAttention_one_head": (lambda: _ja().FocusedLinearAttention(num_heads=8),
                                        lambda: A.FocusedLinearAttention(12, 8), 12, (5, 7), False),
    "BiLevelRoutingAttention": (lambda: _jf().BiLevelRoutingAttention(num_heads=8, topk=4),
                                lambda: BiLevelRoutingAttention(16, 8, topk=4), 16, (8, 8), False),
    "BiLevelRoutingAttention_nwin2": (lambda: _jf().BiLevelRoutingAttention(num_heads=8, topk=4),
                                      lambda: BiLevelRoutingAttention(16, 8, topk=4), 16, (6, 10), False),
    "BiLevelRoutingAttention_nwin1_one_head": (lambda: _jf().BiLevelRoutingAttention(num_heads=8, topk=4),
                                               lambda: BiLevelRoutingAttention(12, 8, topk=4), 12, (5, 7), False),
}
MODES = [(case, mode) for case, spec in CASES.items() for mode in (("eval", "train") if spec[4] else ("eval",))]


def jax_variables(jm, x, seed: int):
    """Seeded values for every variable of jm at input x (`randomize`: every
    zero-initialised parameter non-zero), its layout from `jax.eval_shape`."""
    import jax

    shapes = jax.eval_shape(lambda xx: jm.init(jax.random.PRNGKey(0), xx, train=False), x)
    return randomize(jax.tree_util.tree_map(lambda a: np.zeros(a.shape, np.float32), shapes), seed)


def close(got, want, tol: float = TOL):
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=tol * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("case,mode", MODES)
def test_module_matches_jax(case, mode):
    import jax

    make_jax, make, c, (h, w), _ = CASES[case]
    x = np.random.default_rng(1).normal(0, 1, (2, h, w, c)).astype(np.float32)
    jm, tm = make_jax(), make()
    v = jax_variables(jm, x, seed=2)
    tm.load_state_dict(jax_to_torch_state_dict(v))  # strict
    if mode == "train":
        want, upd = jax.jit(lambda v, xx: jm.apply(v, xx, train=True, mutable=["batch_stats"]))(v, x)
        with torch.no_grad():
            got = to_nhwc(tm.train()(nchw(x)))
        close(got, want)
        stats = {k: t.numpy() for k, t in tm.state_dict().items() if k.endswith(("running_mean", "running_var"))}
        want_stats = jax_to_torch_state_dict({"batch_stats": jax.tree_util.tree_map(np.asarray, upd["batch_stats"])})
        assert stats.keys() == {k for k in want_stats if not k.endswith("num_batches_tracked")}
        for k, s in stats.items():
            close(s, want_stats[k].numpy(), 1e-5)
        return
    want = jax.jit(lambda v, xx: jm.apply(v, xx, train=False))(v, x)
    with torch.no_grad():
        got = to_nhwc(tm.eval()(nchw(x)))
    close(got, want)


def test_module_names_are_the_carriers():
    """Names as `utils/weights.py` carries the flax ones: `fc_0` is `fc.0`,
    SegNext's `conv0_1` is `conv0.1`, SK's `convs_0_conv` stays."""
    assert set(A.SEAttention(64).state_dict()) == {"fc.0.weight", "fc.0.bias", "fc.1.weight", "fc.1.bias"}
    assert {"conv0.weight", "conv0.1.weight", "conv0.2.bias", "conv1.1.weight", "conv2.2.weight",
            "conv3.weight"} <= set(A.SegNext_Attention(8).state_dict())
    assert {"convs_0_conv.weight", "convs_3_bn.running_var", "fcs.3.weight", "fc.weight"} <= \
        set(A.SKAttention(16).state_dict())
    assert {"conv_offset.0.weight", "conv_offset.1.weight", "conv_offset.3.weight"} <= \
        set(A.DAttention(16).state_dict())
    assert "conv_offset.3.bias" not in A.DAttention(16).state_dict()
    assert {"channel_attention.0.weight", "channel_attention.2.bias", "spatial_attention.1.running_mean",
            "spatial_attention.4.weight"} <= set(A.GAMAttention(16).state_dict())
    assert set(A.ShuffleAttention(32).state_dict()) == {"cweight", "cbias", "sweight", "sbias", "gn.weight",
                                                        "gn.bias"}
    assert {"pos", "scale", "q.weight", "kv.weight", "dwc.weight", "proj.weight"} == \
        {k for k in A.FocusedLinearAttention(16).state_dict() if not k.endswith("bias")}
    assert "hw.conv.weight" not in A.TripletAttention(1024).state_dict()


# -- MHSA off its size --------------------------------------------------------------------

def test_mhsa_raises_off_its_map_size_in_both_packages():
    """flax checks a parameter's shape against its initializer's on every
    apply (ScopeParamShapeError naming `rel_h`); the port's MHSA raises a
    ValueError naming it."""
    from flax.errors import ScopeParamShapeError

    x = np.random.default_rng(3).normal(0, 1, (1, 4, 4, 32)).astype(np.float32)
    jm = _ja().MHSA(heads=4)
    v = jax_variables(jm, x, seed=4)
    other = np.zeros((1, 6, 4, 32), np.float32)
    with pytest.raises(ScopeParamShapeError, match="rel_h"):
        jm.apply(v, other)
    tm = bound_mhsa(32, 4, 4, 4)
    tm.load_state_dict(jax_to_torch_state_dict(v))
    with pytest.raises(ValueError, match="rel_h"):
        tm(torch.zeros(1, 32, 6, 4))
    with pytest.raises(ValueError, match="rel_h"):
        A.MHSA(32, 4)(torch.zeros(1, 32, 4, 4))  # never bound


def test_mhsa_model_binds_at_the_first_calls_size_in_both_facades():
    """A fresh yolov8n-MHSA predicts at its first call's imgsz (the JAX
    facade initialises there; the port rebuilds there from its seed), and a
    later call at another size raises in both; the port's TTA, whose scales
    shrink the map, raises too."""
    from flax.errors import ScopeParamShapeError

    from ultralytics_pro_tpu import YOLO as JYOLO
    from ultralytics_pro_tpu_torch import YOLO

    img = np.zeros((40, 48, 3), np.uint8)
    jy, py = JYOLO("yolov8n-MHSA.yaml"), YOLO("yolov8n-MHSA.yaml", device="cpu")
    assert py.model.imgsz == 640 and py.model.model[10].rel_h.shape == (1, 4, 64, 20, 1)
    for m in (jy, py):
        m.predict([img], imgsz=96, conf=0.5)
    assert jy.model.variables["params"]["layers_10"]["rel_h"].shape == (1, 4, 64, 3, 1)
    assert py.model.imgsz == 96 and py.model.model[10].rel_h.shape == (1, 4, 64, 3, 1)
    with pytest.raises(ScopeParamShapeError, match="rel_h"):
        jy.predict([img], imgsz=64, conf=0.5)
    with pytest.raises(ValueError, match="rel_h"):
        py.predict([img], imgsz=64, conf=0.5)
    py = YOLO("yolov8n-MHSA.yaml", device="cpu")
    py.predict([img], imgsz=640, conf=0.5)
    with pytest.raises(ValueError, match="rel_h"):  # the second pass runs at 544 px
        py.predict([img], imgsz=640, conf=0.5, augment=True)
    assert YOLO("yolov8n.yaml", device="cpu").model.imgsz is None


# -- the zero-initialised parameters ----------------------------------------------------------

def test_crisscross_at_zero_gamma_is_its_input_in_both_packages():
    import jax

    x = np.random.default_rng(5).normal(0, 1, (2, 6, 8, 16)).astype(np.float32)
    jm = _ja().CrissCrossAttention()
    v = jax_variables(jm, x, seed=6)
    v["params"]["gamma"] = np.zeros(1, np.float32)
    tm = A.CrissCrossAttention(16)
    tm.load_state_dict(jax_to_torch_state_dict(v))
    np.testing.assert_array_equal(np.asarray(jax.jit(jm.apply)(v, x)), x)
    with torch.no_grad():
        assert torch.equal(tm(nchw(x)), nchw(x))
    assert torch.equal(A.CrissCrossAttention(16).gamma, torch.zeros(1))  # as built


def test_zero_initialised_parameters_start_as_flax_starts_them():
    s, f = A.ShuffleAttention(32), A.FocusedLinearAttention(16)
    for p, fill in ((s.cweight, 0.0), (s.cbias, 1.0), (s.sweight, 0.0), (s.sbias, 1.0), (f.pos, 0.0),
                    (f.scale, 0.0)):
        assert torch.equal(p, torch.full_like(p, fill))
    assert s.cweight.shape == (1, 1, 1, 2) and f.scale.shape == (1, 1, 16)


# -- BiLevelRoutingAttention's routing ---------------------------------------------------------

def test_top_regions_break_ties_as_lax_top_k():
    import jax

    rng = np.random.default_rng(7)
    aff = rng.integers(0, 3, (4, 16, 16)).astype(np.float32)  # many ties
    aff[0] = 1.0  # all tied
    for k in (1, 4, 16):
        want = np.asarray(jax.lax.top_k(aff, k)[1])
        np.testing.assert_array_equal(top_regions(torch.from_numpy(aff), k).numpy(), want)
    assert top_regions(torch.from_numpy(aff[:1]), 4)[0, 0].tolist() == [0, 1, 2, 3]


def test_bilevel_routing_on_tied_regions_matches_jax():
    """An 8 x 8 map of 16 regions whose mean keys tie exactly (each region
    four integer tokens of one common mean, qkv the identity), their tokens
    different: every query region routes to regions 0-3, as JAX's
    `lax.top_k` picks them; another tie-break would gather other tokens."""
    import jax

    rng = np.random.default_rng(8)
    mean = rng.integers(-2, 3, 8).astype(np.float32)
    x = np.zeros((1, 8, 8, 8), np.float32)
    for r in range(16):
        ry, rx = divmod(r, 4)
        dev = rng.integers(-3, 4, (4, 8)).astype(np.float32)
        dev[3] = -dev[:3].sum(0)  # the four deviations sum to 0: the region's mean is `mean`
        x[0, 2 * ry:2 * ry + 2, 2 * rx:2 * rx + 2] = (mean + dev).reshape(2, 2, 8)
    regions = torch.from_numpy(x[0]).reshape(4, 2, 4, 2, 8).permute(0, 2, 1, 3, 4).reshape(16, 4, 8)
    assert torch.equal(regions.mean(1), torch.from_numpy(mean).expand(16, 8))
    assert len({tuple(r.flatten().tolist()) for r in regions}) == 16
    jm = _jf().BiLevelRoutingAttention(num_heads=8, topk=4)
    v = jax_variables(jm, x, seed=9)
    v["params"]["qkv"] = {"kernel": np.tile(np.eye(8, dtype=np.float32), 3), "bias": np.zeros(24, np.float32)}
    tm = BiLevelRoutingAttention(8, 8, topk=4)
    tm.load_state_dict(jax_to_torch_state_dict(v))
    want = jax.jit(jm.apply)(v, x)
    with torch.no_grad():
        got = to_nhwc(tm(nchw(x)))
    close(got, want)
    from ultralytics_pro_tpu_torch.nn.modules import families

    with pytest.MonkeyPatch.context() as mp, torch.no_grad():  # ties to the higher region: another output
        mp.setattr(families, "top_regions", lambda aff, k: top_regions(aff.flip(-1), k).flip(-1).neg() + 15)
        other = to_nhwc(tm(nchw(x)))
    assert np.abs(other - np.asarray(want)).max() > 1e-2


@pytest.mark.parametrize("hw,nwin", [((20, 20), 4), ((8, 8), 4), ((6, 10), 2), ((5, 5), 1), ((4, 6), 2),
                                     ((7, 8), 1)])
def test_bilevel_window_fallback(hw, nwin):
    """P5 at 640 px is 20 x 20: 4 x 4 windows; at 160 px 5 x 5: one window,
    which routes nothing."""
    assert BiLevelRoutingAttention(16).windows(*hw) == nwin


# -- optimizer groups ----------------------------------------------------------------------

@pytest.mark.parametrize("name", ["ShuffleAttention", "EMA", "FocusedLinearAttention", "DAttention", "MHSA",
                                  "CrissCrossAttention"])
def test_param_groups_are_the_jax_trainers(name):
    """Every parameter of a yolov8n-<Att> model in the JAX trainer's group of
    its carried flax leaf: `cbias` and `sbias` 0 (decayed), GroupNorm's and
    LayerNorm's weights 1, FocusedLinearAttention's bare `scale` 1."""
    from ultralytics_pro_tpu.engine.trainer import param_group as jgroup
    from ultralytics_pro_tpu_torch.engine.trainer import param_group
    from ultralytics_pro_tpu_torch.nn.tasks import DetectionModel
    from ultralytics_pro_tpu_torch.utils.weights import torch_key_to_flax

    model = DetectionModel(f"yolov8n-{name}.yaml", imgsz=64)
    owners = dict(model.named_modules())
    groups = {}
    for key, p in model.named_parameters():
        if key.endswith("dfl.conv.weight"):
            continue
        owner, _, leaf = key.rpartition(".")
        path, fleaf, _ = torch_key_to_flax(key, p.ndim)
        groups[key] = param_group(owners[owner], leaf)
        assert groups[key] == jgroup((*path, fleaf)), key
    layer = {k.split(".", 2)[2]: g for k, g in groups.items() if k.startswith("model.10.")}
    expect = {"ShuffleAttention": {"cbias": 0, "sbias": 0, "cweight": 0, "gn.weight": 1, "gn.bias": 2},
              "EMA": {"gn.weight": 1, "gn.bias": 2, "conv1x1.weight": 0},
              "FocusedLinearAttention": {"scale": 1, "pos": 0, "q.bias": 2},
              "DAttention": {"conv_offset.1.weight": 1, "conv_offset.1.bias": 2, "proj_q.weight": 0},
              "MHSA": {"rel_h": 0, "rel_w": 0, "query.bias": 2},
              "CrissCrossAttention": {"gamma": 0, "value_conv.bias": 2}}[name]
    assert {k: layer[k] for k in expect} == expect
