"""The modules of yolov8-att, MAF-YOLOv2 and Hyper-YOLO in the port against
the JAX package's, on the CPU (the heads, the builder's rows and the
predictors' head selection: tests/test_torch_att_maf_hyper_heads.py).

1. `ops/deform.py:deform_conv2d` against the JAX function on the same
   inputs: its three contractions (groups 1, depth-wise, grouped), with and
   without the mask, at strides 1 and 2 and dilations 1 and 3, on offsets
   that put taps on the map's last row and column, on integer positions and
   outside the map (the `ix <= w - 1` corner test); the depth-wise form with
   other output channels raises in both.
2. Blocks: BoT3, DCNv2, C2f_DCN, C3_DCN, DeformConvDW, deformable_LKA,
   deformable_LKA_Attention, C2f_DLKA, AVG and nn.AvgPool2d,
   DepthBottleneckUni, RepHMS at widths 2 and 3, MANet, HyperComputeModule
   (on tokens whose incidence share lies between 0.2 and 0.8, asserted),
   GRN and UniRepLKNetBlock, each against its JAX module on seeded variables
   carried by `jax_to_torch_state_dict` (strict), the bare deformable
   kernels drawn by their fan-in (`tests/torch_att_maf_hyper.py:seeded`),
   GRN's and the layer scale's parameters away from 0; in eval and train
   mode (the updated BN statistics too): within 1e-5 of the output's
   largest magnitude.
3. The zero-initialised parameters: at their initial values the
   large-kernel block is the identity to 1e-5, and seeding them moves it.
"""

import numpy as np
import pytest
import torch

from tests.test_torch_modules import nchw, randomize, to_nhwc, torch_threads  # noqa: F401 (autouse fixture)
from tests.test_torch_train import leaves
from tests.torch_att_maf_hyper import blocked_imports_test, seeded
from ultralytics_pro_tpu_torch.nn.modules import attention as A
from ultralytics_pro_tpu_torch.nn.modules import families as Fm
from ultralytics_pro_tpu_torch.nn.modules.reparam import GRN, UniRepLKNetBlock
from ultralytics_pro_tpu_torch.ops.deform import deform_conv2d
from ultralytics_pro_tpu_torch.utils.weights import jax_to_torch_state_dict, torch_state_dict_to_jax

TOL = 1e-5


def close(got, want, tol: float = TOL):
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=tol * np.abs(want).max(), rtol=0)


def _ja():
    from ultralytics_pro_tpu.nn.modules import attention

    return attention


def _jf():
    from ultralytics_pro_tpu.nn.modules import families

    return families


def _jr():
    from ultralytics_pro_tpu.nn.modules import reparam

    return reparam


# -- deform_conv2d ---------------------------------------------------------------------------

# (groups, Cin, Co, k, stride, padding, dilation, mask)
DEFORM = {
    "groups1_mask": (1, 6, 5, 3, 1, 1, 1, True),
    "groups1_stride2": (1, 6, 4, 3, 2, 1, 1, False),
    "depthwise_k5": (6, 6, 6, 5, 1, 2, 1, False),
    "depthwise_k7_d3": (6, 6, 6, 7, 1, 9, 3, True),
    "grouped": (2, 6, 4, 3, 1, 1, 1, True),
}


@pytest.mark.parametrize("case", list(DEFORM))
@pytest.mark.parametrize("offsets", ["random", "edges"])
def test_deform_conv2d_matches_jax(case, offsets):
    from ultralytics_pro_tpu.ops.deform import deform_conv2d as jdeform

    g, c, co, k, s, p, d, use_mask = DEFORM[case]
    h, w = 9, 7
    ho, wo = (h + 2 * p - d * (k - 1) - 1) // s + 1, (w + 2 * p - d * (k - 1) - 1) // s + 1
    rng = np.random.default_rng(5)
    x = rng.normal(0, 1, (2, h, w, c)).astype(np.float32)
    if offsets == "random":
        off = rng.normal(0, 2.0, (2, ho, wo, 2 * k * k)).astype(np.float32)
    else:  # whole pixels, and taps landing exactly on the last row and column, beyond them, and before 0
        off = rng.integers(-3, 4, (2, ho, wo, 2 * k * k)).astype(np.float32)
        off[:, :, :, 0::2] += np.where(rng.uniform(size=(2, ho, wo, k * k)) < 0.3, h - 1, 0)
        off[:, :, :, 1::2] += np.where(rng.uniform(size=(2, ho, wo, k * k)) < 0.3, w - 1 + 0.5, 0)
    weight = rng.normal(0, 0.3, (k, k, c // g, co)).astype(np.float32)
    mask = rng.uniform(0, 1, (2, ho, wo, k * k)).astype(np.float32) if use_mask else None
    bias = rng.normal(0, 0.3, (co,)).astype(np.float32)
    want = jdeform(x, off, weight, mask=mask, bias=bias, stride=s, padding=p, dilation=d, groups=g)
    got = deform_conv2d(nchw(x), nchw(off), torch.from_numpy(weight.transpose(3, 2, 0, 1)),
                        None if mask is None else nchw(mask), torch.from_numpy(bias), s, p, d, g)
    close(to_nhwc(got), want)
    if offsets == "edges":  # some taps sample outside the map: their corners add nothing
        ix = np.arange(wo)[None, :, None] * s - p + (np.arange(k * k) % k)[None, None, :] * d + off[0, 0:1, :, 1::2]
        assert (ix > w - 1).any() and (np.floor(ix) == w - 1).any()


def test_depthwise_deform_conv2d_with_other_outputs_raises_in_both():
    from ultralytics_pro_tpu.ops.deform import deform_conv2d as jdeform

    x = np.zeros((1, 5, 5, 4), np.float32)
    off = np.zeros((1, 5, 5, 18), np.float32)
    with pytest.raises(ValueError):
        jdeform(x, off, np.zeros((3, 3, 1, 8), np.float32), groups=4)
    with pytest.raises(ValueError, match="depth-wise"):
        deform_conv2d(nchw(x), nchw(off), torch.zeros(8, 1, 3, 3), groups=4)


# -- blocks -------------------------------------------------------------------------------

def _avg(k, s):
    return torch.nn.AvgPool2d(k, s)


# (JAX module factory, port module factory, input channels, map (h, w), input scale, NHWC in the port)
BLOCKS = {
    "BoT3": (lambda: _ja().BoT3(c2=32, n=2), lambda: A.BoT3(16, 32, 2), 16, (4, 5), 1.0, False),
    "BoT3_e": (lambda: _ja().BoT3(c2=32, e=0.25), lambda: A.BoT3(32, 32, 1, 0.25), 32, (3, 3), 1.0, False),
    "DCNv2": (lambda: _ja().DCNv2(c2=16), lambda: A.DCNv2(8, 16), 8, (9, 7), 1.0, False),
    "DCNv2_s2": (lambda: _ja().DCNv2(c2=8, s=2), lambda: A.DCNv2(8, 8, 3, 2), 8, (9, 8), 1.0, False),
    "C2f_DCN": (lambda: _ja().C2f_DCN(c2=32, n=2), lambda: A.C2f_DCN(16, 32, 2), 16, (8, 7), 1.0, False),
    "C2f_DCN_shortcut": (lambda: _ja().C2f_DCN(c2=16, shortcut=True), lambda: A.C2f_DCN(16, 16, 1, True), 16,
                         (6, 6), 1.0, False),
    "C3_DCN": (lambda: _ja().C3_DCN(c2=32, n=2), lambda: A.C3_DCN(16, 32, 2), 16, (8, 7), 1.0, False),
    "DeformConvDW": (lambda: _ja().DeformConvDW(k=5, d=1), lambda: A.DeformConvDW(8, 5, 1), 8, (9, 8), 1.0, False),
    "DeformConvDW_d3": (lambda: _ja().DeformConvDW(k=7, d=3), lambda: A.DeformConvDW(8, 7, 3), 8, (10, 9), 1.0,
                        False),
    "deformable_LKA": (lambda: _ja().deformable_LKA(), lambda: A.deformable_LKA(8), 8, (10, 9), 1.0, False),
    "deformable_LKA_Attention": (lambda: _ja().deformable_LKA_Attention(), lambda: A.deformable_LKA_Attention(8), 8,
                                 (10, 9), 1.0, False),
    "C2f_DLKA": (lambda: _ja().C2f_DLKA(c2=16, n=2), lambda: A.C2f_DLKA(8, 16, 2), 8, (8, 8), 1.0, False),
    "AVG": (lambda: _jf().AVG(), lambda: _avg(2, 2), 8, (8, 7), 1.0, False),
    "nn.AvgPool2d_8": (lambda: _jf().AVG(k=8, s=8), lambda: _avg(8, 8), 8, (17, 16), 1.0, False),
    "DepthBottleneckUni": (lambda: _jf().DepthBottleneckUni(c2=16, k=7, depth_e=3.0),
                           lambda: Fm.DepthBottleneckUni(16, 16, k=7, depth_e=3.0), 16, (8, 8), 1.0, False),
    "DepthBottleneckUni_widening": (lambda: _jf().DepthBottleneckUni(c2=16), lambda: Fm.DepthBottleneckUni(8, 16), 8,
                                    (6, 7), 1.0, False),
    "RepHMS_w2": (lambda: _jf().RepHMS(c2=32, width=2, depth=1, depth_e=3.0, k=3),
                  lambda: Fm.RepHMS(16, 32, 2, 1, 3.0, 3), 16, (8, 8), 1.0, False),
    "RepHMS_w3": (lambda: _jf().RepHMS(c2=32, width=3, depth=1, depth_e=3.0, k=5),
                  lambda: Fm.RepHMS(16, 32, 3, 1, 3.0, 5), 16, (8, 8), 1.0, False),
    "RepHMS_w3_d2": (lambda: _jf().RepHMS(c2=32, width=3, depth=2, depth_e=2.0, k=9),
                     lambda: Fm.RepHMS(16, 32, 3, 2, 2.0, 9), 16, (9, 9), 1.0, False),
    "MANet": (lambda: _jf().MANet(c2=32, n=2, shortcut=True, p=2, k=5),
              lambda: Fm.MANet(16, 32, 2, True, 2, 5), 16, (8, 7), 1.0, False),
    "MANet_default": (lambda: _jf().MANet(c2=16), lambda: Fm.MANet(16, 16), 16, (6, 6), 1.0, False),
    "HyperComputeModule": (lambda: _jf().HyperComputeModule(c2=16), lambda: Fm.HyperComputeModule(16), 16, (8, 8),
                           1.8, False),
    "GRN": (lambda: _jr().GRN(), lambda: GRN(16), 16, (5, 6), 1.0, True),
    "UniRepLKNetBlock": (lambda: _jr().UniRepLKNetBlock(k=5), lambda: UniRepLKNetBlock(16, 5), 16, (8, 7), 1.0,
                         False),
    "UniRepLKNetBlock_k3": (lambda: _jr().UniRepLKNetBlock(k=3), lambda: UniRepLKNetBlock(16, 3), 16, (6, 6), 1.0,
                            False),
}


def _bind(module, h: int, w: int):
    """Bind every MHSA of a port module to the map its JAX twin sizes by
    (BoT3's maps keep the input's size)."""
    for m in module.modules():
        if isinstance(m, A.MHSA):
            m.bind(h, w)
    return module


def _jax_variables(jm, x):
    import jax

    return seeded(randomize(jax.tree_util.tree_map(lambda a: np.zeros(a.shape, np.float32),
                                                   jax.eval_shape(lambda v: jm.init(jax.random.PRNGKey(0), v), x)),
                            2))


@pytest.mark.parametrize("mode", ["eval", "train"])
@pytest.mark.parametrize("case", list(BLOCKS))
def test_block_matches_jax(case, mode):
    make_jax, make, c1, (h, w), sd, channels_last = BLOCKS[case]
    x = np.random.default_rng(1).normal(0, sd, (2, h, w, c1)).astype(np.float32)
    jm, tm = make_jax(), _bind(make(), h, w)
    v = _jax_variables(jm, x)
    tm.load_state_dict(jax_to_torch_state_dict(v))  # strict
    xt = torch.from_numpy(x) if channels_last else nchw(x)
    out = (lambda t: t.detach().numpy()) if channels_last else to_nhwc
    if case == "HyperComputeModule":
        share = float(tm.incidence(xt.flatten(2).transpose(1, 2)).mean())
        assert 0.2 < share < 0.8, share
    if mode == "eval":
        want = jm.apply(v, x) if channels_last else jm.apply(v, x, train=False)
        with torch.no_grad():
            got = out(tm.eval()(xt))
        close(got, want)
        return
    if channels_last:  # GRN has no train mode
        return
    want, new = jm.apply(v, x, train=True, mutable=["batch_stats"])
    with torch.no_grad():
        got = out(tm.train()(xt))
    close(got, want)
    stats = {k: t for k, t in tm.state_dict().items() if k.endswith(("running_mean", "running_var"))}
    moved = dict(leaves(torch_state_dict_to_jax(stats).get("batch_stats", {})))
    assert moved.keys() == dict(leaves(new.get("batch_stats", {}))).keys()
    for k, w_ in leaves(new.get("batch_stats", {})):
        close(moved[k], w_)


def test_zero_initialised_parameters_hide_the_large_kernel_block_until_seeded():
    """UniRepLKNetBlock as built (GRN's gamma and beta 0, the layer scale
    1e-6) is its input to 1e-5 of the largest value, in both packages; the
    seeded values of the parity checks move it by much more."""
    import jax

    x = np.random.default_rng(4).normal(0, 1, (2, 6, 6, 16)).astype(np.float32)
    jm, tm = _jr().UniRepLKNetBlock(k=5), UniRepLKNetBlock(16, 5).eval()
    v = jm.init(jax.random.PRNGKey(0), x)
    assert float(np.abs(v["params"]["gamma"] - np.float32(1e-6)).max()) == 0.0
    assert not np.any(v["params"]["grn"]["gamma"]) and not np.any(v["params"]["grn"]["beta"])
    assert torch.all(tm.gamma == 1e-6) and not tm.grn.gamma.any() and not tm.grn.beta.any()
    close(np.asarray(jm.apply(v, x)), x)
    with torch.no_grad():
        close(to_nhwc(tm(nchw(x))), x)
    sv = _jax_variables(jm, x)
    assert float(np.abs(np.asarray(jm.apply(sv, x)) - x).max()) > 0.1 * np.abs(x).max()
    grn_only = {**sv, "params": {**sv["params"], "gamma": v["params"]["gamma"]}}
    assert float(np.abs(np.asarray(jm.apply(grn_only, x)) - x).max()) < 1e-4


test_models_run_with_jax_yaml_cv2_pil_blocked = blocked_imports_test(["yolov8n-att.yaml"])
