"""The port's RT-DETR training against the JAX package, on the CPU.

Modules of the slice, each held to its JAX counterpart on seeded numpy
inputs: the optimizer's parameter groups (`make_group_labels`), masked
attention (flax's `MultiHeadDotProductAttention`), the gradients of K2's
`msda_sample_fused` (`jax.grad` through `multi_scale_bilinear_sample(...,
use_pallas=False)`) and a numpy model of its backward kernel's arithmetic,
the decoder's train branch with denoising queries (its aux dict and the
parameter gradients of scalars of it, which place the stop-gradients),
`make_cdn_batch`, the Hungarian matcher (optax's), `DETRLoss` and
`RTDETRDetectionLoss`; then `RTDETRTrainer` against the JAX trainer on the
detect fixture set, and checkpoints both ways.

Tolerances, stated where they are checked: 1e-5 absolute for module outputs
and gradients of order 1 (XLA and PyTorch sum in different orders), 1e-5 of
the largest magnitude for parameter gradients, exact for the CDN queries and
the matched queries.

The trainer comparison runs with lr0 = 0 and no warmup, so the weights stay
where they start and every micro-batch compares the same model on fresh
data and fresh denoising noise: at random initialisation a trained run's
trajectory parts after its first optimizer step, even between the port's
own float32 and float64 runs. The port takes the JAX run's discrete
decisions (the decoder's top-k query selection and the matching), so a
near-tie decides nothing; where its own choices differ, they are checked to
be near-ties. The step's gradient is only piecewise smooth (a sampling
point crossing a pixel edge, a ReLU at its kink), so rounding moves it much
more than it moves the loss. The readings of the two trainer tests on this
fixture: the port's float32 run is 6e-6 (loss parts, relative) and 4e-4
and 1.5e-3 (momentum buffers: tree and worst leaf, rel_l2) from its
float64 run; the JAX run is 6e-5, 0.021 and 0.048 from it, and as far from
the port's float32 run. JAX_STEP_TOL and F64_STEP_TOL are set from these.
Whether the JAX distance is the JAX package's float32 rounding or a
difference of the two functions below the module tests' 1e-5 cannot be
told here: the JAX package computes in float32 under its modules' dtype
even with x64 on. The optimizer step is the one of
tests/test_torch_train.py, over the groups held here.
"""

import contextlib
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.conftest import FIXTURES
from tests.test_torch_modules import nchw, randomize, torch_threads  # noqa: F401 (autouse fixture)
from tests.test_torch_rtdetr import NARROW, carry
from tests.test_torch_train import leaves, same_images_as_jax
from ultralytics_pro_tpu_torch import RTDETR
from ultralytics_pro_tpu_torch.cfg import DEFAULT_CFG_DICT
from ultralytics_pro_tpu_torch.engine.trainer import BaseTrainer, load_pickle
from ultralytics_pro_tpu_torch.kernels import msda_cuda
from ultralytics_pro_tpu_torch.nn.modules import DeformableTransformerDecoderLayer, RTDETRDecoder
from ultralytics_pro_tpu_torch.nn.modules.transformer import MultiheadAttention
from ultralytics_pro_tpu_torch.nn.tasks import DetectionModel
from ultralytics_pro_tpu_torch.utils import detr_loss
from ultralytics_pro_tpu_torch.utils.weights import torch_key_to_flax, torch_state_dict_to_jax

ATOL = 1e-5
NC = 3
NARROW3 = {**NARROW, "nc": NC}
NEAR_TIE = 1e-3  # a matching cost or top-k score gap within the two frameworks' f32 noise (module docstring)
LEAF_FLOOR = 1e-8  # rel_l2: leaves below this share of the largest leaf's norm hold rounding only
JAX_STEP_TOL = {"tree": 0.05, "leaf": 0.1}  # the port's step against the JAX step (module docstring)
F64_STEP_TOL = {"loss": 2e-5, "tree": 2e-3, "leaf": 1e-2}  # the port's step against its float64 step
AUX_KEYS = ("dec_bboxes", "dec_scores", "enc_bboxes", "enc_scores", "dn_bboxes", "dn_scores")


def _rng(seed):
    return np.random.default_rng(seed)


def jnp_tree(tree):
    import jax.numpy as jnp

    return {k: jnp.asarray(v) for k, v in tree.items()}


def torch_tree(tree):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


def gt_batch(seed, b=3, g=4, nc=NC):
    """Padded ground truth: image 0 full, image 1 half, image 2 empty; one
    zero-area box in image 1 (the loss masks it as the JAX one does)."""
    rng = _rng(seed)
    mask = np.zeros((b, g), bool)
    mask[0], mask[1, : g // 2] = True, True
    cls = np.where(mask, rng.integers(0, nc, (b, g)), 0).astype(np.float32)
    bb = np.concatenate([rng.uniform(0.2, 0.8, (b, g, 2)), rng.uniform(0.05, 0.4, (b, g, 2))], -1).astype(np.float32)
    bb[1, 1, 2] = 0.0
    bb[~mask] = 0.0
    return {"cls": cls, "bboxes": bb, "mask_gt": mask}


def sigmoid(x):
    return (1 / (1 + np.exp(-x))).astype(np.float32)


# -- parameter groups ------------------------------------------------------------

def port_groups(model) -> dict:
    """{flax leaf path: optimizer group} of a BaseTrainer over model, through
    the weight carrier's names (an attention's packed in_proj rows as the
    query, key and value leaves)."""
    trainer = BaseTrainer.__new__(BaseTrainer)
    trainer.build_criterion = lambda: None
    BaseTrainer.__init__(trainer, model, {**DEFAULT_CFG_DICT, "batch": 2, "nbs": 8, "project": "unused"})
    got = {}
    for g, group in enumerate(trainer.optimizer.param_groups):
        for p in group["params"]:
            name = trainer.param_names[[q is p for q in trainer.params].index(True)]
            path, leaf, _ = torch_key_to_flax(name, p.ndim)
            if leaf.startswith("in_proj_"):
                for part in ("query", "key", "value"):
                    got[(*path, part, "kernel" if leaf == "in_proj_weight" else "bias")] = g
            else:
                got[(*path, leaf)] = g
    return got


@pytest.mark.parametrize("cfg", ["narrow_rtdetr", "yolov8n-seg.yaml", "yolov8n-pose.yaml", "yolov8n-obb.yaml",
                                 "yolov8n-cls.yaml"])
def test_param_groups_match_jax(cfg):
    """Decayed kernels and embeddings (0), BatchNorm and LayerNorm weights
    (1), every bias, attention's in_proj_bias among them (2), as the JAX
    trainer's `make_group_labels` labels flax's leaves; `denoising_class_embed`
    stays in group 0."""
    from ultralytics_pro_tpu.engine.trainer import make_group_labels

    from ultralytics_pro_tpu_torch.nn.tasks import guess_model_task, model_class_for, yaml_model_load

    y = dict(NARROW3) if cfg == "narrow_rtdetr" else yaml_model_load(cfg)
    model = model_class_for(guess_model_task(y))(y)
    want = {k: int(v) for k, v in leaves(make_group_labels(torch_state_dict_to_jax(model.state_dict())["params"]))}
    got = port_groups(model)
    assert got == want
    if cfg == "narrow_rtdetr":
        head = ("layers_27",)
        assert got[(*head, "denoising_class_embed")] == 0
        assert got[(*head, "decoder_layer_0", "self_attn", "query", "bias")] == 2
        assert got[(*head, "decoder_layer_0", "norm1", "scale")] == 1
        assert got[(*head, "enc_output_norm", "scale")] == 1


# -- masked attention ------------------------------------------------------------

def _jax_mha(c, nh):
    from flax import linen as nn

    class Wrap(nn.Module):
        @nn.compact
        def __call__(self, q, k, v, mask):
            return nn.MultiHeadDotProductAttention(num_heads=nh, qkv_features=c, out_features=c, name="ma")(
                q, k, v, mask=mask)

    return Wrap()


class _PortMHA(torch.nn.Module):
    def __init__(self, c, nh):
        super().__init__()
        self.ma = MultiheadAttention(c, nh)

    def forward(self, q, k, v, mask):
        return self.ma(q, k, v, mask)


@pytest.mark.parametrize("mask_kind", ["dn_blocks", "random_with_a_fully_masked_row"])
def test_masked_attention_matches_flax(mask_kind):
    """flax's mask semantics: True attends, a masked logit becomes the f32
    minimum (a row masked in full attends uniformly, where -inf would give
    NaN); outputs and input gradients within 1e-5."""
    import jax
    import jax.numpy as jnp

    rng = _rng(3)
    b, t, c, nh = 2, 14, 32, 4
    if mask_kind == "dn_blocks":
        mask = RTDETRDecoder.dn_attn_mask(8, 4, 6, "cpu").numpy()
    else:
        mask = rng.uniform(size=(1, nh, t, t)) < 0.6
        mask[0, 1, 3] = False
    q, k, v = (rng.normal(0, 1, (b, t, c)).astype(np.float32) for _ in range(3))
    jm, tm = _jax_mha(c, nh), _PortMHA(c, nh)
    variables = carry(jm, (q, k, v, mask), tm)
    w = rng.normal(0, 1, (b, t, c)).astype(np.float32)

    def jf(q, k, v):
        return jnp.sum(jm.apply(variables, q, k, v, mask) * w)

    ref = np.asarray(jm.apply(variables, q, k, v, mask))
    jg = jax.grad(jf, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = tm(tq, tk, tv, torch.from_numpy(mask))
    (out * torch.from_numpy(w)).sum().backward()
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=ATOL, rtol=0)
    for got, want in zip((tq.grad, tk.grad, tv.grad), jg):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_decoder_layer_with_attn_mask_matches_jax():
    from tests.test_torch_rtdetr import SHAPES, _decoder_inputs
    from ultralytics_pro_tpu.nn.modules.transformer import DeformableTransformerDecoderLayer as JLayer

    query, bbox, values = _decoder_inputs(31, q=14)
    qpos = _rng(32).normal(0, 1, query.shape).astype(np.float32)
    mask = RTDETRDecoder.dn_attn_mask(8, 4, 6, "cpu").numpy()
    jm = JLayer(d_model=32, n_heads=4, d_ffn=64, n_levels=3, n_points=4)
    tm = DeformableTransformerDecoderLayer(32, 4, 64, 3, 4)
    v = carry(jm, (query, bbox, values, SHAPES, qpos, mask), tm)
    ref = np.asarray(jm.apply(v, query, bbox, values, SHAPES, qpos, mask))
    with torch.no_grad():
        got = tm(torch.from_numpy(query), torch.from_numpy(bbox), torch.from_numpy(np.concatenate(values, 1)),
                 SHAPES, torch.from_numpy(qpos), torch.from_numpy(mask)).numpy()
        unmasked = tm(torch.from_numpy(query), torch.from_numpy(bbox), torch.from_numpy(np.concatenate(values, 1)),
                      SHAPES, torch.from_numpy(qpos)).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
    assert np.abs(got - unmasked).max() > 1e-2  # the mask is applied


# -- K2's gradient -----------------------------------------------------------------

K2_GRAD_CASES = {
    "three_levels_outside": dict(b=2, q=7, nh=4, hd=8, shapes=((6, 8), (3, 4), (2, 2)), p=4, lo=-0.4, hi=1.4),
    "hd40_two_levels": dict(b=1, q=5, nh=3, hd=40, shapes=((5, 7), (3, 4)), p=3, lo=-1.0, hi=2.0),
}


def k2_grad_inputs(seed, b, q, nh, hd, shapes, p, lo, hi):
    rng = _rng(seed)
    v = sum(h * w for h, w in shapes)
    value = rng.normal(size=(b, v, nh, hd)).astype(np.float32)
    locs = rng.uniform(lo, hi, (b, q, nh, len(shapes), p, 2)).astype(np.float32)
    attn = rng.uniform(0, 1, (b, q, nh, len(shapes), p)).astype(np.float32)
    grad_out = rng.normal(size=(b, q, nh * hd)).astype(np.float32)
    return value, list(shapes), locs, attn / attn.sum((-1, -2), keepdims=True), grad_out


@pytest.mark.parametrize("case", list(K2_GRAD_CASES))
def test_msda_gradients_match_jax(case):
    """grad of <msda_sample_fused(value, locs, attn), grad_out> for value,
    locs and attn on the CPU (the plain version's autograd through the
    wrapper, and msda_sample_fused_backward_plain, the plain backward that
    the card's checks hold the kernel to) against jax.grad through multi_scale_bilinear_sample(use_pallas=False),
    points outside the maps included, within 1e-5 of each gradient's
    largest magnitude."""
    import jax
    import jax.numpy as jnp

    from ultralytics_pro_tpu.nn.modules.transformer import multi_scale_bilinear_sample

    value, shapes, locs, attn, grad_out = k2_grad_inputs(5, **K2_GRAD_CASES[case])
    sizes = np.cumsum([0] + [h * w for h, w in shapes])

    def jf(value, locs, attn):
        vals = [value[:, a:b] for a, b in zip(sizes[:-1], sizes[1:])]
        return jnp.sum(multi_scale_bilinear_sample(vals, shapes, locs, attn, use_pallas=False) * grad_out)

    want = jax.grad(jf, argnums=(0, 1, 2))(value, locs, attn)
    leaves_ = [torch.from_numpy(a).requires_grad_(True) for a in (value, locs, attn)]
    out = msda_cuda.msda_sample_fused(leaves_[0], shapes, leaves_[1], leaves_[2])
    out.backward(torch.from_numpy(grad_out))
    direct = msda_cuda.msda_sample_fused_backward_plain(torch.from_numpy(value), shapes, torch.from_numpy(locs),
                                                        torch.from_numpy(attn), torch.from_numpy(grad_out))
    for name, got, alt, w in zip(("value", "locs", "attn"), (t.grad for t in leaves_), direct, want):
        w = np.asarray(w)
        assert np.abs(w).max() > 0, name
        np.testing.assert_allclose(got.numpy(), w, atol=1e-5 * np.abs(w).max(), rtol=0, err_msg=name)
        np.testing.assert_array_equal(alt.numpy(), got.numpy(), err_msg=name)


def kernel_model_backward(value, shapes, locs, attn, grad_out):
    """numpy model of csrc/msda_sample.cu's backward kernel, point by point:
    the forward's corner math (f32, round to nearest), dot_k of each corner
    inside the map, grad_value += cw * attn * grad_out, grad_attn = sum_k
    cw_k dot_k, grad_locs = attn * W (H) * the dx (dy) slope of the corner
    weights. Keep it in step with the kernel."""
    f32 = np.float32
    b, q, nh, nl, p, _ = locs.shape
    hd = value.shape[-1]
    g = grad_out.reshape(b, q, nh, hd)
    gv, gl, ga = np.zeros_like(value), np.zeros_like(locs), np.zeros_like(attn)
    starts = np.cumsum([0] + [h * w for h, w in shapes])
    for bi, qi, h, li, pi in np.ndindex(b, q, nh, nl, p):
        hl, wl = shapes[li]
        x = f32(f32(locs[bi, qi, h, li, pi, 0] * f32(wl)) - f32(0.5))
        y = f32(f32(locs[bi, qi, h, li, pi, 1] * f32(hl)) - f32(0.5))
        a = attn[bi, qi, h, li, pi]
        x0, y0 = np.floor(x), np.floor(y)
        dx, dy = f32(x - x0), f32(y - y0)
        cw = [f32((1 - dx) * (1 - dy)), f32(dx * (1 - dy)), f32((1 - dx) * dy), f32(dx * dy)]
        d = [f32(0)] * 4
        for k, (cx, cy) in enumerate(((x0, y0), (x0 + 1, y0), (x0, y0 + 1), (x0 + 1, y0 + 1))):
            if 0 <= cx <= wl - 1 and 0 <= cy <= hl - 1:
                row = starts[li] + int(cy) * wl + int(cx)
                d[k] = f32(value[bi, row, h] @ g[bi, qi, h])
                gv[bi, row, h] += f32(cw[k] * a) * g[bi, qi, h]
        ga[bi, qi, h, li, pi] = cw[0] * d[0] + cw[1] * d[1] + cw[2] * d[2] + cw[3] * d[3]
        gl[bi, qi, h, li, pi, 0] = ((1 - dy) * (d[1] - d[0]) + dy * (d[3] - d[2])) * a * wl
        gl[bi, qi, h, li, pi, 1] = ((1 - dx) * (d[2] - d[0]) + dx * (d[3] - d[1])) * a * hl
    return gv, gl, ga


@pytest.mark.parametrize("case", list(K2_GRAD_CASES))
def test_backward_kernel_model_matches_plain_autograd(case):
    """The backward kernel's arithmetic, modelled in numpy, against the
    plain version's autograd within 1e-5 of each gradient's largest
    magnitude (the kernel sums grad_value with atomics, in no fixed order)."""
    value, shapes, locs, attn, grad_out = k2_grad_inputs(6, **K2_GRAD_CASES[case])
    want = msda_cuda.msda_sample_fused_backward_plain(*(torch.from_numpy(a) for a in (value,)), shapes,
                                                      torch.from_numpy(locs), torch.from_numpy(attn),
                                                      torch.from_numpy(grad_out))
    for name, got, w in zip(("value", "locs", "attn"), kernel_model_backward(value, shapes, locs, attn, grad_out),
                            want):
        w = w.numpy()
        np.testing.assert_allclose(got, w, atol=1e-5 * np.abs(w).max(), rtol=0, err_msg=name)


def test_msda_wrapper_takes_grad_on_cpu_and_counts_no_launch():
    """On CPU tensors that require grad the wrapper is the plain version,
    differentiable, and launches nothing."""
    value, shapes, locs, attn, _ = k2_grad_inputs(7, **K2_GRAD_CASES["three_levels_outside"])
    before = (msda_cuda.launches, msda_cuda.backward_launches)
    v = torch.from_numpy(value).requires_grad_(True)
    msda_cuda.msda_sample_fused(v, shapes, torch.from_numpy(locs), torch.from_numpy(attn)).sum().backward()
    assert v.grad is not None and bool(torch.isfinite(v.grad).all())
    assert (msda_cuda.launches, msda_cuda.backward_launches) == before


# -- the decoder's train branch ------------------------------------------------------

def make_dn(gt, num_dn, seed=0, nc=NC):
    return detr_loss.make_cdn_batch(gt["cls"], gt["bboxes"], gt["mask_gt"], nc=nc, num_dn=num_dn,
                                    rng=_rng(seed))


@pytest.fixture(scope="module")
def decoder_pair():
    """A JAX and a port RTDETRDecoder (hd 32, 2 layers, nc 3) with one set of
    seeded weights, seeded feature maps and denoising queries for 3 images."""
    import jax

    from ultralytics_pro_tpu.nn.modules.head import RTDETRDecoder as JDecoder

    rng = _rng(40)
    chs, shapes = (16, 24, 32), [(8, 8), (4, 4), (2, 2)]
    feats = [rng.normal(0, 1, (3, h, w, c)).astype(np.float32) for (h, w), c in zip(shapes, chs)]
    jm = JDecoder(nc=NC, hd=32, ndl=2)
    tm = RTDETRDecoder(nc=NC, ch=chs, hd=32, ndl=2)
    variables = carry(jm, (feats,), tm)
    gt = gt_batch(41)
    dn = make_dn(gt, num_dn=8)

    @jax.jit
    def japply(params, feats, dn):
        aux, _ = jm.apply({"params": params, "batch_stats": variables["batch_stats"]}, feats, train=True, dn=dn,
                          mutable=["batch_stats"])
        return aux

    return japply, variables, tm, feats, gt, dn


def port_aux(tm, feats, dn):
    tm.train()
    tm.zero_grad()
    return tm([nchw(f) for f in feats], dn=None if dn is None else torch_tree(dn))


def test_decoder_train_branch_aux_matches_jax(decoder_pair):
    """In train mode with dn the decoder returns the aux dict alone: the JAX
    keys and shapes (t_dn = 2 groups x 2G = 16 denoising queries split off),
    values within 1e-5; without dn no dn keys."""
    japply, variables, tm, feats, gt, dn = decoder_pair
    ref = japply(variables["params"], feats, jnp_tree(dn))
    aux = port_aux(tm, feats, dn)
    assert isinstance(aux, dict) and set(AUX_KEYS) <= set(aux)
    assert tuple(aux["dn_bboxes"].shape) == (2, 3, 16, 4) and tuple(aux["dec_scores"].shape) == (2, 3, 84, NC)
    for k in AUX_KEYS:
        np.testing.assert_allclose(aux[k].detach().numpy(), np.asarray(ref[k]), atol=ATOL, rtol=0, err_msg=k)
    plain = port_aux(tm, feats, None)
    assert isinstance(plain, dict) and "dn_bboxes" not in plain
    np.testing.assert_allclose(plain["enc_scores"].detach().numpy(), aux["enc_scores"].detach().numpy(), atol=0)
    tm.eval()
    y, eval_aux = tm([nchw(f) for f in feats], dn=torch_tree(dn))  # dn is a train-mode input only
    assert tuple(y.shape) == (3, 84, 4 + NC) and "dn_bboxes" not in eval_aux


@pytest.mark.parametrize("key", [*AUX_KEYS, "all"])
def test_decoder_train_branch_gradients_match_jax(decoder_pair, key):
    """The parameter gradients of sum(aux[key] * W) (seeded W) within 1e-5 of
    the largest: this places the stop-gradients as the JAX decoder does.
    The selected encoder rows start the queries detached, each layer samples
    around detached boxes and detaches its output boxes, but layer 0's
    query position and box logit read the encoder's boxes undetached, so
    dec_bboxes reach enc_bbox_head; denoising_class_embed gets the dn
    queries' gradients."""
    import jax
    import jax.numpy as jnp

    japply, variables, tm, feats, gt, dn = decoder_pair
    keys = AUX_KEYS if key == "all" else (key,)
    aux = port_aux(tm, feats, dn)
    weights = {k: _rng(len(k)).normal(size=tuple(aux[k].shape)).astype(np.float32) for k in keys}
    sum(((aux[k] * torch.from_numpy(w)).sum() for k, w in weights.items())).backward()

    def jscalar(params):
        ref = japply(params, feats, jnp_tree(dn))
        return sum(jnp.sum(ref[k] * w) for k, w in weights.items())

    want = dict(leaves(jax.tree.map(np.asarray, jax.grad(jscalar)(variables["params"]))))
    got = dict(leaves(torch_state_dict_to_jax({n: torch.zeros_like(p) if p.grad is None else p.grad
                                               for n, p in tm.named_parameters()})["params"]))
    assert got.keys() == want.keys()
    scale = max(np.abs(w).max() for w in want.values())
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, atol=1e-5 * scale, rtol=0, err_msg="/".join(k))
    if key == "dec_bboxes":
        assert np.abs(want[("enc_bbox_head", "layers_2", "kernel")]).max() > 1e-3 * scale
    if key in ("dn_bboxes", "dn_scores"):
        assert np.abs(want[("denoising_class_embed",)]).max() > 0


# -- CDN queries, matcher, losses ------------------------------------------------------

@pytest.mark.parametrize("g,num_dn", [(4, 8), (4, 100), (6, 4)])
def test_make_cdn_batch_matches_jax_bit_for_bit(g, num_dn):
    from ultralytics_pro_tpu.utils.detr_loss import make_cdn_batch as jmake

    gt = gt_batch(50 + g, g=g)
    got = make_dn(gt, num_dn, seed=9)
    want = jmake(gt["cls"], gt["bboxes"], gt["mask_gt"], nc=NC, num_dn=num_dn, rng=_rng(9))
    ng = max(1, num_dn // g)
    assert got["cls"].shape == (3, ng, 2 * g) and got["bbox_logit"].shape == (3, ng, 2 * g, 4)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    assert (got["cls"][2] == NC).all()  # an image without objects: every slot the no-object row


def preds_for(seed, layers=2, b=3, q=20, t_dn=0, nc=NC):
    rng = _rng(seed)
    out = {"dec_bboxes": sigmoid(rng.normal(0, 1, (layers, b, q, 4))),
           "dec_scores": rng.normal(0, 2, (layers, b, q, nc)).astype(np.float32),
           "enc_bboxes": sigmoid(rng.normal(0, 1, (b, q, 4))),
           "enc_scores": rng.normal(0, 2, (b, q, nc)).astype(np.float32)}
    if t_dn:
        out["dn_bboxes"] = sigmoid(rng.normal(0, 1, (layers, b, t_dn, 4)))
        out["dn_scores"] = rng.normal(0, 2, (layers, b, t_dn, nc)).astype(np.float32)
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_matcher_matches_optax(seed):
    """Each real ground truth's matched query equals the JAX matcher's (optax
    Hungarian with padded columns at BIG); padded slots take distinct queries
    that no real one took, as there (the loss masks them)."""
    import jax.numpy as jnp

    from ultralytics_pro_tpu.utils.detr_loss import HungarianMatcher as JMatcher

    p, gt = preds_for(60 + seed, q=12), gt_batch(61 + seed, g=6)
    mask = gt["mask_gt"].astype(np.float32)
    got = detr_loss.HungarianMatcher()(*(torch.from_numpy(a) for a in (p["enc_bboxes"], p["enc_scores"],
                                                                       gt["bboxes"], gt["cls"], mask))).numpy()
    want = np.asarray(JMatcher()(*(jnp.asarray(a) for a in (p["enc_bboxes"], p["enc_scores"], gt["bboxes"],
                                                           gt["cls"], mask))))
    real = mask > 0
    np.testing.assert_array_equal(got[real], want[real])
    for i in range(got.shape[0]):
        assert len(set(got[i])) == got.shape[1] and ((0 <= got[i]) & (got[i] < 12)).all()


@pytest.mark.parametrize("with_dn", [False, True])
def test_rtdetr_loss_matches_jax(with_dn):
    """RTDETRDetectionLoss (DETRLoss over 2 layers and the encoder, plus the
    denoising queries' loss with dn) against the JAX criterion on the same
    predictions: total and parts within 1e-5 relative, and the gradients of
    the total for every prediction within 1e-5 of each one's largest."""
    import jax
    import jax.numpy as jnp

    from ultralytics_pro_tpu.utils.detr_loss import RTDETRDetectionLoss as JLoss

    gt = gt_batch(70)
    preds = preds_for(71, t_dn=16 if with_dn else 0)

    def jf(p):
        return JLoss(NC)(p, jnp_tree(gt), (64, 64))

    (jt, jparts), jg = jax.value_and_grad(jf, has_aux=True)(jnp_tree(preds))
    tp = {k: torch.from_numpy(a).requires_grad_(True) for k, a in preds.items()}
    total, parts = detr_loss.RTDETRDetectionLoss(NC)(tp, torch_tree(gt), (64, 64))
    total.backward()
    assert list(parts) == ["cls", "bbox", "giou", *(["dn_cls", "dn_bbox", "dn_giou"] if with_dn else [])]
    assert sorted(parts) == sorted(jparts)
    assert float(total) == pytest.approx(float(jt), rel=1e-5)
    for k in jparts:
        assert float(parts[k]) == pytest.approx(float(jparts[k]), rel=1e-5), k
    for k in preds:
        w = np.asarray(jg[k])
        np.testing.assert_allclose(tp[k].grad.numpy(), w, atol=1e-5 * np.abs(w).max(), rtol=0, err_msg=k)


def test_detr_loss_solves_every_layer_in_one_host_trip(monkeypatch):
    """DETRLoss copies the costs of every decoder layer and the encoder to
    the host once a step; its parts equal the JAX DETRLoss's."""
    import jax.numpy as jnp

    from ultralytics_pro_tpu.utils.detr_loss import DETRLoss as JDETRLoss

    gt, preds = gt_batch(80), preds_for(81, layers=3)
    mask = gt["mask_gt"].astype(np.float32)
    calls = []
    solve = detr_loss.HungarianMatcher.solve
    monkeypatch.setattr(detr_loss.HungarianMatcher, "solve",
                        staticmethod(lambda cost, m: calls.append(tuple(cost.shape)) or solve(cost, m)))
    args = ("dec_bboxes", "dec_scores")
    got = detr_loss.DETRLoss(NC)(*(torch.from_numpy(preds[k]) for k in args), torch.from_numpy(gt["bboxes"]),
                                 torch.from_numpy(gt["cls"]), torch.from_numpy(mask),
                                 enc_bboxes=torch.from_numpy(preds["enc_bboxes"]),
                                 enc_scores=torch.from_numpy(preds["enc_scores"]))
    want = JDETRLoss(NC)(*(jnp.asarray(preds[k]) for k in args), jnp.asarray(gt["bboxes"]), jnp.asarray(gt["cls"]),
                         jnp.asarray(mask), enc_bboxes=jnp.asarray(preds["enc_bboxes"]),
                         enc_scores=jnp.asarray(preds["enc_scores"]))
    assert calls == [(4, 3, 20, 4)]
    for k in want:
        assert float(got[k]) == pytest.approx(float(want[k]), rel=1e-5), k


# -- the trainer ---------------------------------------------------------------------------

TRAIN_KW = dict(epochs=1, imgsz=64, batch=2, nbs=8, workers=2, max_gt=4, num_dn=8, warmup_epochs=0.0)
LOSS_PARTS = ["cls", "bbox", "giou", "dn_cls", "dn_bbox", "dn_giou"]


@pytest.fixture(scope="module")
def data_yaml(tmp_path_factory) -> Path:
    """The detect fixture set copied (the JAX loader writes a label cache), train = val."""
    root = shutil.copytree(Path(FIXTURES) / "torch_val_synth", tmp_path_factory.mktemp("rtdetr_train") / "set")
    (root / "train.yaml").write_text("train: images/val\nval: images/val\nnames:\n  0: a\n  1: b\n  2: c\n")
    return root / "train.yaml"


@contextlib.contextmanager
def recorded_jax(jdl, monkeypatch, seed: int):
    """The JAX trainer's per-micro-batch loss parts and discrete decisions:
    the decoder's query selection (its top-k over (B, A) scores) and the
    matcher's rows, one call a layer. Its denoising noise comes from a
    generator seeded as the port's (the JAX trainer's own is unseeded): the
    test, not the JAX package, passes it through make_cdn_batch."""
    import jax

    from ultralytics_pro_tpu.engine import trainer as jtrainer

    rec = {"parts": [], "rows": [], "topk": []}
    rng = _rng(seed)
    make = jdl.make_cdn_batch
    monkeypatch.setattr(jdl, "make_cdn_batch", lambda *a, **k: make(*a, **k, rng=rng))
    match = jdl.HungarianMatcher.__call__

    def jmatch(self, *a):
        rows = match(self, *a)
        jax.debug.callback(lambda r: rec["rows"].append(np.asarray(r)), rows, ordered=True)
        return rows

    monkeypatch.setattr(jdl.HungarianMatcher, "__call__", jmatch)
    top_k = jax.lax.top_k

    def jtop_k(x, k):
        vals, idx = top_k(x, k)
        if x.ndim == 2:
            jax.debug.callback(lambda i: rec["topk"].append(np.array(i)), idx, ordered=True)
        return vals, idx

    monkeypatch.setattr(jax.lax, "top_k", jtop_k)
    build = jtrainer.BaseTrainer.build_train_step

    def jbuild(self):
        step = build(self)

        def recorded(state, batch, *a):
            out = step(state, batch, *a)
            rec["parts"].append({k: float(v) for k, v in out[2].items()})
            return out

        return recorded

    monkeypatch.setattr(jtrainer.BaseTrainer, "build_train_step", jbuild)
    yield rec


@contextlib.contextmanager
def replaying(jrec: dict):
    """A port run's per-micro-batch loss parts and its own decisions, while
    it takes the JAX run's (jrec): each micro-batch's query selection and
    matching, so both runs go on from the same discrete decisions. The port's
    own choices are kept: its matched rows with their costs, and the score
    gaps where its top-k differs."""
    from ultralytics_pro_tpu_torch.engine import trainer as ptrainer
    from ultralytics_pro_tpu_torch.nn.modules import head

    rec = {"parts": [], "rows": [], "masks": [], "costs": [], "topk": [], "topk_gaps": []}
    pstep, solve, topk = ptrainer.BaseTrainer.step, detr_loss.HungarianMatcher.solve, head._topk

    def step(self, *a):
        out = pstep(self, *a)
        rec["parts"].append({k: float(v) for k, v in out[1].items()})
        return out

    def psolve(cost, mask):
        rows = solve(cost, mask)
        i, nl = len(rec["rows"]), rows.shape[0]
        rec["rows"].append(rows.numpy())
        rec["masks"].append(mask.numpy() > 0)
        rec["costs"].append(cost.numpy())
        return torch.from_numpy(np.stack(jrec["rows"][nl * i: nl * (i + 1)])).to(rows)

    def ptopk(scores, k):
        vals, idx = topk(scores, k)
        want = torch.from_numpy(jrec["topk"][len(rec["topk"])]).to(idx)
        rec["topk"].append(idx.numpy())
        differ = idx != want
        if bool(differ.any()):
            rec["topk_gaps"].append(float((vals - scores.gather(-1, want))[differ].abs().max()))
        return scores.gather(-1, want), want

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ptrainer.BaseTrainer, "step", step)
        mp.setattr(detr_loss.HungarianMatcher, "solve", staticmethod(psolve))
        mp.setattr(head, "_topk", ptopk)
        yield rec


@pytest.fixture(scope="module")
def trained_pair(data_yaml, tmp_path_factory):
    """RTDETR(NARROW, nc 3) trained by both packages from the port's seeded
    weights, lr0 = 0 (see the module docstring), on the same pixels and the
    same denoising noise, the port replaying the JAX run's decisions; and
    the port's run again with the model and images in float64. Returns
    (port facade, JAX facade, float64 port facade, records)."""
    import ultralytics_pro_tpu.utils.detr_loss as jdl
    from ultralytics_pro_tpu.models.rtdetr import RTDETR as JRTDETR
    from ultralytics_pro_tpu.nn.modules import conv as jconv
    from ultralytics_pro_tpu_torch.models.rtdetr import RTDETRTrainer

    root = tmp_path_factory.mktemp("rtdetr_runs")
    port, port64 = RTDETR(dict(NARROW3), device="cpu"), RTDETR(dict(NARROW3), device="cpu")
    port64.model.to(torch.float64)
    jr = JRTDETR(dict(NARROW3))
    jr.model.variables = torch_state_dict_to_jax(port.model.state_dict())
    saved = jconv.BN_FAST_VARIANCE[0]
    jconv.BN_FAST_VARIANCE[0] = False
    rec = {}
    with pytest.MonkeyPatch.context() as mp, recorded_jax(jdl, mp, seed=0) as rec["jax"]:
        try:
            jr.train(data=str(data_yaml), project=str(root / "jax"), device=1, lr0=0.0, **TRAIN_KW)
        finally:
            jconv.BN_FAST_VARIANCE[0] = saved
    put = RTDETRTrainer.put_batch
    with same_images_as_jax():
        with replaying(rec["jax"]) as rec["port"]:
            port.train(data=str(data_yaml), project=str(root / "port"), lr0=0.0, **TRAIN_KW)
        with replaying(rec["jax"]) as rec["port64"], pytest.MonkeyPatch.context() as mp:
            mp.setattr(RTDETRTrainer, "put_batch", lambda self, b: {**(o := put(self, b)),
                                                                     "img": o["img"].double()})
            port64.train(data=str(data_yaml), project=str(root / "port64"), lr0=0.0, **TRAIN_KW)
    return port, jr, port64, rec


def rel_l2(got: dict, want: dict):
    """Two flax trees: the whole tree's relative L2 distance, and the
    largest leaf's with its path, over the leaves whose norm in want is at
    least LEAF_FLOOR of the largest leaf's. Below it sit the gradients that
    are 0 but for rounding: attention's key biases (softmax ignores a shift
    of its logits) and a few norm biases whose shift later layers cancel."""
    got, want = dict(leaves(got)), dict(leaves(want))
    assert got.keys() == want.keys()
    norm = {k: float(np.linalg.norm(w)) for k, w in want.items()}
    dist = {k: float(np.linalg.norm(np.asarray(got[k], np.float64) - w)) for k, w in want.items()}
    top = max(norm.values())
    tree = (sum(d * d for d in dist.values()) / sum(n * n for n in norm.values())) ** 0.5
    return tree, max((dist[k] / norm[k], k) for k in want if norm[k] >= LEAF_FLOOR * top)


def check_decisions(rec: dict, jrec: dict, n: int):
    """The port's own top-k and matching, where they differ from the JAX
    run's, differ at near-ties: the JAX choice within NEAR_TIE of the port's
    own under the port's own scores and costs (padded slots take any
    query)."""
    assert len(rec["topk"]) == n and all(g <= NEAR_TIE for g in rec["topk_gaps"]), rec["topk_gaps"]
    jrows = np.stack(jrec["rows"]).reshape(n, 3, *jrec["rows"][0].shape)
    prows = np.stack(rec["rows"])
    assert prows.shape == jrows.shape
    for i in range(n):
        cost, real = rec["costs"][i], rec["masks"][i]
        gaps = [float(cost[li, bi, jrows[i, li, bi, g], g].sum() - cost[li, bi, prows[i, li, bi, g], g].sum())
                for li, bi in np.ndindex(*prows.shape[1:3]) for g in [np.flatnonzero(real[bi])]
                if not np.array_equal(prows[i, li, bi, g], jrows[i, li, bi, g])]
        assert all(g <= NEAR_TIE for g in gaps), (i, gaps)


def test_rtdetr_trainer_matches_jax_step_for_step(trained_pair):
    """8 micro-batches of 2 images, accumulate 4 (2 optimizer steps at lr0
    0), the same batches, denoising noise and discrete decisions on both
    sides (the port takes the JAX run's query selection and matching; where
    its own differ, they differ at near-ties). Per micro-batch every loss
    part within 1e-4 relative. After the run: ema_updates, opt_steps and
    accumulate equal, the weights unchanged on both sides, EMA equal to them
    within 1e-6, BN statistics within 1e-4 of the tree's largest magnitude,
    and the momentum buffers (the accumulated gradients) within JAX_STEP_TOL
    (rel_l2: the tree, and every leaf against its own norm). The JAX step is
    the further of the two from the port's float64 step (module docstring,
    and the next test)."""
    port, jr, _, rec = trained_pair
    tp, tj = port.trainer, jr.trainer
    assert (tp.accumulate, tp.opt_steps) == (tj.accumulate, tj.opt_steps) == (4, 2)
    n = 8
    assert len(rec["port"]["parts"]) == len(rec["jax"]["parts"]) == n
    check_decisions(rec["port"], rec["jax"], n)
    for i, (got, want) in enumerate(zip(rec["port"]["parts"], rec["jax"]["parts"])):
        assert list(got) == LOSS_PARTS and sorted(want) == sorted(LOSS_PARTS)
        assert all(got[k] == pytest.approx(want[k], rel=1e-4) for k in LOSS_PARTS), (i, got, want)
    assert list(tp.loss_history[0]) == LOSS_PARTS

    cp, cj = load_pickle(tp.wdir / "last.ckpt"), load_pickle(tj.wdir / "last.ckpt")
    assert cp["ema_updates"] == cj["ema_updates"] == 2
    start = torch_state_dict_to_jax(RTDETR(dict(NARROW3), device="cpu").model.state_dict())["params"]
    for name, tree in (("port", cp), ("jax", cj)):
        for k, w in leaves(start):
            np.testing.assert_array_equal(dict(leaves(tree["params"]))[k], w, err_msg=f"{name} {k}")
            np.testing.assert_allclose(dict(leaves(tree["ema"]))[k], w, rtol=1e-6, atol=1e-7, err_msg=f"{name} {k}")
    got, want = dict(leaves(cp["batch_stats"])), dict(leaves(cj["batch_stats"]))
    scale = max(np.abs(w).max() for w in want.values())
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, atol=1e-4 * scale, rtol=0, err_msg=f"batch_stats {k}")
    tree, (leaf, where) = rel_l2(cp["momentum_buffer"], cj["momentum_buffer"])
    assert tree <= JAX_STEP_TOL["tree"] and leaf <= JAX_STEP_TOL["leaf"], (tree, leaf, where)


def test_rtdetr_port_step_matches_its_float64_step(trained_pair):
    """The port's run against the same run with the model and images in
    float64 (the same decisions, taken from the JAX run): every loss part of
    every micro-batch within F64_STEP_TOL["loss"] relative, BN statistics
    within 1e-5 of the tree's largest magnitude, and the momentum buffers
    within F64_STEP_TOL (rel_l2): the port's float32 arithmetic itself, on
    the narrow model (rtdetr-l's step: tools/torch_rtdetr_step_precision.py)."""
    port, _, port64, rec = trained_pair
    assert len(rec["port64"]["parts"]) == 8
    for i, (got, want) in enumerate(zip(rec["port"]["parts"], rec["port64"]["parts"])):
        assert all(got[k] == pytest.approx(want[k], rel=F64_STEP_TOL["loss"]) for k in LOSS_PARTS), (i, got, want)
    c32, c64 = (load_pickle(f.trainer.wdir / "last.ckpt") for f in (port, port64))
    got, want = dict(leaves(c32["batch_stats"])), dict(leaves(c64["batch_stats"]))
    scale = max(np.abs(w).max() for w in want.values())
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, atol=1e-5 * scale, rtol=0, err_msg=f"batch_stats {k}")
    tree, (leaf, where) = rel_l2(c32["momentum_buffer"], c64["momentum_buffer"])
    assert tree <= F64_STEP_TOL["tree"] and leaf <= F64_STEP_TOL["leaf"], (tree, leaf, where)


@pytest.fixture(scope="module")
def port_run(data_yaml, tmp_path_factory):
    """RTDETR(NARROW).train on the CPU with the defaults (lr0 0.01), one epoch."""
    port = RTDETR(dict(NARROW), device="cpu")
    port.train(data=str(data_yaml), project=str(tmp_path_factory.mktemp("rtdetr_port")), epochs=1, imgsz=64,
               batch=2, nbs=8, workers=2, max_gt=4, num_dn=8)
    return port


def test_rtdetr_train_runs_and_writes_its_run(port_run):
    """RTDETR.train no longer raises: the model is rebuilt at the set's nc 3,
    trains with the denoising queries (6 parts), runs no epoch-end val (as
    the JAX RT-DETR trainer), writes results.csv and weights/last.ckpt in the
    JAX layout, and leaves the EMA parameters on the model in eval mode."""
    tr = port_run.trainer
    assert port_run.model.nc == NC and not port_run.model.training
    assert list(tr.loss_history[0]) == LOSS_PARTS and all(np.isfinite(list(tr.loss_history[0].values())))
    assert tr.last_fitness is None and tr.opt_steps > 0  # warmup (3 epochs) ramps accumulate from 1
    ckpt = load_pickle(tr.wdir / "last.ckpt")
    assert {"params", "batch_stats", "ema", "momentum_buffer", "ema_updates", "train_args", "model_yaml"} <= set(ckpt)
    assert ckpt["ema_updates"] == tr.opt_steps
    assert ckpt["model_yaml"]["nc"] == NC and ckpt["train_args"]["num_dn"] == 8
    header = (tr.save_dir / "results.csv").read_text().splitlines()[0]
    assert all(f"train/{k}" in header for k in LOSS_PARTS)
    on_model = torch_state_dict_to_jax(port_run.model.state_dict())["params"]
    for k, w in leaves(ckpt["ema"]):
        np.testing.assert_array_equal(dict(leaves(on_model))[k], w)


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_rtdetr_checkpoints_load_both_ways(port_run, trained_pair, direction):
    """A checkpoint written by either package loads in the other's RTDETR
    facade and predicts the same on two seeded images (eval mode, EMA
    parameters): boxes within 1e-2 px and scores within 1e-4, as
    tests/test_torch_rtdetr.py holds predict."""
    from ultralytics_pro_tpu.models.rtdetr import RTDETR as JRTDETR

    path = port_run.trainer.wdir / "last.ckpt" if direction == "port_to_jax" else \
        trained_pair[1].trainer.wdir / "last.ckpt"
    rng = _rng(90)
    imgs = [rng.integers(0, 256, (48, 64, 3), dtype=np.uint8), rng.integers(0, 256, (64, 40, 3), dtype=np.uint8)]
    got = RTDETR(str(path), device="cpu").predict(imgs, imgsz=64, conf=0.01)
    ref = JRTDETR(str(path)).predict(imgs, imgsz=64, conf=0.01)
    for g, r in zip(got, ref):
        gd, rd = g.boxes.data, np.asarray(r.boxes.data)
        assert len(gd) == len(rd) > 0
        np.testing.assert_array_equal(gd[:, 5], rd[:, 5])
        np.testing.assert_allclose(gd[:, :4], rd[:, :4], atol=1e-2, rtol=0)
        np.testing.assert_allclose(gd[:, 4], rd[:, 4], atol=1e-4, rtol=0)


def test_cdn_noise_follows_the_seed_argument(data_yaml, tmp_path):
    """The port's trainer draws each batch's denoising noise from its own
    generator, seeded from `seed` (0 by default): the same seed gives the
    same queries, another seed others."""
    from ultralytics_pro_tpu_torch.data import DataLoader, YOLODataset, check_det_dataset
    from ultralytics_pro_tpu_torch.models.rtdetr import RTDETRTrainer

    d = check_det_dataset(str(data_yaml))
    batch = next(iter(DataLoader(YOLODataset(d["train"], imgsz=64, data=d), batch_size=2, max_gt=4, workers=1)))
    model = DetectionModel(dict(NARROW3))
    dns = []
    for seed in (None, 0, 5):
        args = {**DEFAULT_CFG_DICT, "project": str(tmp_path), "num_dn": 8, **({} if seed is None else {"seed": seed})}
        dns.append(RTDETRTrainer(model, args).put_batch(batch)["dn"])
    assert all(torch.equal(dns[0][k], dns[1][k]) for k in dns[0])
    assert not torch.equal(dns[0]["bbox_logit"], dns[2]["bbox_logit"])
    off = RTDETRTrainer(model, {**DEFAULT_CFG_DICT, "project": str(tmp_path), "dn_train": False}).put_batch(batch)
    assert "dn" not in off


def test_rtdetr_train_with_augment_raises(data_yaml, tmp_path):
    """augment=True is the train transforms of ROADMAP.md queue 1 item 2a, as for YOLO."""
    with pytest.raises(NotImplementedError, match="v8_transforms"):
        RTDETR(dict(NARROW), device="cpu").train(data=str(data_yaml), augment=True, epochs=1, imgsz=64, batch=2,
                                                 project=str(tmp_path))
    assert not list(tmp_path.rglob("*.ckpt"))
