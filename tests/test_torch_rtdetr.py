"""The port's RT-DETR modules and its predict slice against the JAX package.

Each JAX module is initialised, its variables are replaced by seeded numpy
values (`randomize`: BatchNorm statistics too) and carried into the port's
module by `jax_to_torch_state_dict` with a strict load. Inputs are seeded
numpy arrays, NHWC or (B, tokens, C) for JAX and NCHW or the same tokens for
the port.

Tolerances, all absolute on f32 values of order 1 (XLA and PyTorch sum in
different orders): 1e-5 for every module; 1e-4 for a whole narrow RT-DETR
model, where the error grows through the backbone, the encoder and the
decoder layers; 1e-2 px for predict's boxes in original pixels. The top-k
query indices are compared exactly, ties included: anchors that the mask
makes invalid all get the same encoder row, so their scores tie exactly and
`lax.top_k` puts the lower index first.
"""

import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.conftest import FIXTURES
from tests.test_torch_modules import nchw, randomize, to_nhwc, torch_threads  # noqa: F401 (autouse fixture)
from ultralytics_pro_tpu_torch import RTDETR
from ultralytics_pro_tpu_torch.nn.modules import (
    AIFI,
    MLP,
    DeformableTransformerDecoderLayer,
    DWConv,
    HGBlock,
    HGStem,
    LightConv,
    MSDeformAttn,
    RepC3,
    RepConv,
    RTDETRDecoder,
)
from ultralytics_pro_tpu_torch.nn.tasks import DetectionModel
from ultralytics_pro_tpu_torch.utils.weights import jax_to_torch_state_dict

ATOL_MODULE = 1e-5
ATOL_MODEL = 1e-4

# A narrow RT-DETR with rtdetr-l's module set: HGStem, HGBlock plain and with
# LightConv (with and without the residual), DWConv, AIFI, RepC3 (with and
# without cv3) and an RTDETRDecoder of hd = 64 (8 heads of 8), 2 layers and
# the default nq = 300.
NARROW = {
    "nc": 7,
    "backbone": [
        [-1, 1, "HGStem", [8, 16]],  # 0 P2/4
        [-1, 2, "HGBlock", [8, 32, 3]],  # 1
        [-1, 1, "DWConv", [32, 3, 2, 1, False]],  # 2 P3/8
        [-1, 2, "HGBlock", [16, 48, 3]],  # 3
        [-1, 1, "DWConv", [48, 3, 2, 1, False]],  # 4 P4/16
        [-1, 2, "HGBlock", [16, 64, 5, True, False]],  # 5
        [-1, 2, "HGBlock", [16, 64, 5, True, True]],  # 6
        [-1, 1, "DWConv", [64, 3, 2, 1, False]],  # 7 P5/32
        [-1, 2, "HGBlock", [32, 128, 5, True, False]],  # 8
    ],
    "head": [
        [-1, 1, "Conv", [64, 1, 1, None, 1, 1, False]],  # 9
        [-1, 1, "AIFI", [128, 8]],  # 10
        [-1, 1, "Conv", [64, 1, 1]],  # 11
        [-1, 1, "nn.Upsample", [None, 2, "nearest"]],
        [6, 1, "Conv", [64, 1, 1, None, 1, 1, False]],  # 13
        [[-2, -1], 1, "Concat", [1]],
        [-1, 2, "RepC3", [64]],  # 15
        [-1, 1, "Conv", [64, 1, 1]],  # 16
        [-1, 1, "nn.Upsample", [None, 2, "nearest"]],
        [3, 1, "Conv", [64, 1, 1, None, 1, 1, False]],  # 18
        [[-2, -1], 1, "Concat", [1]],
        [-1, 2, "RepC3", [64]],  # 20 X3
        [-1, 1, "Conv", [64, 3, 2]],
        [[-1, 16], 1, "Concat", [1]],
        [-1, 2, "RepC3", [64]],  # 23 F4
        [-1, 1, "Conv", [64, 3, 2]],
        [[-1, 11], 1, "Concat", [1]],
        [-1, 2, "RepC3", [64, 0.5]],  # 26 F5
        [[20, 23, 26], 1, "RTDETRDecoder", ["nc", 64, 300, 2]],
    ],
}


def _rng(seed):
    return np.random.default_rng(seed)


def carry(jax_module, args, torch_module, seed=0):
    """Random JAX variables for jax_module(*args), loaded into torch_module; returns them."""
    import jax

    v = randomize(jax_module.init(jax.random.PRNGKey(0), *args), seed)
    torch_module.load_state_dict(jax_to_torch_state_dict(v))  # strict
    torch_module.eval()
    return v


def _check_conv_like(jm, tm, x, seed=0):
    v = carry(jm, (x,), tm, seed)
    ref = np.asarray(jm.apply(v, x))
    with torch.no_grad():
        got = to_nhwc(tm(nchw(x)))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=ATOL_MODULE, rtol=0)


@pytest.mark.parametrize("act", [True, False])
def test_dwconv(act):
    from ultralytics_pro_tpu.nn.modules.conv import DWConv as JDWConv

    x = _rng(1).normal(0, 1, (2, 12, 10, 8)).astype(np.float32)
    _check_conv_like(JDWConv(c2=16, k=3, s=2, act=act), DWConv(8, 16, 3, 2, act=act), x)


def test_lightconv():
    from ultralytics_pro_tpu.nn.modules.conv import LightConv as JLightConv

    x = _rng(2).normal(0, 1, (2, 9, 11, 8)).astype(np.float32)
    _check_conv_like(JLightConv(c2=16, k=5), LightConv(8, 16, 5), x)


@pytest.mark.parametrize("c1,s", [(16, 1), (8, 2)])
def test_repconv(c1, s):
    from ultralytics_pro_tpu.nn.modules.conv import RepConv as JRepConv

    x = _rng(3).normal(0, 1, (2, 10, 12, c1)).astype(np.float32)
    _check_conv_like(JRepConv(c2=16, k=3, s=s), RepConv(c1, 16, 3, s), x)


def test_hgstem():
    from ultralytics_pro_tpu.nn.modules.block import HGStem as JHGStem

    x = _rng(4).normal(0, 1, (2, 32, 48, 3)).astype(np.float32)
    _check_conv_like(JHGStem(cm=8, c2=16), HGStem(3, 8, 16), x)


@pytest.mark.parametrize("lightconv,shortcut,c1", [(False, False, 16), (True, True, 32), (True, False, 24)])
def test_hgblock(lightconv, shortcut, c1):
    from ultralytics_pro_tpu.nn.modules.block import HGBlock as JHGBlock

    x = _rng(5).normal(0, 1, (2, 8, 10, c1)).astype(np.float32)
    k = 5 if lightconv else 3
    tm = HGBlock(c1, 8, 32, k, 3, lightconv, shortcut)
    assert tm.add == (shortcut and c1 == 32)
    _check_conv_like(JHGBlock(cm=8, c2=32, k=k, n=3, lightconv=lightconv, shortcut=shortcut), tm, x)


@pytest.mark.parametrize("e", [1.0, 0.5])
def test_repc3(e):
    from ultralytics_pro_tpu.nn.modules.block import RepC3 as JRepC3

    x = _rng(6).normal(0, 1, (2, 6, 8, 24)).astype(np.float32)
    tm = RepC3(24, 16, 2, e)
    assert isinstance(tm.cv3, torch.nn.Identity) == (e == 1.0)
    _check_conv_like(JRepC3(c2=16, n=2, e=e), tm, x)


def test_aifi_on_a_non_square_map():
    """Tokens in row-major (h, w) order with the position embedding meshed
    over (w, h) exactly as the JAX package does it; GELU in its tanh form,
    LayerNorm eps 1e-6."""
    from ultralytics_pro_tpu.nn.modules.transformer import AIFI as JAIFI

    x = _rng(7).normal(0, 1, (2, 3, 5, 32)).astype(np.float32)
    _check_conv_like(JAIFI(cm=64, num_heads=4), AIFI(32, 64, 4), x)


def test_sincos_pos_embed_matches_jax():
    from ultralytics_pro_tpu.nn.modules.transformer import sincos_pos_embed_2d as jpos

    from ultralytics_pro_tpu_torch.nn.modules.transformer import sincos_pos_embed_2d

    np.testing.assert_allclose(sincos_pos_embed_2d(5, 3, 32).numpy(), np.asarray(jpos(5, 3, 32)),
                               atol=1e-6, rtol=0)


def test_mlp():
    from ultralytics_pro_tpu.nn.modules.transformer import MLP as JMLP

    x = _rng(8).normal(0, 1, (2, 7, 8)).astype(np.float32)
    import jax

    jm, tm = JMLP(hidden_dim=16, output_dim=4, num_layers=3), MLP(8, 16, 4, 3)
    v = randomize(jm.init(jax.random.PRNGKey(0), x), 0)
    # a bare MLP's tree starts with `layers_0`, which the carrier reads as a
    # model's first layer (`model.0`); inside a model it is nested (`layers.0`)
    tm.load_state_dict({k.replace("model.", "layers.", 1): t for k, t in jax_to_torch_state_dict(v).items()})
    assert list(tm.state_dict()) == [f"layers.{i}.{p}" for i in range(3) for p in ("weight", "bias")]
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jm.apply(v, x)), atol=ATOL_MODULE, rtol=0)


SHAPES = [(8, 12), (4, 6), (2, 3)]


def _decoder_inputs(seed, b=2, q=11, c=32):
    rng = _rng(seed)
    query = rng.normal(0, 1, (b, q, c)).astype(np.float32)
    bbox = (1 / (1 + np.exp(-rng.normal(0, 1.5, (b, q, 4))))).astype(np.float32)  # cxcywh in (0, 1)
    values = [rng.normal(0, 1, (b, h * w, c)).astype(np.float32) for h, w in SHAPES]
    return query, bbox, values


def test_msdeformattn():
    from ultralytics_pro_tpu.nn.modules.transformer import MSDeformAttn as JMSDA

    query, bbox, values = _decoder_inputs(9)
    jm, tm = JMSDA(d_model=32, n_levels=3, n_heads=4, n_points=4), MSDeformAttn(32, 3, 4, 4)
    v = carry(jm, (query, bbox, values, SHAPES), tm)
    ref = np.asarray(jm.apply(v, query, bbox, values, SHAPES))
    with torch.no_grad():
        got = tm(torch.from_numpy(query), torch.from_numpy(bbox), torch.from_numpy(np.concatenate(values, 1)),
                 SHAPES).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL_MODULE, rtol=0)


def test_msdeformattn_init_matches_jax():
    """Zero offset and attention kernels and the grid-prior offset bias."""
    import jax

    from ultralytics_pro_tpu.nn.modules.transformer import MSDeformAttn as JMSDA

    query, bbox, values = _decoder_inputs(10)
    v = JMSDA(d_model=32, n_levels=3, n_heads=4, n_points=4).init(jax.random.PRNGKey(0), query, bbox,
                                                                  values, SHAPES)["params"]
    tm = MSDeformAttn(32, 3, 4, 4)
    for name in ("sampling_offsets", "attention_weights"):
        np.testing.assert_array_equal(getattr(tm, name).weight.detach().numpy(), np.asarray(v[name]["kernel"]).T)
        np.testing.assert_allclose(getattr(tm, name).bias.detach().numpy(), np.asarray(v[name]["bias"]),
                                   atol=1e-6, rtol=0)


def test_deformable_decoder_layer():
    from ultralytics_pro_tpu.nn.modules.transformer import DeformableTransformerDecoderLayer as JLayer

    query, bbox, values = _decoder_inputs(11)
    qpos = _rng(12).normal(0, 1, query.shape).astype(np.float32)
    jm = JLayer(d_model=32, n_heads=4, d_ffn=64, n_levels=3, n_points=4)
    tm = DeformableTransformerDecoderLayer(32, 4, 64, 3, 4)
    v = carry(jm, (query, bbox, values, SHAPES, qpos), tm)
    ref = np.asarray(jm.apply(v, query, bbox, values, SHAPES, qpos))
    with torch.no_grad():
        got = tm(torch.from_numpy(query), torch.from_numpy(bbox), torch.from_numpy(np.concatenate(values, 1)),
                 SHAPES, torch.from_numpy(qpos)).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL_MODULE, rtol=0)


def _is_enc_score_head(module, _method):
    return module.name == "enc_score_head"


def _jax_topk(apply_fn, variables, x, nq):
    """The JAX model's output and its top-nq query indices, from the
    captured enc_score_head logits (`lax.top_k` of their class max)."""
    import jax

    out, state = apply_fn(variables, x, capture_intermediates=_is_enc_score_head, mutable="intermediates")
    (scores,) = jax.tree.leaves(state["intermediates"])
    return out, np.asarray(jax.lax.top_k(scores.max(-1), min(nq, scores.shape[1]))[1])


def test_rtdetr_decoder_with_invalid_anchors():
    """Level maps of 52 x 3, 26 x 2 and 13 x 1 cells: the first and last rows
    of the 52-row map fall outside (0.01, 0.99), so their six anchors are
    +inf and their class scores tie exactly. All 221 anchors are queries
    (nq = min(300, A)), so the tie order shows in the output."""
    from ultralytics_pro_tpu.nn.modules.head import RTDETRDecoder as JDecoder

    rng = _rng(13)
    chs, shapes = (16, 24, 32), [(52, 3), (26, 2), (13, 1)]
    feats = [rng.normal(0, 1, (2, h, w, c)).astype(np.float32) for (h, w), c in zip(shapes, chs)]
    jm = JDecoder(nc=5, hd=32, ndl=2)
    tm = RTDETRDecoder(nc=5, ch=chs, hd=32, ndl=2)
    v = carry(jm, (feats,), tm)
    import jax

    apply_fn = jax.jit(jm.apply, static_argnames=("capture_intermediates", "mutable"))
    (ref, aux), topi = _jax_topk(apply_fn, v, feats, 300)
    anchors, valid = tm.anchors(shapes, "cpu")
    assert int((valid == 0).sum()) == 6 and bool(torch.isinf(anchors).any())
    with torch.no_grad():
        got, taux = tm([nchw(f) for f in feats])
    assert tuple(got.shape) == (2, 221, 4 + 5)
    np.testing.assert_array_equal(taux["topk_index"].numpy(), topi)
    tied = taux["enc_scores_dense"][0, (valid[0, :, 0] == 0)].amax(-1)
    assert bool((tied == tied[0]).all())  # the invalid anchors' scores tie exactly
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL_MODULE, rtol=0)
    np.testing.assert_allclose(taux["enc_scores"].numpy(), np.asarray(aux["enc_scores"]),
                               atol=ATOL_MODULE, rtol=0)


@pytest.mark.parametrize("ndl", [1, 3])
def test_rtdetr_decoder_aux_matches_jax(ndl):
    """aux carries every key of the JAX decoder's aux under its shape, each
    within the module tolerance: the selected queries' encoder scores and
    boxes, and every decoder layer's boxes and score logits (what the DETR
    loss reads). The port's own keys come on top."""
    from ultralytics_pro_tpu.nn.modules.head import RTDETRDecoder as JDecoder

    rng = _rng(14)
    chs, shapes = (16, 24), [(8, 10), (4, 5)]
    feats = [rng.normal(0, 1, (2, h, w, c)).astype(np.float32) for (h, w), c in zip(shapes, chs)]
    jm = JDecoder(nc=6, hd=32, nq=40, ndl=ndl)
    tm = RTDETRDecoder(nc=6, ch=chs, hd=32, nq=40, ndl=ndl)
    v = carry(jm, (feats,), tm)
    _, aux = jm.apply(v, feats)
    with torch.no_grad():
        _, taux = tm([nchw(f) for f in feats])
    assert set(aux) == {"enc_scores", "enc_bboxes", "dec_bboxes", "dec_scores"}
    assert set(taux) == set(aux) | {"topk_index", "enc_scores_dense"}
    assert tuple(taux["dec_scores"].shape) == (ndl, 2, 40, 6)
    assert tuple(taux["enc_scores_dense"].shape) == (2, 100, 6)
    for key in aux:
        assert tuple(taux[key].shape) == np.shape(aux[key]), key
        np.testing.assert_allclose(taux[key].numpy(), np.asarray(aux[key]), atol=ATOL_MODULE,
                                   rtol=0, err_msg=key)


@pytest.mark.parametrize("ndl", [1, 3])
def test_rtdetr_decoder_without_aux_gives_the_same_output(ndl):
    """aux=False, the predictor's call: y equal to the bit, aux None, and only
    the last layer's score head runs (exact: the same operations on y's path)."""
    rng = _rng(15)
    chs, shapes = (16, 24), [(8, 10), (4, 5)]
    feats = [nchw(rng.normal(0, 1, (2, h, w, c)).astype(np.float32)) for (h, w), c in zip(shapes, chs)]
    tm = RTDETRDecoder(nc=6, ch=chs, hd=32, nq=40, ndl=ndl).eval()
    calls = []
    for i, head in enumerate(tm.dec_score_head):
        head.register_forward_hook(lambda *_, i=i: calls.append(i))
    with torch.no_grad():
        y, aux = tm(feats)
        assert calls == list(range(ndl))
        calls.clear()
        y_only, none = tm(feats, aux=False)
    assert none is None and calls == [ndl - 1]
    assert torch.equal(y_only, y)


@pytest.fixture(scope="module")
def narrow_pair():
    """The NARROW model in both packages with one set of seeded weights."""
    import jax

    from ultralytics_pro_tpu.nn.tasks import DetectionModel as JModel

    jm = JModel(dict(NARROW))
    variables = randomize(jm.init_params(imgsz=64), seed=21)
    tm = DetectionModel(dict(NARROW))
    tm.load_state_dict(jax_to_torch_state_dict(variables))  # strict
    return jm, jax.jit(jm.module.apply, static_argnames=("train", "capture_intermediates", "mutable")), \
        variables, tm


@pytest.mark.parametrize("hw", [(64, 64), (64, 96)])
def test_narrow_rtdetr_forward_matches_jax(narrow_pair, hw):
    jm, apply_fn, variables, tm = narrow_pair
    x = _rng(22).uniform(0, 1, (2, *hw, 3)).astype(np.float32)
    (ref, _), topi = _jax_topk(lambda v, xx, **kw: apply_fn(v, xx, train=False, **kw), variables, x, 300)
    with torch.no_grad():
        got, aux = tm(nchw(x))
    a = sum((hw[0] // s) * (hw[1] // s) for s in (8, 16, 32))
    assert tuple(got.shape) == (2, min(300, a), 4 + 7) == np.shape(ref)
    assert tm.stride.tolist() == [8.0, 16.0, 32.0]
    np.testing.assert_array_equal(aux["topk_index"].numpy(), topi)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL_MODEL, rtol=0)


def test_narrow_rtdetr_predict_matches_jax(narrow_pair):
    """RTDETR(dict, device="cpu").predict against the JAX RTDETR's predict on
    the same weights: images no larger than imgsz, so letterboxing only pads
    and both sides see the same pixels (test_torch_model.py says why)."""
    from ultralytics_pro_tpu.models.rtdetr import RTDETR as JRTDETR

    jm, _, variables, tm = narrow_pair
    rng = _rng(23)
    imgs = [rng.integers(0, 256, (48, 64, 3), dtype=np.uint8), rng.integers(0, 256, (64, 40, 3), dtype=np.uint8)]
    jr = JRTDETR(dict(NARROW))
    jr.model.variables = variables
    tr = RTDETR(dict(NARROW), device="cpu")
    tr.model.load_state_dict(tm.state_dict())
    ref = jr.predict(imgs, imgsz=64)
    got = tr.predict(imgs, imgsz=64)
    assert len(got) == len(ref) == 2
    for g, r, im in zip(got, ref, imgs):
        gd, rd = g.boxes.data, np.asarray(r.boxes.data)
        assert g.orig_shape == r.orig_shape == im.shape[:2]
        assert 0 < len(gd) == len(rd) <= 84
        np.testing.assert_array_equal(gd[:, 5], rd[:, 5])
        np.testing.assert_allclose(gd[:, :4], rd[:, :4], atol=1e-2, rtol=0)
        np.testing.assert_allclose(gd[:, 4], rd[:, 4], atol=ATOL_MODEL, rtol=0)


@pytest.fixture(scope="module")
def narrow_vals(narrow_pair, tmp_path_factory):
    """RTDETR(NARROW).val in both packages on a copy of the detect fixture set
    (the JAX loader writes a label cache) at 64 px, conf 0.001, on the same
    pixels (cv2's INTER_AREA in the port's loader, tests/test_torch_train.py):
    {(package, batch): DetMetrics} for batch 16 (no pad) and 6 (the last
    batch padded by 2 copies), and the port's at batch 16 with single_cls."""
    from tests.test_torch_train import same_images_as_jax
    from ultralytics_pro_tpu.models.rtdetr import RTDETR as JRTDETR

    _, _, variables, tm = narrow_pair
    root = tmp_path_factory.mktemp("rtdetr_val") / "set"
    data = str(shutil.copytree(Path(FIXTURES) / "torch_val_synth", root) / "data.yaml")
    jr = JRTDETR(dict(NARROW))
    jr.model.variables = variables
    tr = RTDETR(dict(NARROW), device="cpu")
    tr.model.load_state_dict(tm.state_dict())
    out = {}
    with same_images_as_jax():
        for batch in (16, 6):
            out["port", batch] = tr.val(data=data, imgsz=64, batch=batch)
            out["jax", batch] = jr.val(data=data, imgsz=64, batch=batch)
        out["port", "single_cls"] = tr.val(data=data, imgsz=64, batch=16, single_cls=True)
    return out


def test_narrow_rtdetr_val_matches_jax(narrow_vals):
    """Batch 16: every image keeps the same queries (conf within 1e-4), with
    the same classes and true positives; mAP50 and mAP50-95 within 1e-4."""
    got, want = narrow_vals["port", 16], narrow_vals["jax", 16]
    assert len(got.stats["conf"]) == len(want.stats["conf"]) == 16
    assert sum(len(c) for c in got.stats["conf"]) > 0
    for key in ("conf", "pred_cls", "tp", "target_cls"):
        for g, w in zip(got.stats[key], want.stats[key]):
            assert np.shape(g) == np.shape(w), key
            np.testing.assert_allclose(np.asarray(g, np.float64), np.asarray(w, np.float64), atol=ATOL_MODEL, rtol=0)
    assert got.box.map50 == pytest.approx(float(want.box.map50), abs=1e-4)
    assert got.box.map == pytest.approx(float(want.box.map), abs=1e-4)


def test_narrow_rtdetr_val_departs_from_jax_on_pad_and_single_cls(narrow_vals):
    """Two departures from the JAX RTDETRValidator, as the port's
    DetectionValidator has them (ROADMAP.md section 3): at batch 6 the port
    scores 16 images, the same as at batch 16, where the JAX one scores the
    2 copies of the last image again (18); under single_cls the port's
    dataset zeroes the ground truth's classes and its validator the
    predictions'."""
    port16, port6, jax6 = narrow_vals["port", 16], narrow_vals["port", 6], narrow_vals["jax", 6]
    assert len(port6.stats["conf"]) == 16 and len(jax6.stats["conf"]) == 18
    for g, w in zip(port6.stats["conf"], port16.stats["conf"]):
        np.testing.assert_array_equal(g, w)
    assert (port6.box.map50, port6.box.map) == (port16.box.map50, port16.box.map)
    one = narrow_vals["port", "single_cls"]
    assert not np.concatenate(one.stats["pred_cls"]).any() and not np.concatenate(one.stats["target_cls"]).any()
    assert sum(map(len, one.stats["conf"])) == sum(map(len, port16.stats["conf"]))


def test_rtdetr_entry_points():
    """RTDETR defaults to device='cuda' and raises without a card; with
    device='cpu' it builds rtdetr-l at full width and depth; val asks for
    data, and train names its later slice (queue 1 item 4b)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the no-card behaviour")
    with pytest.raises(RuntimeError, match="cuda"):
        RTDETR("rtdetr-l.yaml")
    m = RTDETR("rtdetr-l.yaml", device="cpu")
    assert sum(p.numel() for p in m.model.parameters()) == 32_970_732
    assert len(m.model.model[-1].decoder.layers) == 6
    with pytest.raises(ValueError, match="data="):
        m.val()
    with pytest.raises(NotImplementedError, match="later slice .*4b"):
        m.train()
    with pytest.raises(ValueError, match="RTDETRDecoder"):
        RTDETR("yolov8n.yaml", device="cpu")


def test_rtdetr_predict_rebuilds_its_predictor_on_changed_arguments(narrow_pair):
    """A port-only behaviour: like the port's Model.predict and the torch
    reference, RTDETR.predict builds a new predictor when its arguments
    change and keeps it while they do not. The JAX RTDETR keeps its first
    predictor (ROADMAP.md section 3), so this is not held to it."""
    tr = RTDETR(dict(NARROW), device="cpu")
    tr.model.load_state_dict(narrow_pair[3].state_dict())
    img = _rng(24).integers(0, 256, (48, 64, 3), dtype=np.uint8)
    low = tr.predict([img], imgsz=64, conf=0.3)
    first = tr.predictor
    tr.predict([img], imgsz=64, conf=0.3)
    assert tr.predictor is first
    high = tr.predict([img], imgsz=64, conf=0.6)
    assert tr.predictor is not first and tr.predictor.conf == 0.6 and first.conf == 0.3
    assert (high[0].boxes.data[:, 4] > 0.6).all() and len(high[0]) <= len(low[0])


@pytest.mark.parametrize("flags", [(True, True), (False, False), (True, False)])
@pytest.mark.parametrize("which", ["yolov8n", "narrow_rtdetr"])
def test_predict_runs_in_full_f32_and_restores_tf32_flags(which, flags):
    """Inside a predict call's device function TF32 is off for convolutions
    and matmuls; after the call torch.backends.cudnn.allow_tf32 and
    torch.backends.cuda.matmul.allow_tf32 are as the caller left them."""
    from ultralytics_pro_tpu_torch import YOLO

    model = (YOLO("yolov8n.yaml", device="cpu") if which == "yolov8n"
             else RTDETR(dict(NARROW), device="cpu"))
    seen = []
    model.model.register_forward_pre_hook(
        lambda *_: seen.append((torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)))
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
        model.predict([_rng(25).integers(0, 256, (48, 64, 3), dtype=np.uint8)], imgsz=64, conf=0.25)
        after = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    assert seen == [(False, False)]
    assert after == flags
