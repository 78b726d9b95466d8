"""The modules, heads and reader of the RTMDet, YOLOv7, YOLOv4-CSP and
YOLOR-CSP YAMLs in the port against the JAX package, on the CPU.

1. The YAML reader (`utils/miniyaml.py`, no PyYAML) equals `yaml.safe_load`
   on every model YAML of the JAX package (PyYAML's block dumps with
   `- - -1` rows and `- 0.33` scales, a comment right after `]]`), and every
   YAML under the port's cfg/models is its JAX file byte for byte.
2. Blocks: ImplicitA, ImplicitM, CSPNeXtBlock, RTMBlock, BottleneckCSP,
   BottleneckCSP2, SPPCSPC, ResBottleneck, BottleneckCSPB/ResCSPB,
   BottleneckCSPC/ResCSPC, Stem and RepConv_v7's RepConv, each against its
   JAX module on seeded variables carried by `jax_to_torch_state_dict`
   (strict), NHWC against NCHW, in eval mode and in train mode (batch
   statistics, and the running statistics each updates): within 1e-5 of the
   output's largest magnitude.
3. Heads: IDetect, ISegment, IPose, IOBB and the implicit AnchorDetect in
   train and eval mode: raw maps, mask coefficients, prototypes, keypoints
   and angles within 1e-5 of their largest magnitude, decoded boxes too,
   scores within 1e-5.
4. The builder: the rows read as the JAX builders read them (MP, RepConv_v7,
   the repeats, the arguments each builder ignores, Stem's widths, ISegment's
   scaled npr, rtmdet-pose's kpt_shape), the carrier's `implicit` leaf, the
   optimizer groups, and the predictors, validators and trainers taking the
   I-heads.
5. An MHSA model whose weights were written after it was built keeps them
   at a call at another size, where the call raises as the JAX facade's
   does.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from tests.test_torch_modules import nchw, randomize, to_nhwc, torch_threads  # noqa: F401 (autouse fixture)
from tests.test_torch_train import leaves
from tests.torch_csp_zoo import NARROW, implicit_around_one
from ultralytics_pro_tpu_torch.nn.modules import block as B
from ultralytics_pro_tpu_torch.nn.modules import families as Fm
from ultralytics_pro_tpu_torch.nn.modules.conv import ImplicitA, ImplicitM, RepConv
from ultralytics_pro_tpu_torch.nn.modules.head import V5_ANCHORS, AnchorDetect, IDetect, IOBB, IPose, ISegment
from ultralytics_pro_tpu_torch.nn.tasks import guess_model_task, model_class_for, parse_model, yaml_model_load
from ultralytics_pro_tpu_torch.utils import PKG_ROOT, miniyaml
from ultralytics_pro_tpu_torch.utils.weights import jax_to_torch_state_dict, torch_state_dict_to_jax

JAX_MODELS = Path(__file__).resolve().parents[1] / "ultralytics_pro_tpu" / "cfg" / "models"
PORT_MODELS = PKG_ROOT / "cfg" / "models"
JAX_YAMLS = sorted(p.relative_to(JAX_MODELS).as_posix() for p in JAX_MODELS.rglob("*.yaml"))
PORT_YAMLS = sorted(p.relative_to(PORT_MODELS).as_posix() for p in PORT_MODELS.rglob("*.yaml"))
TOL = 1e-5


def close(got, want, tol: float = TOL):
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=tol * np.abs(want).max(), rtol=0)


# -- the reader ------------------------------------------------------------------------

def test_the_jax_package_has_126_model_yamls_and_the_port_79():
    assert len(JAX_YAMLS) == 126 and len(PORT_YAMLS) == 102


@pytest.mark.parametrize("rel", JAX_YAMLS)
def test_reader_equals_safe_load_on_every_jax_model_yaml(rel):
    import yaml

    text = (JAX_MODELS / rel).read_text(encoding="utf-8")
    assert miniyaml.loads(text) == yaml.safe_load(text)


@pytest.mark.parametrize("rel", PORT_YAMLS)
def test_port_yaml_is_its_jax_file_byte_for_byte(rel):
    assert (PORT_MODELS / rel).read_bytes() == (JAX_MODELS / rel).read_bytes()


def test_reader_block_forms():
    """A block sequence nested on its entry's line, one at its key's column,
    block mappings in a sequence, a bare '-' entry, a comment right after a
    closing bracket; YAML 1.1 scalars kept (`1e-3` a string); a sequence
    entry deeper than its siblings and a top-level sequence refused."""
    import yaml

    for text in ("backbone:\n- - -1\n  - 1\n  - Conv\n  - - 32\n    - 3\nhead:\n  - [-1, 1, Detect, [nc]]\n",
                 "scales:\n  n:\n  - 0.33\n  - 1024\n  s: [0.5, 1e-3]\n",
                 "a:\n  - b: 1\n    c: [2, 3]\n  -\n    - 4\n  - [5, [6]]# six\n"):
        assert miniyaml.loads(text) == yaml.safe_load(text)
    assert miniyaml.loads("s: [0.5, 1e-3]\n") == {"s": [0.5, "1e-3"]}
    for bad in ("a:\n - 1\n  - 2\n", "- 1\n", "a: [1]x\n"):
        with pytest.raises(ValueError):
            miniyaml.loads(bad)


# -- blocks -------------------------------------------------------------------------------

def _jconv():
    from ultralytics_pro_tpu.nn.modules import conv

    return conv


def _jblock():
    from ultralytics_pro_tpu.nn.modules import block

    return block


def _jfam():
    from ultralytics_pro_tpu.nn.modules import families

    return families


# (JAX module factory, port module factory, input channels, map size)
BLOCKS = {
    "ImplicitA": (lambda: _jconv().ImplicitA(), lambda: ImplicitA(16), 16, 8),
    "ImplicitM": (lambda: _jconv().ImplicitM(), lambda: ImplicitM(16), 16, 8),
    "CSPNeXtBlock": (lambda: _jfam().CSPNeXtBlock(c2=16), lambda: Fm.CSPNeXtBlock(16, 16), 16, 8),
    "CSPNeXtBlock_widening": (lambda: _jfam().CSPNeXtBlock(c2=16), lambda: Fm.CSPNeXtBlock(8, 16), 8, 8),
    "RTMBlock": (lambda: _jfam().RTMBlock(c2=32, n=2), lambda: Fm.RTMBlock(16, 32, 2), 16, 8),
    "RTMBlock_no_shortcut": (lambda: _jfam().RTMBlock(c2=32, n=2, shortcut=False),
                             lambda: Fm.RTMBlock(32, 32, 2, False), 32, 7),
    "BottleneckCSP": (lambda: _jblock().BottleneckCSP(c2=32, n=2), lambda: B.BottleneckCSP(16, 32, 2), 16, 8),
    "BottleneckCSP2": (lambda: _jblock().BottleneckCSP2(c2=32, n=2), lambda: B.BottleneckCSP2(16, 32, 2), 16, 8),
    "SPPCSPC": (lambda: _jblock().SPPCSPC(c2=32), lambda: B.SPPCSPC(16, 32), 16, 8),
    "SPPCSPC_odd": (lambda: _jblock().SPPCSPC(c2=16, e=1.0), lambda: B.SPPCSPC(16, 16, 1.0), 16, 7),
    "ResBottleneck": (lambda: _jfam().ResBottleneck(c2=32), lambda: Fm.ResBottleneck(32, 32), 32, 8),
    "BottleneckCSPB": (lambda: _jfam().BottleneckCSPB(c2=32, n=2), lambda: Fm.BottleneckCSPB(16, 32, 2), 16, 8),
    "ResCSPB": (lambda: _jfam().ResCSPB(c2=32, n=2), lambda: Fm.ResCSPB(16, 32, 2), 16, 8),
    "BottleneckCSPC": (lambda: _jfam().BottleneckCSPC(c2=32, n=2), lambda: Fm.BottleneckCSPC(16, 32, 2), 16, 8),
    "ResCSPC": (lambda: _jfam().ResCSPC(c2=32, n=2), lambda: Fm.ResCSPC(16, 32, 2), 16, 8),
    "Stem": (lambda: _jfam().Stem(c2=48), lambda: Fm.Stem(3, 48), 3, 16),
    "RepConv_v7": (lambda: _jconv().RepConv(c2=32, k=3, s=1), lambda: RepConv(16, 32, 3, 1), 16, 8),
}


@pytest.mark.parametrize("mode", ["eval", "train"])
@pytest.mark.parametrize("case", list(BLOCKS))
def test_block_matches_jax(case, mode):
    import jax

    make_jax, make, c1, hw = BLOCKS[case]
    x = np.random.default_rng(1).normal(0, 1, (2, hw, hw, c1)).astype(np.float32)
    jm, tm = make_jax(), make()
    v = randomize(jm.init(jax.random.PRNGKey(0), x), 2)
    if case == "ImplicitM":  # around 1, as it starts
        v["params"]["implicit"] = v["params"]["implicit"] + 1.0
    tm.load_state_dict(jax_to_torch_state_dict(v))  # strict
    if mode == "eval":
        want = jm.apply(v, x, train=False)
        with torch.no_grad():
            got = to_nhwc(tm.eval()(nchw(x)))
        close(got, want)
        return
    want, new = jm.apply(v, x, train=True, mutable=["batch_stats"])
    with torch.no_grad():
        got = to_nhwc(tm.train()(nchw(x)))
    close(got, want)
    moved = dict(leaves(torch_state_dict_to_jax(tm.state_dict())["batch_stats"]))
    assert moved.keys() == dict(leaves(new.get("batch_stats", {}))).keys()
    for k, w in leaves(new.get("batch_stats", {})):
        close(moved[k], w)


def test_block_shapes_and_names():
    """BottleneckCSP's own BN after the bare cv2/cv3 convs; the CSP-B hidden
    width c2 and the CSP-C one c2 // 2; a ResBottleneck inside halves its
    width where a Bottleneck keeps it; RTMBlock's attention on the
    concatenated branches; SPPCSPC's pools at stride 1."""
    csp = B.BottleneckCSP(64, 128, 2)
    assert csp.cv2.bias is None and csp.cv3.bias is None and csp.bn.num_features == 128
    assert csp.bn.momentum == 0.03 and csp.bn.eps == 1e-3 and isinstance(csp.act, torch.nn.SiLU)
    assert isinstance(B.BottleneckCSP2(64, 128).act, torch.nn.Mish)
    cspb, cspc = Fm.ResCSPB(64, 128, 1), Fm.ResCSPC(64, 128, 1)
    assert cspb.cv1.conv.out_channels == 128 and cspb.m[0].cv1.conv.out_channels == 64
    assert cspc.cv1.conv.out_channels == 64 and cspc.m[0].cv1.conv.out_channels == 32
    assert Fm.BottleneckCSPB(64, 128, 1).m[0].cv1.conv.out_channels == 128
    rtm = Fm.RTMBlock(64, 128, 1)
    assert rtm.attn_fc.in_channels == rtm.attn_fc.out_channels == 128 and rtm.attn_fc.bias is not None
    assert rtm.m[0].cv2.conv.groups == 64 and rtm.m[0].cv2.conv.kernel_size == (5, 5)
    assert [(p.kernel_size, p.stride, p.padding) for p in B.SPPCSPC(64, 64).m] == [(5, 1, 2), (9, 1, 4), (13, 1, 6)]
    assert set(ImplicitM(8).state_dict()) == {"implicit"} and ImplicitM(8).implicit.shape == (1, 8, 1, 1)


# -- heads -------------------------------------------------------------------------------

CH, SIZES = (32, 64, 64), (8, 4, 2)
HEADS = {  # JAX head factory, port head factory
    "IDetect": (lambda h: h.IDetect(nc=5), lambda: IDetect(5, CH)),
    "ISegment": (lambda h: h.ISegment(nc=5, nm=8, npr=16), lambda: ISegment(5, CH, 8, 16)),
    "IPose": (lambda h: h.IPose(nc=5, kpt_shape=(5, 3)), lambda: IPose(5, CH, (5, 3))),
    "IOBB": (lambda h: h.IOBB(nc=5), lambda: IOBB(5, CH, 1)),
    "AnchorDetect_implicit": (lambda h: h.AnchorDetect(nc=5, implicit=True),
                              lambda: AnchorDetect(5, CH, V5_ANCHORS, True)),
}
EXTRA = {"ISegment": "mc", "IPose": "kpt", "IOBB": "angle"}  # the train-mode dict's extra entry


@pytest.mark.parametrize("mode", ["train", "eval"])
@pytest.mark.parametrize("name", list(HEADS))
def test_head_matches_jax(name, mode):
    import jax

    from ultralytics_pro_tpu.nn.modules import head as jhead

    make_jax, make = HEADS[name]
    rng = np.random.default_rng(3)
    feats = [rng.normal(0, 1, (2, h, h, c)).astype(np.float32) for c, h in zip(CH, SIZES)]
    jm, head = make_jax(jhead), make()
    shapes = jax.eval_shape(lambda x: jm.init(jax.random.PRNGKey(0), x, train=False), feats)
    v = implicit_around_one(randomize(jax.tree_util.tree_map(lambda a: np.zeros(a.shape, np.float32), shapes), 4))
    head.load_state_dict(jax_to_torch_state_dict(v))  # strict
    head.stride = torch.tensor([8.0, 16.0, 32.0])
    tf = [nchw(f) for f in feats]
    if mode == "train":  # train-mode BN: batch statistics
        want = jax.jit(lambda v, x: jm.apply(v, x, train=True, mutable=["batch_stats"])[0])(v, feats)
        with torch.no_grad():
            got = head.train()(tf, decode=False)
        got = got if isinstance(got, dict) else {"feats": got}
        for key in ("feats", "anchor_feats") if "anchor_feats" in want else ("feats",):
            for g, w in zip(got[key], want[key], strict=True):
                close(to_nhwc(g), w)
        if name in EXTRA:
            close(got[EXTRA[name]].numpy(), want[EXTRA[name]])
        if name == "ISegment":
            close(to_nhwc(got["protos"]), want["protos"])
        return
    y, aux = jax.jit(lambda v, x: jm.apply(v, x, train=False))(v, feats)
    with torch.no_grad():
        got, got_aux = head.eval()(tf)
    want = np.asarray(y)
    assert got.shape == want.shape
    close(got[..., :4].numpy(), want[..., :4])
    np.testing.assert_allclose(got[..., 4:9].numpy(), want[..., 4:9], atol=TOL, rtol=0)
    if want.shape[-1] > 9:
        close(got[..., 9:].numpy(), want[..., 9:])
    raw = got_aux["feats"] if isinstance(got_aux, dict) else got_aux
    for g, w in zip(raw, aux["feats"], strict=True):
        close(to_nhwc(g), w)
    if name == "ISegment":
        close(to_nhwc(got_aux["protos"]), aux["protos"])


def test_heads_carry_implicit_under_the_jax_names():
    """`ia2_0/implicit` (1, 1, 1, C) is `ia2.0.implicit` (1, C, 1, 1), and
    back; the implicit anchor head's `ia_i`, `im_i` are `ia.i`, `im.i`; the
    mask, keypoint and angle branches and the prototypes have none."""
    sd = IDetect(5, CH).state_dict()
    assert sd["ia2.0.implicit"].shape == (1, 32, 1, 1) and sd["im2.2.implicit"].shape == (1, 64, 1, 1)
    assert sd["im3.1.implicit"].shape == (1, 5, 1, 1) and sd["ia3.2.implicit"].shape == (1, 64, 1, 1)
    tree = torch_state_dict_to_jax(sd)["params"]
    assert tree["ia2_0"]["implicit"].shape == (1, 1, 1, 32) and tree["im2_2"]["implicit"].shape == (1, 1, 1, 64)
    back = jax_to_torch_state_dict(torch_state_dict_to_jax(sd))
    assert all(torch.equal(back[k], v) for k, v in sd.items() if not k.endswith("num_batches_tracked"))
    a = AnchorDetect(5, CH, V5_ANCHORS, True).state_dict()
    assert a["ia.1.implicit"].shape == (1, 64, 1, 1) and a["im.0.implicit"].shape == (1, 30, 1, 1)
    assert not any("implicit" in k for k in AnchorDetect(5, CH).state_dict())
    for head in (ISegment(5, CH, 8, 16), IPose(5, CH, (5, 3)), IOBB(5, CH, 1)):
        assert not any("implicit" in k for k in head.state_dict() if k.startswith(("cv4", "proto")))
        assert {"ia2.0.implicit", "im3.2.implicit"} <= set(head.state_dict())


def test_implicit_starts_as_the_reference_draws_it():
    """init_weights draws ImplicitA around 0 and ImplicitM around 1, std 0.02."""
    from ultralytics_pro_tpu_torch.nn.tasks import init_weights

    head = IDetect(5, CH)
    init_weights(head, torch.Generator().manual_seed(0))
    a = torch.cat([m.implicit.detach().flatten() for m in head.ia2]).numpy()
    m = torch.cat([m.implicit.detach().flatten() for m in head.im2]).numpy()
    assert abs(a.mean()) < 0.01 and 0.01 < a.std() < 0.03
    assert abs(m.mean() - 1) < 0.01 and 0.01 < m.std() < 0.03


# -- the builder --------------------------------------------------------------------------

def _port(name: str, extra: dict | None = None):
    d = {**yaml_model_load(name), **(extra or {})}
    return model_class_for(guess_model_task(d))(d)


def test_rows_build_as_the_jax_builders_read_them():
    """MP is a 2 x 2 max pool at stride 2; RepConv_v7 the port's RepConv (no
    identity-BN branch); BottleneckCSP, BottleneckCSP2, ResCSPB, ResCSPC and
    RTMBlock take the repeats as their n; SPPCSPC and Stem do not; yolor-csp's
    Stem at width 0.75 is 24 then 48 channels; ISegment's npr is
    width-scaled; rtmdet-pose's kpt_shape is (17, 3)."""
    v7 = _port("yolov7.yaml", NARROW)
    mp = v7.model[12]
    assert isinstance(mp, torch.nn.MaxPool2d) and (mp.kernel_size, mp.stride) == (2, 2)
    assert isinstance(v7.model[102], RepConv) and not hasattr(v7.model[102], "bn")
    assert isinstance(v7.model[51], B.SPPCSPC) and type(v7.model[-1]) is IDetect
    v4 = _port("yolov4-csp.yaml")
    assert [len(v4.model[i].m) for i in (4, 6, 8, 10, 16, 21)] == [2, 8, 8, 4, 2, 2]
    assert isinstance(v4.model[16], B.BottleneckCSP2) and isinstance(v4.model[2], B.Bottleneck)
    r = _port("yolor-csp.yaml")
    assert (r.model[0].cv1.conv.out_channels, r.model[0].cv2.conv.out_channels) == (24, 48)
    assert [len(r.model[i].m) for i in (2, 4, 6, 8, 14, 19)] == [2, 3, 4, 2, 2, 2]
    assert isinstance(r.model[9], B.SPPCSPC) and isinstance(r.model[6], Fm.ResCSPB)
    rtm = _port("rtmdet-s.yaml")
    assert [len(rtm.model[i].m) for i in (4, 6, 8, 11)] == [1, 2, 2, 1]
    assert rtm.model[4].m[0].add and not rtm.model[11].m[0].add  # shortcut False in the last stage and the neck
    seg = _port("yolov7-seg.yaml", NARROW)
    assert type(seg.model[-1]) is ISegment and seg.model[-1].npr == 64 and seg.model[-1].nm == 32
    assert _port("rtmdet-t-pose.yaml").model[-1].kpt_shape == (17, 3)
    anchor = _port("yolov7-anchor.yaml", NARROW)
    head = anchor.model[-1]
    assert head.implicit and head.anchor_list[2][2] == (373.0, 326.0)
    assert sum(3 * (640 // s) ** 2 for s in anchor.stride.int().tolist()) == 25200


def test_ignored_arguments_are_ignored_as_jax_ignores_them():
    """ResCSPB and Stem read [c2] alone, the CSP-B/C blocks, RTMBlock and
    BottleneckCSP2 [c2, shortcut], SPPCSPC [c2, e], as the JAX builders do."""
    import jax

    from tests.torch_attn_zoo import jax_module

    d = {"nc": 3, "depth_multiple": 1.0, "width_multiple": 0.25,
         "backbone": [[-1, 1, "Stem", [64, 99]], [-1, 2, "ResCSPB", [64, True, 7]], [-1, 1, "Conv", [128, 3, 2]],
                      [-1, 2, "ResCSPC", [128, True]], [-1, 1, "SPPCSPC", [128, 0.25, [3, 5]]],
                      [-1, 1, "BottleneckCSPB", [128, True, 3]], [-1, 1, "MP", []], [-1, 1, "RTMBlock", [128, True, 7]],
                      [-1, 1, "RepConv_v7", [128, 3, 2, 9]]],
         "head": [[[4, 5, 8], 1, "IDetect", ["nc"]]]}
    jm = jax_module(d)
    shapes = jax.eval_shape(lambda x: jm.init(jax.random.PRNGKey(0), x), jax.ShapeDtypeStruct((1, 64, 64, 3),
                                                                                                 np.float32))
    layers, _, _ = parse_model(d)
    sd = torch.nn.Sequential(*layers).state_dict()
    want = {"/".join(k): v.shape for k, v in
            leaves(jax.tree_util.tree_map(lambda a: np.zeros(a.shape, np.float32), shapes["params"]))}
    got = {"/".join(k): v.shape for k, v in leaves(torch_state_dict_to_jax(sd)["params"])}
    assert got == want
    assert layers[4].cv1.conv.out_channels == 16 and len(layers[4].m) == 3  # e 0.25 of 2 x 32; k (5, 9, 13)
    assert layers[1].m[0].add is False and layers[5].m[0].add is True


@pytest.mark.parametrize("name", ["yolov7.yaml", "yolov7-anchor.yaml", "yolov4-csp.yaml"])
def test_param_groups_are_the_jax_trainers(name):
    """Every parameter of a narrowed yolov7, yolov7-anchor and yolov4-csp in
    the JAX trainer's group of its carried flax leaf: the bare `implicit` 0
    (decayed), BottleneckCSP's and BottleneckCSP2's own `bn` weight 1, its
    bare convs 0, biases 2."""
    from ultralytics_pro_tpu.engine.trainer import param_group as jgroup
    from ultralytics_pro_tpu_torch.engine.trainer import param_group
    from ultralytics_pro_tpu_torch.utils.weights import torch_key_to_flax

    model = _port(name, NARROW)
    owners = dict(model.named_modules())
    groups = {}
    for key, p in model.named_parameters():
        if key.endswith("dfl.conv.weight"):
            continue
        owner, _, leaf = key.rpartition(".")
        path, fleaf, _ = torch_key_to_flax(key, p.ndim)
        groups[key] = param_group(owners[owner], leaf)
        assert groups[key] == jgroup((*path, fleaf)), key
    implicit = {k: g for k, g in groups.items() if k.endswith(".implicit")}
    assert set(implicit.values()) == (set() if name == "yolov4-csp.yaml" else {0})
    if name == "yolov4-csp.yaml":
        assert (groups["model.4.bn.weight"], groups["model.4.bn.bias"], groups["model.4.cv2.weight"]) == (1, 2, 0)
        assert groups["model.16.bn.weight"] == 1


def test_predictors_validators_and_trainers_take_the_i_heads(tmp_path):
    """The predictors pick heads by exact type: IDetect (TTA too), ISegment,
    IPose, IOBB each by its task's; validators and trainers by isinstance,
    with Segment's, Pose's and OBB's criteria and the anchor criterion."""
    from ultralytics_pro_tpu_torch.models import task_map
    from ultralytics_pro_tpu_torch.utils.loss import v5AnchorLoss, v8DetectionLoss, v8OBBLoss, v8PoseLoss, \
        v8SegmentationLoss

    args = {"imgsz": 64, "conf": 0.25}
    crit = {"yolov7.yaml": v8DetectionLoss, "yolov7-anchor.yaml": v5AnchorLoss, "yolov7-seg.yaml": v8SegmentationLoss,
            "yolov7-pose.yaml": v8PoseLoss, "yolov7-obb.yaml": v8OBBLoss}
    for name, criterion in crit.items():
        model = _port(name, NARROW)
        parts = task_map[model.task]
        parts["predictor"](model, args)
        assert isinstance(model.model[-1], parts["validator"].head_types)
        trainer = parts["trainer"](model, {"device": "cpu", "save_dir": str(tmp_path / name)})
        assert type(trainer.criterion) is criterion
    parts = task_map["detect"]
    parts["predictor"](_port("yolov7.yaml", NARROW), {**args, "augment": True})
    with pytest.raises(NotImplementedError, match="augment"):
        task_map["segment"]["predictor"](_port("yolov7-seg.yaml", NARROW), {**args, "augment": True})


# -- MHSA: written weights at another size -----------------------------------------------------

@pytest.mark.parametrize("write", ["load_state_dict", "in_place"])
def test_written_mhsa_weights_survive_a_call_at_another_size(write):
    """`YOLO("yolov8n-MHSA.yaml")`, its weights written through the module's
    own load_state_dict or in place, then predict at 320 px: the port raises
    a ValueError naming rel_h and keeps the written weights (the model stays
    bound to 640 and predicts there with them); the JAX facade, given the
    same written variables, raises ScopeParamShapeError naming rel_h. A
    model left as built is rebuilt at the call's size."""
    from flax.errors import ScopeParamShapeError

    from ultralytics_pro_tpu import YOLO as JYOLO
    from ultralytics_pro_tpu_torch import YOLO

    img = np.zeros((40, 48, 3), np.uint8)
    py = YOLO("yolov8n-MHSA.yaml", device="cpu")
    seed = {k: v.clone() for k, v in py.model.state_dict().items()}
    written = {k: v * 1.5 if v.is_floating_point() else v for k, v in seed.items()}
    if write == "load_state_dict":
        py.model.load_state_dict(written)
    else:
        with torch.no_grad():
            for k, t in py.model.state_dict().items():
                t.copy_(written[k])
    jy = JYOLO("yolov8n-MHSA.yaml")
    jy.model.variables = torch_state_dict_to_jax(written)
    with pytest.raises(ScopeParamShapeError, match="rel_h"):
        jy.predict([img], imgsz=320, conf=0.5)
    with pytest.raises(ValueError, match="rel_h"):
        py.predict([img], imgsz=320, conf=0.5)
    assert py.model.imgsz == 640 and py.model.model[10].rel_h.shape == (1, 4, 64, 20, 1)
    assert all(torch.equal(v, written[k]) for k, v in py.model.state_dict().items())
    py.predict([img], imgsz=640, conf=0.5)
    assert all(torch.equal(v, written[k]) for k, v in py.model.state_dict().items())
    fresh = YOLO("yolov8n-MHSA.yaml", device="cpu")
    fresh.predict([img], imgsz=96, conf=0.5)
    assert fresh.model.imgsz == 96 and torch.equal(fresh.model.model[0].conv.weight, seed["model.0.conv.weight"])
