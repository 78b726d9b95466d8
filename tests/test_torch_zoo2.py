"""The P6/P7, YOLOv6, YOLOv3, YOLOX, YOLOv9/GELAN, YOLO12 and anchor-based
YOLOv5 families of the port against the JAX package, on the CPU.

1. YAMLs: the port's copies parse to what `yaml.safe_load` gives for the
   JAX package's files (the v6 task files and yoloX-seg are PyYAML's block
   dumps).
2. Blocks: each new block against its JAX module on seeded random variables
   carried through `jax_to_torch_state_dict` (a strict load), NHWC for JAX
   and NCHW for the port; A2C2f at an odd size (the area falls back to 1)
   and with scale l's residual gamma. Tolerance: atol 1e-5 times the
   output's largest magnitude (f32, summation order differs).
3. ADown's pool keeps H x W as the JAX package's does; the reference's
   `avg_pool2d(2, 1, 0)` gives (H-1) x (W-1): the same output size but
   another last row and column at even sizes, another size at odd ones.
4. Heads: DDetect, DSegment and AnchorDetect in train and eval mode; raw maps
   and decoded boxes within 1e-5 of their largest magnitude, scores within
   1e-5.
5. Whole models: each of the 17 YAMLs loads the JAX package's seeded
   variables strictly, carries them back to the same flax tree, and meets
   the JAX task model's `apply` at 64 px (128 for P6/P7), boxes within 1e-3
   px, scores within 1e-5, the other columns (mask coefficients, keypoints,
   angles) and the prototypes within 1e-5 of their largest magnitude. The
   fixed-width YAMLs (v3, v9, GELAN, v5-anchor) run narrowed, depth 0.33
   and width 0.25, as dicts; scale n for the others.
6. `v5AnchorLoss` and its gradient against the JAX criterion (a GT centre
   on a cell edge, one on a half-cell line, an image without objects):
   parts and total within 1e-5 relative, gradients within 1e-4 of their
   largest magnitude; where the padded GT slots hold 0 x 0 boxes the JAX
   gradient has NaNs and the port's does not.
7. A narrowed yolov5-anchor's predict and val against the JAX facade (K1's
   plain version as the NMS on the CPU).
"""

from functools import partial
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tests.conftest import FIXTURES
from tests.test_torch_modules import carry, nchw, randomize, to_nhwc, torch_threads  # noqa: F401 (autouse fixture)
from tests.test_torch_train import leaves, same_images_as_jax
from tests.test_torch_zoo import _close
from ultralytics_pro_tpu_torch import YOLO
from ultralytics_pro_tpu_torch.nn.modules import block as B
from ultralytics_pro_tpu_torch.nn.modules import v9v12 as V
from ultralytics_pro_tpu_torch.nn.modules.conv import Conv
from ultralytics_pro_tpu_torch.nn.modules.head import AnchorDetect, DDetect, DSegment
from ultralytics_pro_tpu_torch.nn.tasks import guess_model_task, model_class_for, parse_model, yaml_model_load
from ultralytics_pro_tpu_torch.utils import PKG_ROOT, miniyaml
from ultralytics_pro_tpu_torch.utils.loss import v5AnchorLoss
from ultralytics_pro_tpu_torch.utils.weights import jax_to_torch_state_dict, torch_state_dict_to_jax

NARROW = {"depth_multiple": 0.33, "width_multiple": 0.25}
# the name given to YOLO(...), its file under cfg/models, the test's image size
YAMLS = {
    "yolov8n-p6.yaml": ("v8/yolov8-p6.yaml", 128),
    "yolov8n-p7.yaml": ("v8/yolov8-p7.yaml", 128),
    "yolov8n-seg-p6.yaml": ("v8/yolov8-seg-p6.yaml", 128),
    "yolov5n-p6.yaml": ("v5/yolov5-p6.yaml", 128),
    "yolov6n.yaml": ("v6/yolov6.yaml", 64),
    "yolov6n-seg.yaml": ("v6/yolov6-seg.yaml", 64),
    "yolov6n-pose.yaml": ("v6/yolov6-pose.yaml", 64),
    "yolov6n-obb.yaml": ("v6/yolov6-obb.yaml", 64),
    "yolov3.yaml": ("v3/yolov3.yaml", 64),
    "yolov3-spp.yaml": ("v3/yolov3-spp.yaml", 64),
    "yoloX.yaml": ("x/yoloX.yaml", 64),
    "yoloX-seg.yaml": ("x/yoloX-seg.yaml", 64),
    "yolov9c.yaml": ("v9/yolov9c.yaml", 64),
    "gelan-c.yaml": ("v9/gelan-c.yaml", 64),
    "gelan-c-dseg.yaml": ("v9/gelan-c-dseg.yaml", 64),
    "yolo12n.yaml": ("12/yolo12.yaml", 64),
    "yolov5-anchor.yaml": ("v5/yolov5-anchor.yaml", 64),
}
JAX_MODELS = Path(__file__).resolve().parents[1] / "ultralytics_pro_tpu" / "cfg" / "models"


def narrowed(d: dict) -> dict:
    """A fixed-width YAML (no `scales`) at depth 0.33 and width 0.25."""
    return d if d.get("scales") else {**d, **NARROW}


@pytest.mark.parametrize("name", list(YAMLS))
def test_yaml_copy_equals_the_jax_package_file(name):
    import yaml

    rel = YAMLS[name][0]
    assert miniyaml.load(PKG_ROOT / "cfg" / "models" / rel) == yaml.safe_load((JAX_MODELS / rel).read_text())


# -- blocks -----------------------------------------------------------------------

def _jv9():
    from ultralytics_pro_tpu.nn.modules import v9v10v12

    return v9v10v12


def _jblock():
    from ultralytics_pro_tpu.nn.modules import block

    return block


# (JAX module factory, port module factory, input channels, map size)
BLOCKS = {
    "SPP": (lambda: _jblock().SPP(c2=32), lambda: B.SPP(16, 32), 16, 8),
    "Bottleneck": (lambda: _jblock().Bottleneck(c2=32), lambda: B.Bottleneck(32, 32), 32, 8),
    "Bottleneck_no_shortcut": (lambda: _jblock().Bottleneck(c2=32, shortcut=False),
                               lambda: B.Bottleneck(32, 32, False), 32, 8),
    "RepNBottleneck": (lambda: _jv9().RepNBottleneck(c2=16), lambda: V.RepNBottleneck(16, 16), 16, 8),
    "RepNCSP": (lambda: _jv9().RepNCSP(c2=32, n=2), lambda: V.RepNCSP(16, 32, 2), 16, 8),
    "RepNCSPELAN4": (lambda: _jv9().RepNCSPELAN4(c2=32, c3=32, c4=16, n=2),
                     lambda: V.RepNCSPELAN4(16, 32, 32, 16, 2), 16, 8),
    "ADown": (lambda: _jv9().ADown(c2=32), lambda: V.ADown(16, 32), 16, 8),
    "ADown_odd": (lambda: _jv9().ADown(c2=32), lambda: V.ADown(16, 32), 16, 7),
    "SPPELAN": (lambda: _jv9().SPPELAN(c2=32, c3=16), lambda: V.SPPELAN(16, 32, 16), 16, 8),
    "AAttn_area4": (lambda: _jv9().AAttn(dim=64, num_heads=2, area=4), lambda: V.AAttn(64, 2, 4), 64, 8),
    "AAttn_odd_area1": (lambda: _jv9().AAttn(dim=64, num_heads=2, area=4), lambda: V.AAttn(64, 2, 4), 64, 7),
    "ABlock": (lambda: _jv9().ABlock(dim=64, num_heads=2, mlp_ratio=1.2, area=4), lambda: V.ABlock(64, 2, 1.2, 4),
               64, 8),
    "A2C2f": (lambda: _jv9().A2C2f(c2=64, n=2, area=4), lambda: V.A2C2f(32, 64, 2, True, 4), 32, 8),
    "A2C2f_odd": (lambda: _jv9().A2C2f(c2=64, n=1, area=4), lambda: V.A2C2f(32, 64, 1, True, 4), 32, 7),
    "A2C2f_scale_l_gamma": (lambda: _jv9().A2C2f(c2=64, n=1, area=4, residual=True, mlp_ratio=1.2),
                            lambda: V.A2C2f(64, 64, 1, True, 4, True, 1.2), 64, 8),
    "A2C2f_c3": (lambda: _jv9().A2C2f(c2=64, n=1, a2=False, area=-1), lambda: V.A2C2f(64, 64, 1, False, -1), 64, 8),
}


@pytest.mark.parametrize("case", list(BLOCKS))
def test_block_matches_jax(case):
    make_jax, make, c1, hw = BLOCKS[case]
    x = np.random.default_rng(1).normal(0, 1, (2, hw, hw, c1)).astype(np.float32)
    jm, tm = make_jax(), make()
    v = carry(jm, x, tm, seed=2)
    want = jm.apply(v, x, train=False)
    with torch.no_grad():
        got = to_nhwc(tm(nchw(x)))
    assert got.shape == want.shape
    _close(got, want)


def test_block_names_are_the_reference_ones():
    """RepNCSPELAN4's nn.Sequential children, A2C2f's stages, ABlock's mlp,
    AAttn's four convs (JAX's, not the reference's qkv) and gamma."""
    elan = set(V.RepNCSPELAN4(16, 32, 32, 16, 1).state_dict())
    assert {"cv2.0.m.0.cv1.conv1.conv.weight", "cv2.0.cv3.conv.weight", "cv2.1.conv.weight",
            "cv3.0.cv1.bn.running_mean", "cv3.1.bn.weight", "cv4.conv.weight"} <= elan
    a2 = V.A2C2f(64, 64, 1, True, 4, True, 1.2)
    names = set(a2.state_dict())
    assert {"gamma", "m.0.0.attn.qk.conv.weight", "m.0.0.attn.v.conv.weight", "m.0.1.attn.pe.conv.weight",
            "m.0.1.attn.proj.conv.weight", "m.0.1.mlp.0.conv.weight", "m.0.0.mlp.1.bn.running_var"} <= names
    assert a2.m[0][0].attn.num_heads == 1 and a2.m[0][0].attn.pe.conv.kernel_size == (7, 7)
    assert torch.equal(a2.gamma, torch.full((64,), 0.01))
    assert V.A2C2f(32, 64, 1, True, 4, True, 1.2).gamma is None  # c1 != c2: no residual
    assert V.A2C2f(256, 256, 1).m[0][0].attn.num_heads == 4
    assert "m.0.m.1.cv2.conv.weight" in V.A2C2f(64, 64, 1, False).state_dict()


def test_adown_pool_keeps_the_size_where_the_reference_shrinks():
    """The port pools as the JAX package does. The reference's form, on the
    same convs, agrees except at the last output row and column at even
    sizes (where the JAX pool reads a zero-padded window) and gives another
    size at odd ones."""
    def reference_adown(m, x):
        x1, x2 = F.avg_pool2d(x, 2, 1, 0, False, True).chunk(2, 1)
        return torch.cat([m.cv1(x1), m.cv2(F.max_pool2d(x2, 3, 2, 1))], 1)

    torch.manual_seed(0)
    m = V.ADown(8, 16).eval()
    for hw in (8, 7):
        x = torch.randn(1, 8, hw, hw)
        pooled = V.avg_pool_same(x)
        assert pooled.shape[-2:] == (hw, hw)
        torch.testing.assert_close(pooled[..., :-1, :-1], F.avg_pool2d(x, 2, 1, 0), rtol=0, atol=1e-7)
        with torch.no_grad():
            ours, ref = m(x), reference_adown(m, x)
        if hw % 2:
            assert ours.shape[-2:] == (4, 4) and ref.shape[-2:] == (3, 3)
            continue
        assert ours.shape == ref.shape == (1, 16, 4, 4)
        torch.testing.assert_close(ours[..., :-1, :-1], ref[..., :-1, :-1], rtol=0, atol=1e-6)
        assert (ours[:, :8, -1] - ref[:, :8, -1]).abs().min() > 0  # the avg-pool branch's last row
        assert (ours[:, 8:, -1] - ref[:, 8:, -1]).abs().max() > 1e-3  # the max-pool branch sees the new row


# -- heads ------------------------------------------------------------------------

def _head_feats(rng, chans, sizes):
    return [rng.normal(0, 1, (2, h, h, c)).astype(np.float32) for c, h in zip(chans, sizes)]


HEADS = {  # JAX head factory, port head factory, input channels, map sizes
    "DDetect": (lambda h: h.DDetect(nc=5), lambda: DDetect(5, (32, 64, 64)), (32, 64, 64), (8, 4, 2)),
    "DSegment": (lambda h: h.DSegment(nc=5, nm=8, npr=16), lambda: DSegment(5, (32, 64, 64, 24), 8, 16),
                 (32, 64, 64, 24), (8, 4, 2, 16)),
    "AnchorDetect": (lambda h: h.AnchorDetect(nc=5), lambda: AnchorDetect(5, (32, 64, 64)), (32, 64, 64), (8, 4, 2)),
}


@pytest.mark.parametrize("mode", ["train", "eval"])
@pytest.mark.parametrize("name", list(HEADS))
def test_head_matches_jax(name, mode):
    import jax

    from ultralytics_pro_tpu.nn.modules import head as jhead

    make_jax, make, chans, sizes = HEADS[name]
    feats = _head_feats(np.random.default_rng(3), chans, sizes)
    jm, head = make_jax(jhead), make()
    shapes = jax.eval_shape(lambda x: jm.init(jax.random.PRNGKey(0), x, train=False), feats)
    v = randomize(jax.tree_util.tree_map(lambda a: np.zeros(a.shape, np.float32), shapes), 4)
    head.load_state_dict(jax_to_torch_state_dict(v))  # strict
    head.stride = torch.tensor([8.0, 16.0, 32.0])
    tf = [nchw(f) for f in feats]
    if mode == "train":  # train-mode BN: batch statistics
        want = jax.jit(lambda v, x: jm.apply(v, x, train=True, mutable=["batch_stats"])[0])(v, feats)
        with torch.no_grad():
            got = head.train()(tf, decode=False)
        got = got if isinstance(got, dict) else {"feats": got}
        keys = ["feats", "anchor_feats"] if name == "AnchorDetect" else ["feats"]
        for key in keys:
            for g, w in zip(got[key], want[key]):
                _close(to_nhwc(g), w)
        if name == "DSegment":
            _close(to_nhwc(got["protos"]), want["protos"])
            _close(got["mc"].numpy(), want["mc"])
        return
    y, aux = jax.jit(lambda v, x: jm.apply(v, x, train=False))(v, feats)
    with torch.no_grad():
        got, got_aux = head.eval()(tf)
    want = np.asarray(y)
    assert got.shape == want.shape
    _close(got[..., :4].numpy(), want[..., :4])
    np.testing.assert_allclose(got[..., 4:9].numpy(), want[..., 4:9], atol=1e-5, rtol=0)
    raw = got_aux["feats"] if isinstance(got_aux, dict) else got_aux
    for g, w in zip(raw, aux["feats"]):
        _close(to_nhwc(g), w)
    if name == "DSegment":
        _close(got[..., 9:].numpy(), want[..., 9:])
        _close(to_nhwc(got_aux["protos"]), aux["protos"])


def test_ddetect_and_anchor_heads_take_the_jax_shapes():
    """DDetect's box branch of 4 groups, its width rounded to 4, bias 1.0;
    AnchorDetect's anchors in (h, w, na) order: a map whose box logits are 0
    decodes each cell's three anchors in turn."""
    d = DDetect(80, (100, 64, 64))
    d.stride = torch.tensor([8.0, 16.0, 32.0])
    d.bias_init()
    assert (d.c2, d.c3) == (64, 128) and d.cv2[0][2].groups == 4 and d.cv2[0][1].conv.groups == 4
    assert torch.equal(d.cv2[0][2].bias, torch.ones(64))
    a = AnchorDetect(2, (8,))
    a.stride = torch.tensor([8.0])
    with torch.no_grad():
        a.m[0].weight.zero_()
        a.m[0].bias.zero_()
        y = a.decode(a.raw([torch.zeros(1, 8, 2, 3)]))
    assert y.shape == (1, 2 * 3 * 3, 6)
    np.testing.assert_allclose(y[0, :3, 2:4].numpy(), np.array([[10, 13], [16, 30], [33, 23]], np.float32))
    np.testing.assert_allclose(y[0, ::3, :2].numpy(), np.array([[4, 4], [12, 4], [20, 4], [4, 12], [12, 12],
                                                               [20, 12]], np.float32))
    np.testing.assert_allclose(y[0, :, 4:].numpy(), 0.25)


# -- whole models --------------------------------------------------------------------

def jax_and_port(name: str, seed: int, d: dict | None = None):
    """The JAX task model and the port's for a YAML (narrowed if fixed-width,
    or the dict d), on the same seeded random variables: their layout from
    the JAX init that the model's own stride probe traces (`_infer_strides`
    runs it under `jax.eval_shape` at 256 px; no compile, and the layout does
    not depend on the image size), loaded into the port strictly. Returns
    (JAX model, variables, port model)."""
    import jax

    from ultralytics_pro_tpu.nn.tasks import guess_model_task as jtask
    from ultralytics_pro_tpu.nn.tasks import model_class_for as jclass
    from ultralytics_pro_tpu.nn.tasks import yaml_model_load as jyaml

    jd = d if d is not None else narrowed(jyaml(name))
    inits, eval_shape = [], jax.eval_shape

    def spy(fn, *args, **kwargs):
        out = eval_shape(fn, *args, **kwargs)
        if isinstance(fn, partial) and getattr(fn.func, "__name__", "") == "init":
            inits.append(out)
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "eval_shape", spy)
        jm = jclass(jd, jtask(jd))(dict(jd))
    (shapes,) = inits
    variables = randomize(jax.tree_util.tree_map(lambda a: np.zeros(a.shape, np.float32), shapes), seed)
    pd = d if d is not None else narrowed(yaml_model_load(name))
    port = model_class_for(guess_model_task(pd))(pd)
    port.load_state_dict(jax_to_torch_state_dict(variables))  # strict
    return jm, variables, port


@pytest.mark.parametrize("name", list(YAMLS))
def test_model_forward_matches_jax(name):
    import jax

    jm, variables, port = jax_and_port(name, seed=8)
    back = dict(leaves(torch_state_dict_to_jax(port.state_dict())))
    assert back.keys() == dict(leaves(variables)).keys()  # the carrier maps every name both ways
    for k, w in leaves(variables):
        np.testing.assert_array_equal(back[k], w, err_msg="/".join(k))
    assert port.stride.tolist() == [float(s) for s in jm.stride]
    s = YAMLS[name][1]
    x = np.random.default_rng(9).uniform(0, 1, (2, 3, s, s)).astype(np.float32)
    want, aux = jax.jit(lambda v, xx: jm.apply(v, xx, train=False))(variables, x.transpose(0, 2, 3, 1))
    want = np.asarray(want)
    with torch.no_grad():
        got, got_aux = port(torch.from_numpy(x))
    got, nc = got.numpy(), port.nc
    assert got.shape == want.shape
    np.testing.assert_allclose(got[..., :4], want[..., :4], atol=1e-3, rtol=0)
    np.testing.assert_allclose(got[..., 4:4 + nc], want[..., 4:4 + nc], atol=1e-5, rtol=0)
    if got.shape[-1] > 4 + nc:
        _close(got[..., 4 + nc:], want[..., 4 + nc:])
    if isinstance(got_aux, dict) and "protos" in got_aux:
        _close(to_nhwc(got_aux["protos"]), aux["protos"])


def test_new_yamls_build_as_the_jax_package_builds_them():
    """YOLOX's six maps and repeated strides; v6's transposed convs and ReLU,
    with SiLU back for the next model; YOLO12's light head and A2C2f's n
    from the repeats, gamma only at l and x; yolov9c's RepNCSPELAN4 ignoring
    the repeats; gelan-c-dseg's three strides (its fourth input is the
    prototypes' source); yolov5-anchor's 25,200 rows
    at 640 px."""
    x = DetectionModel_from("yoloX.yaml")
    assert x.model[-1].nl == 6 and x.stride.tolist() == [8.0, 8.0, 16.0, 16.0, 32.0, 32.0]
    v6 = DetectionModel_from("yolov6n.yaml")
    assert isinstance(v6.model[11], torch.nn.ConvTranspose2d) and v6.model[11].bias is not None
    assert {type(m.act).__name__ for m in v6.modules() if isinstance(m, Conv)} == {"ReLU"}
    assert {type(m.act).__name__ for m in DetectionModel_from("yolov8n.yaml").modules()
            if isinstance(m, Conv)} == {"SiLU"}
    layers, _, _ = parse_model(yaml_model_load("yolo12n.yaml"))
    assert layers[-1].legacy is False and len(layers[6].m) == 2 and layers[6].gamma is None
    layers, _, _ = parse_model(yaml_model_load("yolo12l.yaml"))
    assert layers[6].gamma is not None and layers[6].m[0][0].mlp[0].conv.out_channels == int(256 * 1.2)
    layers, _, _ = parse_model(yaml_model_load("yolov9c.yaml"))
    assert isinstance(layers[2], V.RepNCSPELAN4) and len(layers[2].cv2[0].m) == 1
    seg = DetectionModel_from("gelan-c-dseg.yaml", NARROW)
    assert seg.stride.tolist() == [8.0, 16.0, 32.0] and isinstance(seg.model[-1], DSegment)
    a = DetectionModel_from("yolov5-anchor.yaml", NARROW)
    assert a.model[-1].anchor_list[2][2] == (373.0, 326.0)
    assert sum(3 * (640 // s) ** 2 for s in a.stride.int().tolist()) == 25200


def DetectionModel_from(name: str, extra: dict | None = None):
    d = {**yaml_model_load(name), **(extra or {})}
    return model_class_for(guess_model_task(d))(d)


# -- v5AnchorLoss ----------------------------------------------------------------------

def _anchor_loss_case(zero_pad: bool):
    """Random maps of 3 anchors at 64 px (8 x 8, 4 x 4, 2 x 2), nc 4, a padded
    batch: a GT centred on a cell edge (x = 3 cells exactly: the left
    neighbour), one on a half-cell line (y = 2.5 cells: the lower), an image
    without objects. The padded slots hold 0 x 0 boxes as the loaders pad
    them, or a box of 0.5."""
    rng = np.random.default_rng(12)
    b, nc, g = 3, 4, 5
    maps = [rng.normal(0, 2, (b, 3 * (5 + nc), h, h)).astype(np.float32) for h in (8, 4, 2)]
    mask = np.array([[1, 1, 1, 0, 0], [0, 0, 0, 0, 0], [1, 1, 1, 1, 0]], bool)
    cls = (rng.integers(0, nc, (b, g)) * mask).astype(np.float32)
    xywh = np.concatenate([rng.uniform(0.1, 0.9, (b, g, 2)), rng.uniform(0.1, 0.6, (b, g, 2))], -1)
    xywh[0, 0, :2] = (3 / 8, 0.4)  # on a cell edge of the 8 x 8 level
    xywh[0, 1, :2] = (0.55, 2.5 / 8)  # on a half-cell line
    boxes = np.where(mask[..., None], xywh, 0.0 if zero_pad else 0.5).astype(np.float32)
    return maps, {"cls": cls, "bboxes": boxes, "mask_gt": mask}, nc


def _anchor_losses(maps, batch, nc):
    """(JAX total, parts, gradients), (port total, parts, map tensors with .grad)."""
    import jax
    import jax.numpy as jnp

    from ultralytics_pro_tpu.nn.modules.head import V5_ANCHORS
    from ultralytics_pro_tpu.utils.loss import v5AnchorLoss as JLoss

    hyp = {"box": 0.05, "cls": 0.5, "obj": 1.0}

    def jloss(m):
        preds = {"anchor_feats": [f.transpose(0, 2, 3, 1) for f in m]}
        return JLoss(nc, V5_ANCHORS, (8, 16, 32), hyp)(preds, {k: jnp.asarray(v) for k, v in batch.items()}, 64)

    (jt, jparts), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))([jnp.asarray(f) for f in maps])
    tm = [torch.tensor(f, requires_grad=True) for f in maps]
    tt, tparts = v5AnchorLoss(nc, V5_ANCHORS, (8, 16, 32), hyp)(
        {"anchor_feats": tm}, {k: torch.from_numpy(v) for k, v in batch.items()}, (64, 64))
    tt.backward()
    return (jt, jparts, [np.asarray(g) for g in jgrads]), (tt.detach(), tparts, tm)


def test_v5_anchor_loss_and_its_gradient_match_jax():
    (jt, jparts, jgrads), (tt, tparts, tm) = _anchor_losses(*_anchor_loss_case(zero_pad=False))
    assert list(tparts) == ["box", "obj", "cls"] and set(jparts) == set(tparts)
    assert all(float(jparts[k]) > 1e-3 for k in jparts)
    for k in jparts:
        assert float(tparts[k].detach()) == pytest.approx(float(jparts[k]), rel=1e-5), k
    assert float(tt) == pytest.approx(float(jt), rel=1e-5)
    for got, want in zip(tm, jgrads):
        np.testing.assert_allclose(got.grad.numpy(), want, atol=1e-4 * np.abs(want).max(), rtol=0)


def test_v5_anchor_loss_gradient_is_finite_on_padded_slots():
    """Where the padded slots hold 0 x 0 boxes, as both loaders pad them, the
    JAX criterion's CIoU of those masked candidates is NaN and, multiplied
    by their mask of 0, leaves NaN in the gradient of the cells they point
    at; the port scores them against a unit box, so its loss is the JAX
    one's (within 1e-5 relative) and its gradient equals the JAX one
    wherever that is finite, and is finite everywhere."""
    (jt, jparts, jgrads), (tt, tparts, tm) = _anchor_losses(*_anchor_loss_case(zero_pad=True))
    assert float(tt) == pytest.approx(float(jt), rel=1e-5)
    assert all(np.isnan(g).any() for g in jgrads)
    for got, want in zip(tm, jgrads):
        g = got.grad.numpy()
        assert np.isfinite(g).all()
        ok = np.isfinite(want)
        np.testing.assert_allclose(g[ok], want[ok], atol=1e-4 * np.abs(want[ok]).max(), rtol=0)


def test_v5_anchor_loss_objectness_is_a_scatter_max():
    """Two GTs whose candidates share cells: each (cell, anchor) target is the
    larger IoU whatever the order of the GT slots, and one class gives no
    class term."""
    rng = np.random.default_rng(13)
    maps = [torch.from_numpy(rng.normal(0, 1, (1, 3 * 6, h, h)).astype(np.float32)) for h in (8, 4, 2)]
    boxes = np.array([[[0.40, 0.40, 0.30, 0.30], [0.42, 0.41, 0.32, 0.28], [0, 0, 0, 0]]], np.float32)
    batch = {"cls": torch.zeros(1, 3), "bboxes": torch.from_numpy(boxes), "mask_gt": torch.tensor([[1.0, 1.0, 0.0]])}
    swapped = {**batch, "bboxes": torch.from_numpy(boxes[:, [1, 0, 2]].copy())}
    loss = v5AnchorLoss(1, AnchorDetect(1, (8, 8, 8)).anchor_list, (8, 16, 32))
    (t1, p1), (t2, p2) = loss(maps, batch, (64, 64)), loss(maps, swapped, (64, 64))
    assert float(p1["cls"]) == 0.0 and float(p1["obj"]) > 0
    for k in p1:
        assert float(p1[k]) == pytest.approx(float(p2[k]), rel=1e-6, abs=1e-9), k


# -- predict and val of the anchor head, end to end --------------------------------------

@pytest.fixture(scope="module")
def anchor_pair():
    """A narrowed yolov5-anchor at nc 3 in both facades, on the same seeded random variables."""
    from ultralytics_pro_tpu import YOLO as JYOLO
    from ultralytics_pro_tpu.nn.tasks import yaml_model_load as jyaml

    jd = {**jyaml("yolov5-anchor.yaml"), **NARROW, "nc": 3}
    pd = {**yaml_model_load("yolov5-anchor.yaml"), **NARROW, "nc": 3}
    jyolo = JYOLO(dict(jd))
    _, jyolo.model.variables, _ = jax_and_port("yolov5-anchor.yaml", seed=10, d=jd)
    port = YOLO(pd, device="cpu")
    port.load_state_dict(jax_to_torch_state_dict(jyolo.model.variables))
    return port, jyolo


def test_anchor_predict_matches_jax(anchor_pair):
    """Single-label NMS (K1's plain version) over the 252 decoded rows: the
    same detections in the same order, boxes within 1e-3 px, scores 1e-5."""
    rng = np.random.default_rng(11)
    imgs = [rng.integers(0, 256, (64, 48, 3), dtype=np.uint8), rng.integers(0, 256, (40, 64, 3), dtype=np.uint8)]
    port, jyolo = anchor_pair
    kw = dict(imgsz=64, conf=0.05)
    got, ref = port.predict(imgs, **kw), jyolo.predict(imgs, **kw)
    assert sum(len(r.boxes.data) for r in got) > 0
    for g, r in zip(got, ref):
        rd = np.asarray(r.boxes.data)
        assert len(g.boxes.data) == len(rd)
        np.testing.assert_array_equal(g.boxes.cls, rd[:, 5])
        np.testing.assert_allclose(g.boxes.xyxy, rd[:, :4], atol=1e-3, rtol=0)
        np.testing.assert_allclose(g.boxes.conf, rd[:, 4], atol=1e-5, rtol=0)


def test_anchor_val_matches_jax(anchor_pair, tmp_path, monkeypatch):
    """Each batch's multi-label NMS rows (valid and cls equal, scores within
    1e-5, boxes 1e-3 px) and the metrics of the whole val (every key within
    1e-6); both loaders shrink with cv2's INTER_AREA here."""
    import shutil

    from ultralytics_pro_tpu.engine.validator import DetectionValidator as JVal
    from ultralytics_pro_tpu_torch.engine.validator import DetectionValidator

    data = shutil.copytree(f"{FIXTURES}/torch_val_synth", tmp_path / "set") / "data.yaml"
    port, jyolo = anchor_pair
    rows = {"port": [], "jax": []}
    run, build = DetectionValidator.run, JVal._build_jit

    def jax_build(self, model):
        f = build(self, model)
        return lambda v, img: rows["jax"].append(f(v, img)) or rows["jax"][-1]

    monkeypatch.setattr(DetectionValidator, "run", lambda self, img: rows["port"].append(run(self, img)) or
                        rows["port"][-1])
    monkeypatch.setattr(JVal, "_build_jit", jax_build)
    kw = dict(imgsz=64, batch=8, conf=0.001)
    with same_images_as_jax():
        got = port.val(data=str(data), **kw)
    want = jyolo.val(data=str(data), plots=False, **kw)
    for k, v in want.results_dict.items():
        assert got.results_dict[k] == pytest.approx(float(v), abs=1e-6), k
    assert len(rows["port"]) == len(rows["jax"]) == 2
    for out, ref in zip(rows["port"], rows["jax"]):
        assert out["boxes"].shape == (8, 300, 4) and int(out["valid"].sum()) > 0
        np.testing.assert_array_equal(out["valid"].numpy(), np.asarray(ref["valid"]))
        np.testing.assert_array_equal(out["cls"].numpy(), np.asarray(ref["cls"]))
        np.testing.assert_allclose(out["scores"].numpy(), np.asarray(ref["scores"]), atol=1e-5, rtol=0)
        np.testing.assert_allclose(out["boxes"].numpy(), np.asarray(ref["boxes"]), atol=1e-3, rtol=0)
