"""The YOLO11, YOLOv10, YOLOv5 and YOLOv3-tiny detect families of the port
against the JAX package (and the torch reference's recorded outputs), on the CPU.

1. Blocks: each new block of `nn/modules/block.py` against its JAX module on
   seeded random variables carried through `jax_to_torch_state_dict` (a
   strict load, so every parameter name and shape must match), NHWC for JAX
   and NCHW for the port. Tolerance: atol 1e-5 times the output's largest
   magnitude (f32, summation order differs between XLA and PyTorch).
2. Heads: `Detect(legacy=False)` and `v10Detect`, train and eval mode, the
   same way; decoded boxes within 1e-5 of their largest magnitude, scores
   within 1e-5, v10's top-k rows in the same order with the same classes.
3. Whole models at 64 px: yolo11n, yolov10n, yolov5n and yolov3-tiny against
   `DetectionModel(...).apply` on seeded random variables, boxes within 1e-3
   px and scores within 1e-5 (tests/test_torch_model.py's limits); yolov5s
   and yolov3-tiny against the torch reference's recorded outputs with its
   `sd::` state_dict loaded strictly, boxes within 1e-3 px and scores within
   1e-5 (tests/test_model_parity.py holds the JAX package to 5e-2 and 2e-3).
4. v10's top-k on rows with tied scores against the JAX `postprocess_topk`:
   equal indices, values and boxes.
5. yolov10n predict and val on the detect fixture set against the JAX
   predictor and validator, with no NMS called.
6. `E2EDetectLoss` and its gradient against the JAX criterion: parts within
   1e-5 relative, gradients within 1e-4 of their largest magnitude.
"""

import numpy as np
import pytest
import torch

from tests.conftest import FIXTURES, load_fixture
from tests.test_torch_modules import carry, nchw, randomize, to_nhwc, torch_threads  # noqa: F401 (autouse fixture)
from tests.test_torch_train import same_images_as_jax
from ultralytics_pro_tpu_torch import YOLO
from ultralytics_pro_tpu_torch.nn.modules import block as B
from ultralytics_pro_tpu_torch.nn.modules.head import Detect, v10Detect
from ultralytics_pro_tpu_torch.nn.tasks import DetectionModel, parse_model, yaml_model_load
from ultralytics_pro_tpu_torch.utils.loss import E2EDetectLoss
from ultralytics_pro_tpu_torch.utils.weights import jax_to_torch_state_dict, load_torch_state_dict_file


def _close(got, want, tol=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, atol=tol * max(np.abs(want).max(), 1.0), rtol=0)


# (JAX class name, JAX kwargs, port module, input channels, map size)
BLOCKS = {
    "C3": ("C3", dict(c2=32, n=2), lambda: B.C3(16, 32, 2), 16, 8),
    "C3_no_shortcut": ("C3", dict(c2=32, n=1, shortcut=False), lambda: B.C3(32, 32, 1, False), 32, 8),
    "C3k": ("C3k", dict(c2=32, n=2), lambda: B.C3k(32, 32, 2), 32, 8),
    "C3k2": ("C3k2", dict(c2=32, n=2, e=0.25, shortcut=True), lambda: B.C3k2(16, 32, 2, False, 0.25), 16, 8),
    "C3k2_c3k": ("C3k2", dict(c2=32, n=1, c3k=True, shortcut=True), lambda: B.C3k2(32, 32, 1, True), 32, 8),
    "Attention_2_heads": ("Attention", dict(dim=128, num_heads=2, attn_ratio=0.5),
                          lambda: B.Attention(128, 2, 0.5), 128, 4),
    "PSABlock": ("PSABlock", dict(c=128, attn_ratio=0.5, num_heads=2), lambda: B.PSABlock(128, 0.5, 2), 128, 4),
    "PSA_2_heads": ("PSA", dict(c2=256), lambda: B.PSA(256, 256), 256, 4),
    "C2PSA": ("C2PSA", dict(c2=256, n=1), lambda: B.C2PSA(256, 256, 1), 256, 4),
    "C2PSA_narrow": ("C2PSA", dict(c2=64, n=2), lambda: B.C2PSA(64, 64, 2), 64, 4),
    "SCDown": ("SCDown", dict(c2=32, k=3, s=2), lambda: B.SCDown(16, 32, 3, 2), 16, 8),
    "CIB": ("CIB", dict(c2=32, shortcut=True, e=1.0), lambda: B.CIB(32, 32, True, 1.0), 32, 8),
    "C2fCIB": ("C2fCIB", dict(c2=32, n=2, shortcut=True), lambda: B.C2fCIB(16, 32, 2, True), 16, 8),
}


@pytest.mark.parametrize("case", list(BLOCKS))
def test_block_matches_jax(case):
    from ultralytics_pro_tpu.nn.modules import block as jblock

    name, kw, make, c1, hw = BLOCKS[case]
    x = np.random.default_rng(1).normal(0, 1, (2, hw, hw, c1)).astype(np.float32)
    jm, tm = getattr(jblock, name)(**kw), make()
    v = carry(jm, x, tm, seed=2)
    want = jm.apply(v, x, train=False)
    with torch.no_grad():
        got = to_nhwc(tm(nchw(x)))
    assert got.shape == want.shape
    _close(got, want)


def test_block_names_are_the_reference_ones():
    names = set(B.C2PSA(256, 256, 1).state_dict()) | set(B.C2fCIB(16, 32, 1, True).state_dict())
    assert {"m.0.attn.qkv.conv.weight", "m.0.attn.pe.conv.weight", "m.0.attn.proj.conv.weight",
            "m.0.ffn.0.conv.weight", "m.0.ffn.1.bn.running_var"} <= names
    assert {f"m.0.cv1.{i}.conv.weight" for i in range(5)} <= names
    assert "m.0.m.0.cv1.conv.weight" in B.C3k2(32, 32, 1, True).state_dict()
    assert B.PSA(256, 256).attn.num_heads == 2 and B.C2PSA(64, 64).m[0].attn.num_heads == 1


def _head_feats(rng, chans=(32, 64, 64), sizes=(8, 4, 2)):
    return [rng.normal(0, 1, (2, h, h, c)).astype(np.float32) for c, h in zip(chans, sizes)]


def _jax_head(cls, feats, nc, port_head, seed):
    """The JAX head, its seeded variables loaded into port_head, and its
    apply jitted for train mode (with the batch statistics' update) and eval."""
    import jax

    jm = cls(nc=nc, legacy=False)
    shapes = jax.eval_shape(lambda x: jm.init(jax.random.PRNGKey(0), x, train=False), feats)
    v = randomize(jax.tree_util.tree_map(lambda a: np.zeros(a.shape, np.float32), shapes), seed)
    port_head.load_state_dict(jax_to_torch_state_dict(v))  # strict
    port_head.stride = torch.tensor([8.0, 16.0, 32.0])
    port_head.eval()
    train = jax.jit(lambda v, x: jm.apply(v, x, train=True, mutable=["batch_stats"])[0])
    return jax.jit(lambda v, x: jm.apply(v, x, train=False)), train, v


@pytest.mark.parametrize("mode", ["train", "eval"])
def test_light_detect_head_matches_jax(mode):
    from ultralytics_pro_tpu.nn.modules.head import Detect as JDetect

    rng = np.random.default_rng(3)
    feats = _head_feats(rng)
    head = Detect(5, (32, 64, 64), legacy=False)
    assert {"cv3.0.0.0.conv.weight", "cv3.0.0.1.conv.weight", "cv3.0.1.0.conv.weight", "cv3.0.1.1.conv.weight",
            "cv3.0.2.weight"} <= set(head.state_dict())
    assert head.cv3[0][0][0].conv.groups == 32
    apply, apply_train, v = _jax_head(JDetect, feats, 5, head, seed=4)
    if mode == "train":  # train-mode BN: batch statistics
        out = apply_train(v, feats)
        with torch.no_grad():
            got = head.train()([nchw(f) for f in feats], decode=False)
        for g, w in zip(got, out["feats"]):
            _close(to_nhwc(g), w)
        return
    out = apply(v, feats)
    with torch.no_grad():
        got = head([nchw(f) for f in feats])
    y, raw = got
    for g, w in zip(raw, out[1]["feats"]):
        _close(to_nhwc(g), w)
    want = np.asarray(out[0])
    _close(y[..., :4].numpy(), want[..., :4])
    np.testing.assert_allclose(y[..., 4:].numpy(), want[..., 4:], atol=1e-5, rtol=0)


@pytest.mark.parametrize("mode", ["train", "eval"])
def test_v10_head_matches_jax(mode):
    """Train: both branches' raw maps under the JAX keys. Eval: the top 300
    of 84 * 5 (anchor, class) pairs of the one-to-one branch."""
    from ultralytics_pro_tpu.nn.modules.head import v10Detect as JV10

    rng = np.random.default_rng(5)
    feats = _head_feats(rng)
    head = v10Detect(5, (32, 64, 64))
    assert {"one2one_cv2.0.0.conv.weight", "one2one_cv3.2.1.1.bn.weight", "one2one_cv3.0.2.bias"} <= \
        set(head.state_dict())
    apply, apply_train, v = _jax_head(JV10, feats, 5, head, seed=6)
    if mode == "train":  # train-mode BN: batch statistics
        out = apply_train(v, feats)
        tf = [nchw(f).requires_grad_(True) for f in feats]
        got = head.train()(tf, decode=False)
        assert set(got) == {"feats", "one2one"}
        for key in got:
            for g, w in zip(got[key], out[key]):
                _close(to_nhwc(g), w)
        # the one-to-one branch reads the levels detached: its loss reaches no input
        sum(g.sum() for g in got["one2one"]).backward()
        assert all(t.grad is None for t in tf)
        return
    y, aux = apply(v, feats)
    with torch.no_grad():
        got, got_aux = head([nchw(f) for f in feats])
        lean, none = head([nchw(f) for f in feats], aux=False)
    want = np.asarray(y)
    assert got.shape == want.shape == (2, 300, 6) and none is None
    torch.testing.assert_close(lean, got, rtol=0, atol=0)
    np.testing.assert_array_equal(got[..., 5].numpy(), want[..., 5])
    np.testing.assert_allclose(got[..., 4].numpy(), want[..., 4], atol=1e-5, rtol=0)
    _close(got[..., :4].numpy(), want[..., :4])
    for key in ("feats", "one2one"):
        for g, w in zip(got_aux[key], aux[key]):
            _close(to_nhwc(g), w)


def test_v10_topk_ties_match_jax():
    """Scores on a grid of 1/8 (every value tied many times), and a row of
    equal scores: the same (anchor, class) pairs in the same order as
    `lax.top_k`, ties to the lower flat index."""
    import jax.numpy as jnp

    from ultralytics_pro_tpu.nn.modules.head import v10Detect as JV10

    rng = np.random.default_rng(7)
    y = np.concatenate([rng.uniform(0, 64, (3, 84, 4)), np.ceil(rng.uniform(0, 1, (3, 84, 5)) * 8) / 8], -1)
    y[2, :, 4:] = 0.5
    y = y.astype(np.float32)
    for max_det in (300, 50, 1000):  # 1000 > A * nc = 420: every pair
        head = v10Detect(5, (32, 64, 64))
        head.max_det = max_det
        got = head.postprocess_topk(torch.from_numpy(y)).numpy()
        want = np.asarray(JV10(nc=5, max_det=max_det).postprocess_topk(jnp.asarray(y)))
        assert got.shape == want.shape == (3, min(max_det, 420), 6)
        np.testing.assert_array_equal(got, want)


# -- whole models --------------------------------------------------------------

def _jax_and_port(cfg: str, seed: int, nc: int = 80, jm=None):
    """The JAX model (jm, or a new one) and the port's at nc, on the same
    seeded random variables: their layout from the JAX init traced
    (`jax.eval_shape`, no compile), loaded into the port strictly."""
    from functools import partial

    import jax

    from ultralytics_pro_tpu.nn.tasks import DetectionModel as JModel
    from ultralytics_pro_tpu.nn.tasks import yaml_model_load as jyaml

    if jm is None:
        y = jyaml(cfg)
        y["nc"] = nc
        jm = JModel(y)
    shapes = jax.eval_shape(partial(jm.module.init, train=True), jax.random.PRNGKey(0),
                            jax.ShapeDtypeStruct((1, 64, 64, 3), np.float32))
    variables = randomize(jax.tree_util.tree_map(lambda a: np.zeros(a.shape, np.float32), shapes), seed)
    port = DetectionModel({**yaml_model_load(cfg), "nc": nc})
    port.load_state_dict(jax_to_torch_state_dict(variables))  # strict
    return jm, variables, port


@pytest.mark.parametrize("cfg", ["yolo11n.yaml", "yolov10n.yaml", "yolov5n.yaml", "yolov3-tiny.yaml"])
def test_model_forward_matches_jax(cfg):
    import jax

    jm, variables, port = _jax_and_port(cfg, seed=8)
    assert port.stride.tolist() == [float(s) for s in jm.stride]
    legacy = cfg not in ("yolo11n.yaml", "yolov10n.yaml")
    assert port.model[-1].legacy == legacy
    x = np.random.default_rng(9).uniform(0, 1, (2, 3, 64, 64)).astype(np.float32)
    want, aux = jax.jit(lambda v, xx: jm.apply(v, xx, train=False))(variables, x.transpose(0, 2, 3, 1))
    want = np.asarray(want)
    with torch.no_grad():
        got, got_aux = port(torch.from_numpy(x))
    got = got.numpy()
    assert got.shape == want.shape
    for g, w in zip(got_aux["feats"] if isinstance(got_aux, dict) else got_aux, aux["feats"]):
        _close(to_nhwc(g), w, 1e-4)
    if cfg == "yolov10n.yaml":
        assert got.shape == (2, 300, 6)
        np.testing.assert_array_equal(got[..., 5], want[..., 5])
    np.testing.assert_allclose(got[..., :4], want[..., :4], atol=1e-3, rtol=0)
    np.testing.assert_allclose(got[..., 4:], want[..., 4:], atol=1e-5, rtol=0)


@pytest.mark.parametrize("cfg,fixture", [("yolov5s.yaml", "model_yolov5s.npz"),
                                         ("yolov3-tiny.yaml", "model_yolov3tiny.npz")])
def test_model_matches_the_reference_fixture(cfg, fixture):
    """The reference's seeded state_dict loads strictly; its recorded
    decoded output (B, 4 + nc, A) is met within boxes 1e-3 px, scores 1e-5."""
    fx = load_fixture(fixture)
    model = DetectionModel(cfg)
    model.load_state_dict(load_torch_state_dict_file(f"{FIXTURES}/{fixture}"))
    assert model.stride.tolist() == fx["stride"].tolist()
    with torch.no_grad():
        got, _ = model(torch.from_numpy(fx["input"]))
    got = got.numpy().transpose(0, 2, 1)
    assert got.shape == fx["output"].shape
    np.testing.assert_allclose(got[:, :4], fx["output"][:, :4], atol=1e-3, rtol=0)
    np.testing.assert_allclose(got[:, 4:], fx["output"][:, 4:], atol=1e-5, rtol=0)


def test_new_yamls_build_at_their_scales():
    """yolo11 at m forces C3k into every C3k2; v3-tiny keeps its maps'
    size through ZeroPad2d and the stride-1 pool; v5's stem pads 2."""
    layers, _, meta = parse_model(yaml_model_load("yolo11m.yaml"))  # the layers alone: no init, no stride probe
    assert meta["scale"] == "m"
    assert all(isinstance(b, B.C3k) for layer in layers if isinstance(layer, B.C3k2) for b in layer.m)
    tiny = DetectionModel("yolov3-tiny.yaml")
    assert [type(tiny.model[i]).__name__ for i in (11, 12)] == ["ZeroPad2d", "MaxPool2d"]
    assert tiny.model[-1].f == [19, 15] and tiny.stride.tolist() == [16.0, 32.0]
    v5 = DetectionModel("yolov5s.yaml")
    assert v5.model[0].conv.kernel_size == (6, 6) and v5.model[0].conv.padding == (2, 2)
    assert isinstance(DetectionModel("yolov10s.yaml").model[-1], v10Detect)


# -- predict and val of yolov10n, end to end -----------------------------------

@pytest.fixture
def no_nms(monkeypatch):
    """Every NMS entry of the port raises; yields the calls seen."""
    from ultralytics_pro_tpu_torch.engine import predictor, validator
    from ultralytics_pro_tpu_torch.kernels import nms_cuda
    from ultralytics_pro_tpu_torch.ops import nms

    calls = []

    def refuse(name):
        def f(*a, **k):
            calls.append(name)
            raise AssertionError(f"{name} called on an end-to-end path")
        return f

    for mod in (predictor, validator, nms):
        for name in ("non_max_suppression", "non_max_suppression_fused"):
            if hasattr(mod, name):
                monkeypatch.setattr(mod, name, refuse(name))
    for name in ("greedy_nms", "greedy_nms_plain"):
        monkeypatch.setattr(nms_cuda, name, refuse(name))
    yield calls
    assert not calls


@pytest.fixture(scope="module")
def v10_pair():
    """yolov10n at nc 3 in both facades, on the same seeded random variables."""
    from ultralytics_pro_tpu import YOLO as JYOLO
    from ultralytics_pro_tpu.nn.tasks import yaml_model_load as jyaml

    y = jyaml("yolov10n.yaml")
    y["nc"] = 3
    jyolo = JYOLO(y)
    _, jyolo.model.variables, _ = _jax_and_port("yolov10n.yaml", seed=10, nc=3, jm=jyolo.model)
    port = YOLO({**yaml_model_load("yolov10n.yaml"), "nc": 3}, device="cpu")
    port.load_state_dict(jax_to_torch_state_dict(jyolo.model.variables))
    return port, jyolo


def test_v10_predict_matches_jax_without_nms(v10_pair, no_nms):
    rng = np.random.default_rng(11)
    imgs = [rng.integers(0, 256, (64, 48, 3), dtype=np.uint8), rng.integers(0, 256, (40, 64, 3), dtype=np.uint8)]
    port, jyolo = v10_pair
    kw = dict(imgsz=64, conf=0.05)
    got, ref = port.predict(imgs, **kw), jyolo.predict(imgs, **kw)
    assert type(port.predictor).__name__ == "DetectionPredictor"
    assert sum(len(r.boxes.data) for r in got) > 0
    for g, r in zip(got, ref):
        rd = np.asarray(r.boxes.data)
        assert 0 < len(g.boxes.data) == len(rd) <= 300
        np.testing.assert_array_equal(g.boxes.cls, rd[:, 5])
        np.testing.assert_allclose(g.boxes.xyxy, rd[:, :4], atol=1e-3, rtol=0)
        np.testing.assert_allclose(g.boxes.conf, rd[:, 4], atol=1e-5, rtol=0)
        assert (g.boxes.conf > 0.05).all()


def test_v10_val_matches_jax_without_nms(v10_pair, no_nms, tmp_path, monkeypatch):
    """Each batch's device-function rows (valid and cls equal, scores within
    1e-5, boxes 1e-3 px) and the metrics of the whole val (every key within
    1e-6); both loaders shrink with cv2's INTER_AREA here."""
    import shutil

    from ultralytics_pro_tpu.engine.validator import DetectionValidator as JVal
    from ultralytics_pro_tpu_torch.engine.validator import DetectionValidator

    data = shutil.copytree(f"{FIXTURES}/torch_val_synth", tmp_path / "set") / "data.yaml"
    port, jyolo = v10_pair
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
    assert len(got.stats["conf"]) == 16 and min(len(c) for c in got.stats["conf"]) > 0
    assert len(rows["port"]) == len(rows["jax"]) == 2
    for out, ref in zip(rows["port"], rows["jax"]):
        assert out["boxes"].shape == (8, 252, 4)  # min(300, A * nc) at 64 px, nc 3
        np.testing.assert_array_equal(out["valid"].numpy(), np.asarray(ref["valid"]))
        np.testing.assert_array_equal(out["cls"].numpy(), np.asarray(ref["cls"]))
        np.testing.assert_allclose(out["scores"].numpy(), np.asarray(ref["scores"]), atol=1e-5, rtol=0)
        np.testing.assert_allclose(out["boxes"].numpy(), np.asarray(ref["boxes"]), atol=1e-3, rtol=0)


# -- E2EDetectLoss --------------------------------------------------------------

def test_e2e_loss_and_its_gradient_match_jax():
    """Random one-to-many and one-to-one maps (NCHW for the port, NHWC for
    JAX), a padded batch with an empty image."""
    import jax
    import jax.numpy as jnp

    from ultralytics_pro_tpu.utils.loss import E2EDetectLoss as JLoss

    rng = np.random.default_rng(12)
    b, nc, g = 3, 5, 6
    maps = {k: [rng.normal(0, 2, (b, 64 + nc, h, h)).astype(np.float32) for h in (8, 4, 2)]
            for k in ("feats", "one2one")}
    mask = rng.uniform(size=(b, g)) < 0.7
    mask[1] = False
    cls = (rng.integers(0, nc, (b, g)) * mask).astype(np.float32)
    xywh = np.concatenate([rng.uniform(0.2, 0.8, (b, g, 2)), rng.uniform(0.05, 0.5, (b, g, 2))], -1)
    batch = {"cls": cls, "bboxes": (xywh * mask[..., None]).astype(np.float32), "mask_gt": mask}

    def jloss(m):
        preds = {k: [f.transpose(0, 2, 3, 1) for f in v] for k, v in m.items()}
        return JLoss(nc, 16, (8, 16, 32))(preds, {k: jnp.asarray(v) for k, v in batch.items()}, (64, 64))

    (jt, jparts), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        {k: [jnp.asarray(f) for f in v] for k, v in maps.items()})
    tm = {k: [torch.tensor(f, requires_grad=True) for f in v] for k, v in maps.items()}
    tt, tparts = E2EDetectLoss(nc, 16, (8, 16, 32))(tm, {k: torch.from_numpy(v) for k, v in batch.items()},
                                                   (64, 64))
    tt.backward()
    assert list(tparts) == [f"{a}_{p}" for a in ("o2m", "o2o") for p in ("box", "cls", "dfl")]
    assert set(tparts) == set(jparts) and float(jparts["o2o_box"]) > 0.1
    for k in jparts:
        assert float(tparts[k].detach()) == pytest.approx(float(jparts[k]), rel=1e-5), k
    assert float(tt.detach()) == pytest.approx(float(jt), rel=1e-5)
    for key in maps:
        for got, want in zip(tm[key], jgrads[key]):
            want = np.asarray(want)
            np.testing.assert_allclose(got.grad.numpy(), want, atol=1e-4 * np.abs(want).max(), rtol=0)
