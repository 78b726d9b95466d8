"""The MAF heads, the builder's rows and the carrier's new leaves of
yolov8-att, MAF-YOLOv2 and Hyper-YOLO in the port against the JAX package,
on the CPU, and the predictors' head selection by task.

1. Heads: MAFDetect, MAFSegment, MAFPose and MAFOBB in train and eval mode,
   as tests/test_torch_csp_modules.py holds the I-heads (seeded as
   tests/test_torch_att_maf_hyper_modules.py seeds its blocks): raw maps,
   mask coefficients, prototypes, keypoints and angles within 1e-5 of their
   largest magnitude, decoded boxes too, scores within 1e-5.
2. The builder's rows against the JAX builders' (arguments, defaults, the
   repeats) and the full-width YAMLs' rows; the carrier's bare `weight`,
   `gamma` and `beta` both ways.
3. Each head class's `task` and `tta`: the predictors and validators take
   the MAF heads by their task, the detect predictor still refuses a
   Segment head, and TTA runs on MAFDetect and is refused on MAFSegment and
   v10Detect.
"""

import numpy as np
import pytest
import torch

from tests.test_torch_modules import nchw, randomize, to_nhwc, torch_threads  # noqa: F401 (autouse fixture)
from tests.test_torch_train import leaves
from tests.torch_att_maf_hyper import blocked_imports_test, seeded
from ultralytics_pro_tpu_torch.nn.modules import attention as A
from ultralytics_pro_tpu_torch.nn.modules import head as H
from ultralytics_pro_tpu_torch.utils.weights import jax_to_torch_state_dict, torch_state_dict_to_jax

TOL = 1e-5


def close(got, want, tol: float = TOL):
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=tol * np.abs(want).max(), rtol=0)


# -- heads ----------------------------------------------------------------------------------

CH, SIZES = (32, 64, 64), (8, 4, 2)
HEADS = {  # JAX head factory, port head factory
    "MAFDetect": (lambda h: h.MAFDetect(nc=5), lambda: H.MAFDetect(5, CH)),
    "MAFSegment": (lambda h: h.MAFSegment(nc=5, nm=8, npr=16), lambda: H.MAFSegment(5, CH, 8, 16)),
    "MAFPose": (lambda h: h.MAFPose(nc=5, kpt_shape=(5, 3)), lambda: H.MAFPose(5, CH, (5, 3))),
    "MAFOBB": (lambda h: h.MAFOBB(nc=5), lambda: H.MAFOBB(5, CH, 1)),
}
EXTRA = {"MAFSegment": "mc", "MAFPose": "kpt", "MAFOBB": "angle"}  # the train-mode dict's extra entry


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
    v = seeded(randomize(jax.tree_util.tree_map(lambda a: np.zeros(a.shape, np.float32), shapes), 4))
    head.load_state_dict(jax_to_torch_state_dict(v))  # strict
    head.stride = torch.tensor([8.0, 16.0, 32.0])
    tf = [nchw(f) for f in feats]
    if mode == "train":
        want = jax.jit(lambda v, x: jm.apply(v, x, train=True, mutable=["batch_stats"])[0])(v, feats)
        with torch.no_grad():
            got = head.train()(tf, decode=False)
        got = got if isinstance(got, dict) else {"feats": got}
        for g, w in zip(got["feats"], want["feats"], strict=True):
            close(to_nhwc(g), w)
        if name in EXTRA:
            close(got[EXTRA[name]].numpy(), want[EXTRA[name]])
        if name == "MAFSegment":
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


def test_maf_head_branches_and_names():
    """The box branch Conv 1x1, UniRepLKNetBlock k 5, Conv 1x1, conv (bias
    1.0 after bias_init); the class branch the light one whatever `legacy`;
    the large-kernel block's leaves carried under the JAX names, its dense
    layers as Linear, its bare gamma, GRN's gamma and beta."""
    head = H.MAFDetect(5, CH, legacy=True)
    head.stride = torch.tensor([8.0, 16.0, 32.0])
    head.bias_init()
    box, cls = head.cv2[0], head.cv3[0]
    assert [type(m).__name__ for m in box] == ["Conv", "UniRepLKNetBlock", "Conv", "Conv2d"]
    assert box[0].conv.kernel_size == (1, 1) and box[1].dwconv.kernel_size == (5, 5) and torch.all(box[3].bias == 1)
    assert type(cls[0][0]).__name__ == "DWConv" and not head.fused_single_label
    tree = torch_state_dict_to_jax(head.state_dict())["params"]["cv2_0_1"]
    assert set(tree) == {"dwconv", "norm", "se_fc0", "se_fc1", "pwconv1", "grn", "pwconv2", "ffn_bn", "gamma"}
    assert tree["pwconv1"]["kernel"].shape == (64, 256) and set(tree["grn"]) == {"gamma", "beta"}
    assert "bias" not in tree["pwconv2"] and "bias" not in tree["dwconv"]


def test_bare_deformable_kernels_carry_both_ways():
    """DCNv2's `weight` (k, k, Cin, Co) in flax is (Co, Cin, k, k) here under
    C2f_DCN's `m_0_cv2` and C3_DCN's `m_1_cv2`, D-LKA's DeformConvDW's
    (k, k, 1, C) under `spatial_gating_unit.conv0` / `.conv_spatial`; other
    4-D `weight`s stay conv kernels."""
    for module in (A.C2f_DCN(8, 16, 2), A.C3_DCN(8, 16, 2), A.C2f_DLKA(8, 16, 1)):
        sd = module.state_dict()
        tree = torch_state_dict_to_jax(sd)
        bare = {"/".join(k): w.shape for k, w in leaves(tree["params"]) if k[-1] == "weight"}
        if isinstance(module, A.C2f_DLKA):
            assert bare == {"m_0/spatial_gating_unit/conv0/weight": (5, 5, 1, 8),
                            "m_0/spatial_gating_unit/conv_spatial/weight": (7, 7, 1, 8)}
        else:
            assert bare == {f"m_{i}_cv2/weight": (3, 3, 8, 8) for i in range(2)}
        back = jax_to_torch_state_dict(tree)
        assert back.keys() == sd.keys()
        assert all(torch.equal(back[k], v) for k, v in sd.items() if not k.endswith("num_batches_tracked"))


# -- the builder ----------------------------------------------------------------------------

def test_rows_build_as_the_jax_builders_read_them():
    """The rows' parameter trees equal the JAX builders' (BoT3 [c2, e],
    C2f_DCN / C3_DCN / C2f_DLKA [c2, shortcut] with the repeats as n, MANet
    [c2, shortcut, p, k] with the repeats as n, RepHMS [c2, width, depth,
    depth_e, k], HyperComputeModule [c2, threshold] keeping its input's
    channels, AVG [] and nn.AvgPool2d [k, s, 0] as VALID pools, a MAF head);
    ignored trailing arguments are ignored as there."""
    import jax

    from tests.torch_attn_zoo import jax_module
    from ultralytics_pro_tpu_torch.nn.tasks import parse_model

    d = {"nc": 3, "depth_multiple": 1.0, "width_multiple": 0.25,
         "backbone": [[-1, 1, "Conv", [64, 3, 2]], [-1, 2, "MANet", [64, True, 2, 5, 99]],
                      [-1, 1, "Conv", [128, 3, 2]], [-1, 1, "RepHMS", [128, 3, 1, 3, 7, 99]],
                      [-1, 1, "Conv", [256, 3, 2]], [-1, 2, "C2f_DCN", [256, True, 99]],
                      [-1, 1, "HyperComputeModule", [512, 8.0]], [-1, 2, "C3_DCN", [256]],
                      [-1, 1, "Conv", [256, 3, 2]], [-1, 2, "BoT3", [256, 0.25]], [-1, 1, "C2f_DLKA", [256, True]],
                      [2, 1, "AVG", []], [0, 1, "nn.AvgPool2d", [4, 4, 0]]],
         "head": [[[3, 7, 10], 1, "MAFDetect", ["nc"]]]}
    jm = jax_module(d)
    shapes = jax.eval_shape(lambda x: jm.init(jax.random.PRNGKey(0), x), jax.ShapeDtypeStruct((1, 64, 64, 3),
                                                                                                 np.float32))
    layers, _, _ = parse_model(d)
    for m in layers.modules():
        if isinstance(m, A.MHSA):
            m.bind(4, 4)  # P5 of a 64-px image
    sd = torch.nn.Sequential(*layers).state_dict()
    want = {"/".join(k): v.shape for k, v in
            leaves(jax.tree_util.tree_map(lambda a: np.zeros(a.shape, np.float32), shapes["params"]))}
    got = {"/".join(k): v.shape for k, v in leaves(torch_state_dict_to_jax(sd)["params"])}
    assert got == want
    assert len(layers[1].m) == 2 and layers[1].m[0].add and layers[1].cv_b2[1].conv.kernel_size == (5, 5)
    assert len(layers[3].m) == 2 and layers[3].m[0][0].dw_large.conv.kernel_size == (7, 7)
    assert layers[5].n == 2 and layers[5].shortcut and layers[7].shortcut and len(layers[9].m) == 2
    assert layers[6].threshold == 8.0 and layers[6].fc.in_features == 64
    assert (layers[11].kernel_size, layers[11].stride, layers[12].kernel_size, layers[12].stride) == (2, 2, 4, 4)


@pytest.mark.parametrize("name,layer,cls", [("yolov8s-att.yaml", 9, "BoT3"), ("yolov8s-att.yaml", 13, "C2f_DCN"),
                                            ("yolov8s-att.yaml", 19, "C2f_DLKA"), ("maf-yolov2s.yaml", 11, "AvgPool2d"),
                                            ("maf-yolov2s.yaml", 8, "RepHMS"), ("hyper-yolo-s.yaml", 16,
                                                                                 "HyperComputeModule"),
                                            ("hyper-yolo-s.yaml", 10, "AvgPool2d"), ("hyper-yolo-s.yaml", 4, "MANet")])
def test_yaml_rows_at_scale_s(name, layer, cls):
    """The full-width models' rows: yolov8s-att's BoT3 (one transformer
    bottleneck at depth 0.33) bound at P5's 20 x 20, MAF-YOLOv2's AVG at 2
    and RepHMS width 2 with k 9, Hyper-YOLO's 8 x 8 pool, 256-wide
    hypergraph and MANet with two bottlenecks."""
    from ultralytics_pro_tpu_torch.nn.tasks import DetectionModel, yaml_model_load

    m = DetectionModel(yaml_model_load(name)).model[layer]
    assert type(m).__name__ == cls
    if cls == "BoT3":
        assert len(m.m) == 1 and m.m[0].mhsa.rel_h.shape == (1, 4, 64, 20, 1)
    if name == "maf-yolov2s.yaml" and cls == "AvgPool2d":
        assert (m.kernel_size, m.stride) == (2, 2)
    if cls == "RepHMS":
        assert m.width == 2 and m.m[0][0].dw_large.conv.kernel_size == (9, 9)
    if name == "hyper-yolo-s.yaml" and cls == "AvgPool2d":
        assert (m.kernel_size, m.stride) == (8, 8)
    if cls == "HyperComputeModule":
        assert m.fc.in_features == 256 and m.threshold == 10.0
    if cls == "MANet":
        assert len(m.m) == 2


# -- the predictors' head selection ----------------------------------------------------------

def test_each_head_class_names_its_task():
    want = {"Detect": ("detect", True), "v10Detect": ("detect", True), "DDetect": ("detect", True),
            "IDetect": ("detect", True), "MAFDetect": ("detect", True), "AnchorDetect": ("detect", True),
            "Segment": ("segment", False), "DSegment": ("segment", False), "ISegment": ("segment", False),
            "MAFSegment": ("segment", False), "Pose": ("pose", False), "IPose": ("pose", False),
            "MAFPose": ("pose", False), "OBB": ("obb", False), "IOBB": ("obb", False), "MAFOBB": ("obb", False),
            "Classify": ("classify", False), "RTDETRDecoder": ("rtdetr", False)}
    for name, (task, tta) in want.items():
        cls = getattr(H, name)
        assert (cls.task, cls.tta) == (task, tta), name
    for name in ("IDetect", "MAFDetect"):  # the mixed classes take the task class's through the MRO
        assert "task" not in vars(getattr(H, name)) and "tta" not in vars(getattr(H, name))


def test_predictors_and_validators_take_the_heads_by_task(tmp_path):
    """The MAF heads go to their task's predictor and validator, with their
    task's criterion; the detect predictor refuses a Segment head and the
    segment predictor a Detect head, by name; TTA runs on MAFDetect and is
    refused on MAFSegment and v10Detect."""
    from ultralytics_pro_tpu_torch import YOLO
    from ultralytics_pro_tpu_torch.models import task_map
    from ultralytics_pro_tpu_torch.utils.loss import (
        E2EDetectLoss,
        v8DetectionLoss,
        v8OBBLoss,
        v8PoseLoss,
        v8SegmentationLoss,
    )

    args = {"imgsz": 64, "conf": 0.25}
    crit = {"maf-yolov2n-mafdetect.yaml": v8DetectionLoss, "maf-yolov2n-mafseg.yaml": v8SegmentationLoss,
            "maf-yolov2n-mafpose.yaml": v8PoseLoss, "maf-yolov2n-mafobb.yaml": v8OBBLoss,
            "maf-yolov2n.yaml": E2EDetectLoss}
    for name, criterion in crit.items():
        model = YOLO(name, device="cpu").model
        parts = task_map[model.task]
        parts["predictor"](model, args)
        assert isinstance(model.model[-1], parts["validator"].head_types)
        trainer = parts["trainer"](model, {"device": "cpu", "save_dir": str(tmp_path / name)})
        assert type(trainer.criterion) is criterion
    seg, det = YOLO("yolov8n-seg.yaml", device="cpu").model, YOLO("yolov8n.yaml", device="cpu").model
    with pytest.raises(NotImplementedError, match="DetectionPredictor needs a head of task 'detect', got Segment"):
        task_map["detect"]["predictor"](seg, args)
    with pytest.raises(NotImplementedError, match="SegmentationPredictor needs .* got Detect"):
        task_map["segment"]["predictor"](det, args)
    img = np.zeros((64, 64, 3), np.uint8)
    YOLO("maf-yolov2n-mafdetect.yaml", device="cpu").predict([img], imgsz=64, augment=True)
    for name, head in (("maf-yolov2n-mafseg.yaml", "MAFSegment"), ("maf-yolov2n.yaml", "v10Detect")):
        with pytest.raises(NotImplementedError, match=rf"augment=True.*{head}"):
            YOLO(name, device="cpu").predict([img], imgsz=64, augment=True)


test_models_run_with_jax_yaml_cv2_pil_blocked = blocked_imports_test(["maf-yolov2n-mafseg.yaml",
                                                                      "maf-yolov2n-mafobb.yaml"])
