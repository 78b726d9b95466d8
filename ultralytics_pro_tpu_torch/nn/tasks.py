"""Model YAML -> torch modules: parse_model, BaseModel and the task models.

Counterpart of `ultralytics_pro_tpu/nn/tasks.py` (`parse_model:1126`,
`YOLOModule._forward:1230`, `yaml_model_load:1311`, `split_scale:1328`,
`find_model_yaml:1347`, `BaseModel:1361`, `DetectionModel:1491`,
`SegmentationModel:1495`, `PoseModel:1499`, `OBBModel:1503`,
`ClassificationModel:1507`, `model_class_for:1610`, `guess_model_task:1624`)
for the YOLOv8 module set (Conv, C2f, SPPF, nn.Upsample, Concat, Detect,
Segment, OBB, Pose, Classify),
RT-DETR's (DWConv, HGStem, HGBlock, RepC3, AIFI, RTDETRDecoder; builders at
`:85`, `:260-263`, `:441-447`), that of the v3-tiny, v5, v10 and YOLO11
YAMLs (C3 `:91,236`, C3k2 `:101`, C2fCIB `:110`, PSA, C2PSA and SCDown
`:257-259`, torch's own nn.MaxPool2d and nn.ZeroPad2d `:282-284`, v10Detect
`:176`), and that of the P6/P7, v6, v3, YOLOX, v9, YOLO12 and v5-anchor
YAMLs (Bottleneck `:228`, SPP `:255`, torch's own nn.ConvTranspose2d with its
bias `:274-277`, RepNCSPELAN4, ADown and SPPELAN `:338-345`, A2C2f `:127`,
DDetect and DSegment `:459-460`, AnchorDetect `:185`), and that of the
YOLOv13 YAML (DSConv `:317`, DSC3k2, HyperACE, DownsampleConv and
FullPAD_Tunnel `:399-413`; its Conv rows with a padding and a group), and
the attention modules of the v5/v8 attention YAMLs (CBAM `:266`, MHSA to
EMA `:286-322`, LSKA, CPCA and FocusedLinearAttention `:580-583`,
BiLevelRoutingAttention `:708-709`; `ATTENTION`), and that of the RTMDet,
YOLOv7, YOLOv4-CSP and YOLOR-CSP YAMLs (BottleneckCSP, BottleneckCSP2 and
SPPCSPC `:245-251`, MP `:278`, RepConv_v7 `:438` as the port's RepConv,
IDetect, ISegment, IOBB and IPose `:455-458`, RTMBlock `:640`, the CSP-B/C
blocks, ResCSPB/C and Stem `:686-694`, AnchorDetect's implicit flag), and
that of the yolov8-att, MAF-YOLOv2 and Hyper-YOLO YAMLs (BoT3, C2f_DCN,
C3_DCN and C2f_DLKA `:285-293`, MAFDetect, MAFSegment, MAFOBB and MAFPose
`:463-466`, MANet, HyperComputeModule, AVG, torch's own nn.AvgPool2d and
RepHMS `:662-673`), and that of the 11/ YAMLs (the whole backbones of
`BACKBONES`, the JAX `_backbone_builder`s `:960-1013`; Bi_FPN, GSConv and
VoVGSCSP `:375-383`), each
with its input's channels out, its YAML arguments read as the JAX builders
read them (`ARITY`: the arguments a builder ignores are dropped). As in
the JAX parse_model, a YAML with C3k2, C2fCIB, A2C2f, HyperACE or v10Detect
in any row builds
its detect head with legacy=False (the pre-scan `:1152-1155`), and the
modules of REPEAT_MODULES (`:1103-1107`) take the repeats as their own n,
RepNCSPELAN4 ignores them (its n is its fourth argument; VoVGSCSP takes them
as its n), and any other is
stacked n times in an nn.Sequential (`:1208-1213`); MANet takes them as
its n too, as its builder passes them. AVG and nn.AvgPool2d are a VALID
k x k average pool at stride s (k = args[0] or 2, s = args[1] or k; a third
argument, the YAMLs' 0, is ignored as the JAX builder ignores it), and
HyperComputeModule [c2, threshold] gives its input's channels (the JAX
module ignores c2). A whole backbone takes no arguments and gives its 4
stage maps, which fill 4 feature slots (`MULTI`, the JAX `multi_output`
`:1201-1206`); Bi_FPN sums its inputs with one weight each and gives the
first input's channels. HyperACE reads three
layers and gives args[0] channels; DownsampleConv gives twice its input's
channels (its input's with channel_adjust False); FullPAD_Tunnel gives its
first input's. A2C2f at scales l and x
takes residual=True and mlp_ratio=1.2. Segment's, DSegment's and ISegment's
args are [nc, nm, npr] with npr width-scaled, OBB's and IOBB's [nc, ne],
Pose's and IPose's [nc, kpt_shape] with the YAML's top-level `kpt_shape`
substituted, AnchorDetect's [nc, anchors, implicit], as the JAX package's
`parse_model` reads them (`:206-212`, `:1179-1181`). Any other module raises NotImplementedError naming it.

In train mode (`model.train()`) a Detect model returns the head's raw
per-level maps, NCHW, as the JAX head returns `{"feats": raw}` when
`train=True` (`nn/modules/head.py:120-123`). A classification model returns
(B, nc) logits in train mode and their softmax in eval mode; it has no
detect head, so no strides are probed. A YOLOX head reads six maps, a class
and a box tower for each of P3-P5, so its strides repeat: 8, 8, 16, 16, 32, 32.

Models are nn.Modules in NCHW whose parameter names are the reference's
(`model.N.cv1.conv.weight`). Weights are initialised from an explicit
`torch.Generator`, so a seed fixes them.

An MHSA layer's `rel_h` and `rel_w`, and the `attention_biases` of
EfficientFormerV2's Attention4D and Attention4DDownsample, take the size of
their map at the image size `imgsz` the model is built for (640 unless
given), as the JAX model's `init_params(imgsz=...)` sizes them (`:1421`):
the stride probe records the map each sees at 256 px, and the layer is
bound to ceil(imgsz x that / 256) (`size_bound`). The model then runs at
that image size only (such a layer raises at another, as flax does);
`BaseModel.imgsz` is None for a model without one.
"""

from __future__ import annotations

import contextlib
import math
from functools import partial
from pathlib import Path
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ultralytics_pro_tpu_torch.nn.modules.block import (
    C3,
    PSA,
    SPP,
    SPPCSPC,
    SPPF,
    Bottleneck,
    BottleneckCSP,
    BottleneckCSP2,
    C2f,
    C2fCIB,
    C2PSA,
    C3k2,
    HGBlock,
    HGStem,
    RepC3,
    SCDown,
)
from ultralytics_pro_tpu_torch.nn.modules import attention as A
from ultralytics_pro_tpu_torch.nn.modules.backbones import ConvNeXt, EfficientViT, PVTv2, SwinTransformer
from ultralytics_pro_tpu_torch.nn.modules.backbones2 import EfficientNetV2, FasterNet, LSKNet, MobileNetV4, RepViT, StarNet
from ultralytics_pro_tpu_torch.nn.modules.backbones5 import GhostNetV2Backbone
from ultralytics_pro_tpu_torch.nn.modules.efficientformer import EfficientFormerV2
from ultralytics_pro_tpu_torch.nn.modules.necks import Bi_FPN, GSConv, VoVGSCSP
from ultralytics_pro_tpu_torch.nn.modules.conv import CBAM, Concat, Conv, DWConv, ImplicitA, RepConv, recomputing
from ultralytics_pro_tpu_torch.nn.modules.families import (
    BiLevelRoutingAttention,
    BottleneckCSPB,
    BottleneckCSPC,
    HyperComputeModule,
    MANet,
    RepHMS,
    ResCSPB,
    ResCSPC,
    RTMBlock,
    Stem,
)
from ultralytics_pro_tpu_torch.nn.modules.head import (
    OBB,
    V5_ANCHORS,
    AnchorDetect,
    Classify,
    DDetect,
    Detect,
    DSegment,
    IDetect,
    IOBB,
    IPose,
    ISegment,
    MAFDetect,
    MAFOBB,
    MAFPose,
    MAFSegment,
    Pose,
    RTDETRDecoder,
    Segment,
    v10Detect,
)
from ultralytics_pro_tpu_torch.nn.modules.transformer import AIFI, MSDeformAttn, MultiheadAttention
from ultralytics_pro_tpu_torch.nn.modules.v13 import (
    AdaHGComputation,
    DownsampleConv,
    DSC3k2,
    DSConv,
    FullPAD_Tunnel,
    HyperACE,
)
from ultralytics_pro_tpu_torch.nn.modules.v9v12 import SPPELAN, A2C2f, ADown, RepNCSPELAN4
from ultralytics_pro_tpu_torch.utils import LOGGER, PKG_ROOT, miniyaml

SCALED = {"Conv": Conv, "DWConv": DWConv, "C2f": C2f, "SPPF": SPPF, "RepC3": RepC3, "C3": C3, "C3k2": C3k2,
          "C2fCIB": C2fCIB, "PSA": PSA, "C2PSA": C2PSA, "SCDown": SCDown, "Bottleneck": Bottleneck, "SPP": SPP,
          "nn.ConvTranspose2d": nn.ConvTranspose2d, "ADown": ADown, "A2C2f": A2C2f, "DSConv": DSConv,
          "DSC3k2": DSC3k2, "RTMBlock": RTMBlock, "BottleneckCSP": BottleneckCSP, "BottleneckCSP2": BottleneckCSP2,
          "SPPCSPC": SPPCSPC, "RepConv_v7": RepConv, "BottleneckCSPB": BottleneckCSPB,
          "BottleneckCSPC": BottleneckCSPC, "ResCSPB": ResCSPB, "ResCSPC": ResCSPC, "Stem": Stem,
          "BoT3": A.BoT3, "C2f_DCN": A.C2f_DCN, "C3_DCN": A.C3_DCN, "C2f_DLKA": A.C2f_DLKA, "MANet": MANet,
          "RepHMS": RepHMS, "GSConv": GSConv, "VoVGSCSP": VoVGSCSP}  # c2 width-scaled
REPEAT_MODULES = {"C2f", "RepC3", "C3", "C3k2", "C2fCIB", "C2PSA", "A2C2f", "DSC3k2", "RTMBlock", "BottleneckCSP",
                  "BottleneckCSP2", "BottleneckCSPB", "BottleneckCSPC", "ResCSPB", "ResCSPC", "BoT3", "C2f_DCN",
                  "C3_DCN", "C2f_DLKA", "MANet", "VoVGSCSP"}  # of SCALED, n is the repeats
# of SCALED, how many YAML arguments the JAX builder reads (it ignores the rest):
# RTMBlock, BottleneckCSP2 and the CSP-B/C blocks [c2, shortcut], ResCSPB/C and
# Stem [c2], SPPCSPC [c2, e], RepConv_v7 [c2, k, s], BoT3 [c2, e], C2f_DCN, C3_DCN and
# C2f_DLKA [c2, shortcut], MANet [c2, shortcut, p, k], RepHMS [c2, width, depth, depth_e, k], GSConv
# [c2, k, s], VoVGSCSP [c2]
ARITY = {"RTMBlock": 2, "BottleneckCSP2": 2, "BottleneckCSPB": 2, "BottleneckCSPC": 2, "ResCSPB": 1, "ResCSPC": 1,
         "Stem": 1, "SPPCSPC": 2, "RepConv_v7": 3, "BoT3": 2, "C2f_DCN": 2, "C3_DCN": 2, "C2f_DLKA": 2, "MANet": 4,
         "RepHMS": 5, "GSConv": 3, "VoVGSCSP": 1}
ELAN = {"RepNCSPELAN4": RepNCSPELAN4, "SPPELAN": SPPELAN}  # [c2, c3(, c4, n)]: every width scaled
HEADS = {"Detect": Detect, "Segment": Segment, "OBB": OBB, "Pose": Pose, "v10Detect": v10Detect,
         "DDetect": DDetect, "DSegment": DSegment, "AnchorDetect": AnchorDetect, "IDetect": IDetect,
         "ISegment": ISegment, "IOBB": IOBB, "IPose": IPose, "MAFDetect": MAFDetect, "MAFSegment": MAFSegment,
         "MAFOBB": MAFOBB, "MAFPose": MAFPose}
# torch's own, args as the YAML gives them; MP [k] is k x k at stride k; AVG and
# nn.AvgPool2d [k, s] (by default 2, k) with no padding
POOLS = {"nn.MaxPool2d": nn.MaxPool2d, "nn.ZeroPad2d": nn.ZeroPad2d, "MP": nn.MaxPool2d,
         "AVG": nn.AvgPool2d, "nn.AvgPool2d": nn.AvgPool2d}
NON_LEGACY = {"C3k2", "C2fCIB", "A2C2f", "HyperACE", "v10Detect"}  # any of these in a YAML: the light class branch


def _a(args, i: int, default=None):
    return args[i] if len(args) > i else default


# module name -> fn(c1, args, scale) -> a module with c1 channels out (GAMAttention's
# c2, scaled, where given); `scale` width-scales a channel count. The arguments are
# read as the JAX builders read them: CBAM [c2, k], CoordAtt [c2, reduction],
# MHSA [heads], TripletAttention [no_spatial] (the YAMLs' 1024 is True),
# BiLevelRoutingAttention [num_heads, topk], FocusedLinearAttention [.., .., num_heads].
ATTENTION = {
    "CBAM": lambda c1, a, sc: CBAM(c1, _a(a, 1, 7)),
    "MHSA": lambda c1, a, sc: A.MHSA(c1, _a(a, 0, 4)),
    "CoordAtt": lambda c1, a, sc: A.CoordAtt(c1, _a(a, 1, 32)),
    "SEAttention": lambda c1, a, sc: A.SEAttention(c1, _a(a, 1, 16)),
    "ECAAttention": lambda c1, a, sc: A.ECAAttention(_a(a, 1, 3)),
    "SimAM": lambda c1, a, sc: A.SimAM(),
    "GAMAttention": lambda c1, a, sc: A.GAMAttention(c1, sc(a[0]) if a else 0, bool(_a(a, 1, True)),
                                                     _a(a, 2, 4)),
    "CrissCrossAttention": lambda c1, a, sc: A.CrissCrossAttention(c1),
    "SKAttention": lambda c1, a, sc: A.SKAttention(c1, reduction=_a(a, 1, 16)),
    "TripletAttention": lambda c1, a, sc: A.TripletAttention(_a(a, 0, False)),
    "ShuffleAttention": lambda c1, a, sc: A.ShuffleAttention(c1, _a(a, 1, 8)),
    "LSKblock": lambda c1, a, sc: A.LSKblock(c1),
    "EffectiveSE": lambda c1, a, sc: A.EffectiveSE(c1),
    "SegNext_Attention": lambda c1, a, sc: A.SegNext_Attention(c1),
    "DAttention": lambda c1, a, sc: A.DAttention(c1),
    "EMA": lambda c1, a, sc: A.EMA(c1, _a(a, 1, 8)),
    "LSKA": lambda c1, a, sc: A.LSKA(c1, _a(a, 1, 11)),
    "CPCA": lambda c1, a, sc: A.CPCA(c1),
    "FocusedLinearAttention": lambda c1, a, sc: A.FocusedLinearAttention(c1, _a(a, 2, 8)),
    "BiLevelRoutingAttention": lambda c1, a, sc: BiLevelRoutingAttention(c1, _a(a, 0, 8), topk=_a(a, 1, 4)),
}
# whole backbones (the JAX BACKBONE_VARIANTS* aliases of the 11/ YAMLs): name -> (class, keyword arguments);
# one module, no YAML arguments, whose 4 stage maps take 4 feature slots
BACKBONES = {
    "convnext_tiny": (ConvNeXt, {"depths": (3, 3, 9, 3), "dims": (96, 192, 384, 768)}),
    "SwinTransformer_Tiny": (SwinTransformer, {}),
    "pvt_v2_b0": (PVTv2, {}),
    "efficientvit_backbone_b0": (EfficientViT, {}),
    "fasternet_t0": (FasterNet, {}),
    "repvit_m0_9": (RepViT, {}),
    "starnet_s1": (StarNet, {}),
    "lsknet_t": (LSKNet, {}),
    "mobilenetv4_conv_small": (MobileNetV4, {}),
    "efficientnetv2_s": (EfficientNetV2, {}),
    "ghostnetv2": (GhostNetV2Backbone, {}),
    "efficientformerv2_s0": (EfficientFormerV2, {"variant": "s0"}),
}
MULTI = 4  # a whole backbone's outputs (P2-P5)
MODULES = (*SCALED, *ELAN, *POOLS, "HGStem", "HGBlock", "AIFI", "nn.Upsample", "Concat", "HyperACE",
           "HyperComputeModule",
           "DownsampleConv", "FullPAD_Tunnel", *ATTENTION, *HEADS, "Classify", "RTDETRDecoder", *BACKBONES, "Bi_FPN")


def make_divisible(x, divisor: int = 8) -> int:
    """Round a channel count up to a multiple of divisor."""
    return math.ceil(x / divisor) * divisor


def parse_model(d: dict, ch: int = 3, verbose: bool = False):
    """Build the layers of a model YAML dict.

    Returns (nn.Sequential of layers, sorted save list, meta dict: scale, nc
    and `channels`, each feature slot's width, None where it has none). Each layer
    carries `i` (index), `f` (from), `type` and `multi` attributes. A whole
    backbone (BACKBONES) fills MULTI feature slots, i - 3 .. i, and every
    later index is its row plus MULTI (the JAX parse's offset), one slot
    before them left empty; the layer's place in the nn.Sequential stays its
    row, as the flax name `layers_<row>` does.
    """
    scales = d.get("scales")
    scale = d.get("scale")
    if scales:
        if not scale:
            scale = next(iter(scales))
        depth, width, max_channels = scales[scale][:3]
    else:
        depth, width, max_channels = d.get("depth_multiple", 1.0), d.get("width_multiple", 1.0), float("inf")
    nc = d.get("nc", 80)

    def sc(c):  # a width-scaled channel count
        return make_divisible(min(c, max_channels) * width, 8)

    act = d.get("activation")
    if act:
        Conv.default_act = act
    try:
        chs = [ch]
        layers, save, offset = [], [], 0
        rows = list(d.get("backbone", [])) + list(d.get("head", []))
        legacy = not any(len(row) == 4 and row[2] in NON_LEGACY for row in rows)
        for r, row in enumerate(rows):
            i = r + offset
            if len(row) != 4:
                raise NotImplementedError(
                    f"malformed model-yaml row {i}: expected [from, repeats, module, args], got {row!r}")
            f, n, m_name, args = row
            multi = MULTI if m_name in BACKBONES else 0
            kwargs = {}
            if m_name not in MODULES:
                raise NotImplementedError(
                    f"module '{m_name}' (layer {i}) is not implemented in ultralytics_pro_tpu_torch; "
                    f"implemented: {sorted(MODULES)}")
            n = max(round(n * depth), 1) if n > 1 else n
            lit = {"None": None, "True": True, "False": False, "nc": nc,
                   "kpt_shape": list(d.get("kpt_shape", (17, 3)))}
            args = [lit.get(a, a) if isinstance(a, str) else a for a in args]
            c1 = chs[f] if isinstance(f, int) else None
            if m_name in SCALED:
                c2 = make_divisible(min(args[0], max_channels) * width, 8)
                args = [c1, c2, *args[1:ARITY.get(m_name, len(args))]]
                if m_name in REPEAT_MODULES:  # the repeats are the block's own n
                    args.insert(2, n)
                    n = 1
                if m_name == "C3k2" and scale in ("m", "l", "x"):  # [c1, c2, n, c3k, ...]: C3k inside
                    args = [*args[:3], True, *args[4:]]
                if m_name == "A2C2f" and scale in ("l", "x"):  # [c1, c2, n, a2, area, residual, mlp_ratio]
                    args = [*args[:3], args[3] if len(args) > 3 else True, args[4] if len(args) > 4 else 1, True, 1.2]
                m = SCALED[m_name]
            elif m_name in ELAN:
                c2 = make_divisible(min(args[0], max_channels) * width, 8)
                scaled = [make_divisible(min(c, max_channels) * width, 8) for c in args[1:3]]
                args = [c1, c2, *scaled, *args[3:]]
                n, m = 1, ELAN[m_name]  # RepNCSPELAN4's n is its own argument; the repeats are ignored
            elif m_name in POOLS:
                c2, m = c1, POOLS[m_name]
                if m_name == "nn.ZeroPad2d":
                    args = [tuple(args[0])]
                elif m_name == "MP":
                    args = [args[0] if args else 2] * 2
                elif m_name in ("AVG", "nn.AvgPool2d"):
                    k = int(_a(args, 0, 2))
                    args = [k, int(_a(args, 1, k))]
            elif m_name in ("HGStem", "HGBlock"):  # [cm, c2, ...], not width-scaled
                c2, m = args[1], HGStem
                if m_name == "HGBlock":  # [cm, c2, k, lightconv, shortcut]; n as the JAX builder takes it
                    args = [args[0], c2, args[2] if len(args) > 2 else 3, n if n > 1 else 6, *args[3:]]
                    n, m = 1, HGBlock
                args = [c1, *args]
            elif m_name == "AIFI":
                c2, m = c1, AIFI
                args = [c1, *args]
            elif m_name == "nn.Upsample":
                c2, m = c1, nn.Upsample
            elif m_name == "Concat":
                c2, m = sum(chs[x] for x in f), Concat
            elif m_name == "HyperACE":  # [c2, ne, dsc3k, shortcut, e1, e2, context] over three layers
                c2 = make_divisible(min(args[0], max_channels) * width, 8)
                args = [[chs[x] for x in f], c2, n, *args[1:]]
                n, m = 1, HyperACE
            elif m_name == "DownsampleConv":  # [channel_adjust]
                adjust = bool(args[0]) if args else True
                c2, m, args = c1 * 2 if adjust else c1, DownsampleConv, [c1, adjust]
            elif m_name == "FullPAD_Tunnel":
                c2, m, args = chs[f[0]], FullPAD_Tunnel, []
            elif m_name == "HyperComputeModule":  # [c2, threshold]: the input's channels out
                c2, m, args = c1, HyperComputeModule, [c1, _a(args, 1, 10.0)]
            elif multi:  # a whole backbone: its stage widths fill the slots
                m, kw = BACKBONES[m_name]
                m, args = partial(m, **kw), [c1]
            elif m_name == "Bi_FPN":  # [] -> one weight per input (2 for a single source, as the JAX module)
                m, (c2, args) = Bi_FPN, (chs[f[0]], [len(f)]) if isinstance(f, list) else (c1, [2])
            elif m_name in ATTENTION:
                c2 = sc(args[0]) if m_name == "GAMAttention" and args and args[0] else c1
                m, args = partial(ATTENTION[m_name], c1, args, sc), []
            elif m_name in HEADS:
                c2, m = None, HEADS[m_name]
                extra = []
                kwargs = {"legacy": legacy}
                if issubclass(m, Segment):  # [nc, nm, npr], npr width-scaled
                    npr = args[2] if len(args) > 2 else 256
                    extra = [args[1] if len(args) > 1 else 32, make_divisible(min(npr, max_channels) * width, 8)]
                elif issubclass(m, OBB):  # [nc, ne]
                    extra = [args[1] if len(args) > 1 else 1]
                elif issubclass(m, Pose):  # [nc, kpt_shape]
                    extra = [tuple(args[1] if len(args) > 1 else (17, 3))]
                elif m_name == "AnchorDetect":  # [nc, anchors, implicit]
                    extra = [args[1] if len(args) > 1 and isinstance(args[1], (list, tuple)) else V5_ANCHORS,
                             bool(_a(args, 2, False))]
                args = [args[0], [chs[x] for x in f], *extra]
            elif m_name == "Classify":  # [c2, k, s, p, g], the inputs' channels summed
                c2, m = args[0], Classify
                args = [c1 if c1 is not None else sum(chs[x] for x in f), *args]
            else:  # RTDETRDecoder [nc, hd, nq, ndl], as the JAX builder reads them (tasks.py:195)
                c2, m = None, RTDETRDecoder
                args = [args[0], [chs[x] for x in f], *args[1:4]]
            layer = nn.Sequential(*(m(*args, **kwargs) for _ in range(n))) if n > 1 else m(*args, **kwargs)
            if multi:
                offset += multi
                i = r + offset
            # relative sources other than -1 become absolute layer indices (-2 -> i - 2)
            layer.f = f if f == -1 else f % i if isinstance(f, int) else [x if x == -1 else x % i for x in f]
            layer.i, layer.type, layer.multi = i, m_name, multi
            layers.append(layer)
            save.extend(x % i for x in ([f] if isinstance(f, int) else f) if x != -1)
            if verbose:
                LOGGER.info(f"{i:>3} {str(f):>10} {n:>3} {m_name:<12} {args}")
            if r == 0:
                chs = []
            chs.extend([None, *layer.width_list] if multi else [c2])
    finally:
        Conv.default_act = "silu"
    return nn.Sequential(*layers), sorted(set(save)), {"scale": scale, "nc": nc, "channels": chs}


def split_scale(stem: str):
    """'yolov8n' -> ('yolov8', 'n'); 'yolov8s-p6' -> ('yolov8-p6', 's')."""
    parts = stem.split("-")
    for i, tok in enumerate(parts):
        if tok and tok[-1] in "nslmx" and len(tok) > 1 and tok[-2].isdigit():
            return "-".join([*parts[:i], tok[:-1], *parts[i + 1:]]), tok[-1]
    if len(parts) > 1 and parts[-1] in set("nslmxt"):
        return "-".join(parts[:-1]), parts[-1]
    for i in range(1, len(parts) - 1):
        if parts[i] in set("nslmxt"):
            return "-".join(parts[:i] + parts[i + 1:]), parts[i]
    return stem, None


def find_model_yaml(path) -> Path:
    """Resolve a model YAML name against the port's cfg/models tree."""
    path = Path(path)
    if path.exists():
        return path
    root = PKG_ROOT / "cfg" / "models"
    stem, _ = split_scale(path.stem)
    candidates = list(root.rglob(f"{path.stem}.yaml")) + list(root.rglob(f"{stem}.yaml"))
    if not candidates:
        raise FileNotFoundError(f"model YAML '{path}' not found (searched {root})")
    return candidates[0]


def yaml_model_load(path) -> dict:
    """Load a model YAML; the scale comes from the file name (yolov8s -> 's')."""
    path = Path(path)
    d = miniyaml.load(find_model_yaml(path))
    _, scale = split_scale(path.stem)
    if scale and scale not in d.get("scales", {}):
        scale = None
    d["scale"] = scale or d.get("scale")
    d["yaml_file"] = str(path)
    return d


def guess_model_task(cfg) -> str:
    """The task of a model YAML, from its head module."""
    d = cfg if isinstance(cfg, dict) else yaml_model_load(cfg)
    names = {row[2] for row in d.get("head", [])}
    for suffix, task in (("Segment", "segment"), ("Pose", "pose"), ("OBB", "obb")):
        if any(n.endswith(suffix) for n in names):
            return task
    if "Classify" in names:
        return "classify"
    return "detect"


def _lecun_normal_(weight: torch.Tensor, generator: torch.Generator) -> None:
    """lecun-normal over the fan-in of weight[0], truncated at 2 sigma (flax's
    default; for a transposed conv, weight[0] is one input channel's taps)."""
    std = math.sqrt(1.0 / weight[0].numel()) / 0.87962566103423978
    with torch.no_grad():
        w = torch.empty(weight.shape).normal_(generator=generator)
        while bool((w.abs() > 2).any()):
            bad = w.abs() > 2
            w[bad] = torch.empty(int(bad.sum())).normal_(generator=generator)
        weight.copy_(w * std)


def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded initialisation, as flax initialises the JAX modules: conv and
    dense kernels (attention projections too) lecun-normal, their biases
    zero, BatchNorm, LayerNorm and GroupNorm at identity, embeddings and
    MHSA's `rel_h`, `rel_w` normal(1.0),
    AdaHGComputation's prototypes xavier-uniform (FullPAD_Tunnel's gates stay
    0), DCNv2's and DeformConvDW's bare `weight` lecun-normal and `bias`
    zero (GRN's `gamma`, `beta` stay 0, UniRepLKNetBlock's `gamma` 1e-6),
    ImplicitA's and ImplicitM's `implicit` N(0, 0.02) and N(1, 0.02),
    Swin's `rel_bias` and Attention4D's talking heads' `_w` N(0, 0.02)
    (their modules' `seed_params`; the layer scales, Bi_FPN's `weight` and
    `attention_biases` keep the constants they are built with); then
    MSDeformAttn's own offset and attention init."""
    for m in model.modules():
        if isinstance(m, (nn.Conv1d, nn.Conv2d, nn.ConvTranspose2d, nn.Linear)) and m.weight.requires_grad:
            _lecun_normal_(m.weight, generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, MultiheadAttention):
            _lecun_normal_(m.in_proj_weight, generator)
            nn.init.zeros_(m.in_proj_bias)
        elif isinstance(m, (nn.BatchNorm2d, nn.LayerNorm, nn.GroupNorm)):
            m.reset_parameters()
        elif isinstance(m, (A.DCNv2, A.DeformConvDW)):  # bare kernels: flax's lecun-normal `weight`, zero `bias`
            _lecun_normal_(m.weight, generator)
            nn.init.zeros_(m.bias)
        elif isinstance(m, A.MHSA) and m.rel_h is not None:
            with torch.no_grad():
                for p in (m.rel_h, m.rel_w):
                    p.copy_(torch.empty(p.shape).normal_(generator=generator))
        elif isinstance(m, nn.Embedding):
            with torch.no_grad():
                m.weight.copy_(torch.empty(m.weight.shape).normal_(generator=generator))
        elif isinstance(m, ImplicitA):  # ImplicitM too
            with torch.no_grad():
                m.implicit.copy_(m.mean + m.std * torch.empty(m.implicit.shape).normal_(generator=generator))
        elif isinstance(m, AdaHGComputation):
            ne, c = m.prototype_base.shape
            bound = math.sqrt(6.0 / (ne + c))
            with torch.no_grad():
                m.prototype_base.copy_(torch.empty(ne, c).uniform_(-bound, bound, generator=generator))
        elif hasattr(m, "seed_params"):  # Swin's rel_bias, Attention4D's talking heads: N(0, 0.02)
            m.seed_params(generator)
    for m in model.modules():
        if isinstance(m, MSDeformAttn):
            m.reset_parameters()


class BaseModel(nn.Module):
    """A YAML-built model: layers run in order with a save list of outputs that
    later layers read (the reference's `_predict_once`)."""

    task = "detect"
    remat = False  # train mode with gradients: every layer before the head under torch.utils.checkpoint

    def __init__(self, cfg="yolov8n.yaml", ch: int = 3, nc: Optional[int] = None,
                 verbose: bool = False, generator: Optional[torch.Generator] = None, imgsz: int = 640):
        super().__init__()
        self.ch = ch
        self.yaml = dict(cfg) if isinstance(cfg, dict) else yaml_model_load(cfg)
        if nc and nc != self.yaml.get("nc"):
            self.yaml["nc"] = nc
        self.model, self.save, meta = parse_model(self.yaml, ch=ch, verbose=verbose)
        self.nc = meta["nc"]
        self.names = {i: f"class{i}" for i in range(self.nc)}
        self.eval()
        self.stride = torch.tensor([32.0])
        bound = size_bound(self)
        self.imgsz = imgsz if bound else None
        head = self.model[-1]
        if isinstance(head, (Detect, AnchorDetect, RTDETRDecoder)) or bound:
            strides = self._probe(ch, bound, imgsz)
            if isinstance(head, (Detect, AnchorDetect, RTDETRDecoder)):
                head.stride = self.stride = strides
        init_weights(self, generator if generator is not None else torch.Generator().manual_seed(0))
        if isinstance(head, Detect):
            head.bias_init()

    def _probe(self, ch: int, bound=(), imgsz: int = 640) -> torch.Tensor:
        """Strides from the head's input map sizes on a 256 px dry run (the
        detection inputs of a DSegment head: its last is the prototypes'
        source); each module of `bound` is bound to the map it sees there, then
        to ceil(imgsz / 256 x that), its map at imgsz where every map is
        ceil(imgsz / stride)."""
        s = 256
        seen = {}

        def bind(m, inputs):
            seen[m] = inputs[0].shape[-2:]
            m.bind(*seen[m])

        hooks = [m.register_forward_pre_hook(bind) for m in bound]
        try:
            with torch.no_grad():
                feats = self._run(torch.zeros(1, ch, s, s), stop_at_head=True)
        finally:
            for h in hooks:
                h.remove()
        for m, (h, w) in seen.items():
            m.bind(math.ceil(imgsz * h / s), math.ceil(imgsz * w / s))
        if isinstance(self.model[-1], DSegment):
            feats = feats[:-1]
        return torch.tensor([s / x.shape[-2] for x in feats]) if isinstance(feats, (list, tuple)) else self.stride

    def _run(self, x, stop_at_head: bool = False, decode: bool = True, aux: bool = True, dn=None,
             embed: bool = False):
        y = {}
        remat = self.remat and self.training and torch.is_grad_enabled()
        for m in self.model:
            if m.f != -1:
                x = y[m.f] if isinstance(m.f, int) else [x if j == -1 else y[j] for j in m.f]
            if embed and m is self.model[-1] and not isinstance(m.f, int):
                pooled = torch.cat([fm.mean(dim=(2, 3)) for fm in x], -1)
                return pooled / (torch.linalg.vector_norm(pooled, dim=-1, keepdim=True) + 1e-12)
            if isinstance(m, v10Detect):
                return x if stop_at_head else m(x, decode=decode and not self.training, aux=aux)
            if isinstance(m, (Detect, AnchorDetect)):
                return x if stop_at_head else m(x, decode=decode and not self.training)
            if isinstance(m, RTDETRDecoder):
                return x if stop_at_head else m(x, aux=aux, dn=dn)
            x = checkpoint(m, x, use_reentrant=False, context_fn=_recompute_context) if remat else m(x)
            if m.multi:  # a whole backbone's maps take slots i - multi + 1 .. i
                for slot, o in enumerate(x, m.i - m.multi + 1):
                    if slot in self.save:
                        y[slot] = o
                x = x[-1]
            elif m.i in self.save:
                y[m.i] = x
        return x

    def forward(self, x: torch.Tensor, decode: bool = True, aux: bool = True, dn=None, embed: bool = False):
        """x (B, C, H, W) float. For a Detect model: (decoded (B, A, 4+nc), raw
        per-level maps), or the raw maps alone when decode=False or in train
        mode; a v10Detect model gives its head's (B, k, 6) rows and dict, the
        dict None when aux=False, or the dict alone (`v10Detect.forward`);
        Segment, OBB and Pose models give their head's (y, dict), or the dict
        alone (`Segment.forward`, `OBB.forward`, `Pose.forward`). For an RT-DETR model:
        (y (B, nq, 4+nc), aux), aux None when aux=False, and in train mode
        aux alone, with the denoising queries `dn` when given (see
        `RTDETRDecoder.forward`; the JAX model passes `dn` to its head as
        here, `nn/tasks.py:1241,1294`). For a classification model: (B, nc)
        logits in train mode, their softmax in eval mode. With embed, a model
        whose head reads several maps gives (B, D) instead: each head input
        averaged over H x W, concatenated and L2-normalised with eps 1e-12
        (the JAX embed mode, `nn/tasks.py:1277-1283`); a head that reads one
        map (classify) ignores it there and here."""
        return self._run(x, decode=decode, aux=aux, dn=dn, embed=embed)

    def info(self, verbose: bool = False):
        """(layers, parameters) as the JAX `BaseModel.info` (`nn/tasks.py:1482`)
        counts them: the parameters of its flax tree, which holds no DFL bins."""
        n_params = sum(p.numel() for name, p in self.named_parameters() if not name.endswith("dfl.conv.weight"))
        if verbose:
            LOGGER.info(f"{self.__class__.__name__}: {len(self.model)} layers, {n_params:,} parameters")
        return len(self.model), n_params


class DetectionModel(BaseModel):
    task = "detect"


class SegmentationModel(DetectionModel):
    task = "segment"


class PoseModel(DetectionModel):
    task = "pose"


class OBBModel(DetectionModel):
    task = "obb"


class ClassificationModel(BaseModel):
    task = "classify"


TASK2MODEL = {"detect": DetectionModel, "segment": SegmentationModel, "pose": PoseModel, "obb": OBBModel,
              "classify": ClassificationModel}


def size_bound(model: nn.Module) -> list:
    """The modules of model whose parameters are sized by their input map
    (`size_params`: MHSA's `rel_h`, `rel_w`; EfficientFormerV2's
    Attention4D and Attention4DDownsample's `attention_biases`), bound by
    `bind(h, w)`."""
    return [m for m in model.modules() if getattr(m, "size_params", ())]


def _recompute_context():
    """torch.utils.checkpoint's context_fn: nothing around the first forward,
    `recomputing()` around the backward's re-run (BatchNorm2d updates its
    running statistics once)."""
    return contextlib.nullcontext(), recomputing()


def model_class_for(task: str):
    """The model class for a task: detect, segment, pose, obb and classify are ported."""
    if task not in TASK2MODEL:
        raise NotImplementedError(f"task '{task}' is not implemented in ultralytics_pro_tpu_torch; "
                                  f"implemented: {sorted(TASK2MODEL)} (every task of the JAX package; its "
                                  "World and YOLOE model classes wait for ROADMAP.md queue 1 item 9)")
    return TASK2MODEL[task]
