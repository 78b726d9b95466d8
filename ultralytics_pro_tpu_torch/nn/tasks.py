"""Model YAML -> torch modules: parse_model, BaseModel and the task models.

Counterpart of `ultralytics_pro_tpu/nn/tasks.py` (`parse_model:1126`,
`YOLOModule._forward:1230`, `yaml_model_load:1311`, `split_scale:1328`,
`find_model_yaml:1347`, `BaseModel:1361`, `DetectionModel:1491`,
`SegmentationModel:1495`, `PoseModel:1499`, `OBBModel:1503`,
`ClassificationModel:1507`, `model_class_for:1610`, `guess_model_task:1624`)
for the YOLOv8 module set (Conv, C2f, SPPF, nn.Upsample, Concat, Detect,
Segment, OBB, Pose, Classify) and
RT-DETR's (DWConv, HGStem, HGBlock, RepC3, AIFI, RTDETRDecoder; builders at
`:85`, `:260-263`, `:441-447`). Segment's args are [nc, nm, npr] with npr
width-scaled, OBB's [nc, ne], Pose's [nc, kpt_shape] with the YAML's
top-level `kpt_shape` substituted, as the JAX package's `parse_model` reads
them (`:206-212`, `:1179-1181`). Any other module raises
NotImplementedError naming it, and the detect heads of the v5 and v10 YAMLs
name their ROADMAP queue item too.

In train mode (`model.train()`) a Detect model returns the head's raw
per-level maps, NCHW, as the JAX head returns `{"feats": raw}` when
`train=True` (`nn/modules/head.py:120-123`). A classification model returns
(B, nc) logits in train mode and their softmax in eval mode; it has no
detect head, so no strides are probed.

Models are nn.Modules in NCHW whose parameter names are the reference's
(`model.N.cv1.conv.weight`). Weights are initialised from an explicit
`torch.Generator`, so a seed fixes them.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Optional

import torch
from torch import nn

from ultralytics_pro_tpu_torch.nn.modules.block import SPPF, C2f, HGBlock, HGStem, RepC3
from ultralytics_pro_tpu_torch.nn.modules.conv import Concat, Conv, DWConv
from ultralytics_pro_tpu_torch.nn.modules.head import OBB, Classify, Detect, Pose, RTDETRDecoder, Segment
from ultralytics_pro_tpu_torch.nn.modules.transformer import AIFI, MSDeformAttn, MultiheadAttention
from ultralytics_pro_tpu_torch.utils import LOGGER, PKG_ROOT, miniyaml

SCALED = {"Conv": Conv, "DWConv": DWConv, "C2f": C2f, "SPPF": SPPF, "RepC3": RepC3}  # c2 is width-scaled
HEADS = {"Detect": Detect, "Segment": Segment, "OBB": OBB, "Pose": Pose}
MODULES = (*SCALED, "HGStem", "HGBlock", "AIFI", "nn.Upsample", "Concat", *HEADS, "Classify", "RTDETRDecoder")
QUEUED = {  # heads of YAMLs the JAX package trains, and where the port takes them up
    "AnchorDetect": "ROADMAP.md queue 1 item 9 (the v5 YAMLs, with v5AnchorLoss)",
    "v10Detect": "ROADMAP.md queue 1 item 9 (v10, with E2EDetectLoss)",
}


def make_divisible(x, divisor: int = 8) -> int:
    """Round a channel count up to a multiple of divisor."""
    return math.ceil(x / divisor) * divisor


def parse_model(d: dict, ch: int = 3, verbose: bool = False):
    """Build the layers of a model YAML dict.

    Returns (nn.Sequential of layers, sorted save list, meta dict). Each layer
    carries `i` (index), `f` (from) and `type` attributes.
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
    act = d.get("activation")
    if act:
        Conv.default_act = act
    try:
        chs = [ch]
        layers, save = [], []
        rows = list(d.get("backbone", [])) + list(d.get("head", []))
        for i, row in enumerate(rows):
            if len(row) != 4:
                raise NotImplementedError(
                    f"malformed model-yaml row {i}: expected [from, repeats, module, args], got {row!r}")
            f, n, m_name, args = row
            if m_name in QUEUED:
                raise NotImplementedError(f"module '{m_name}' (layer {i}) is not implemented in "
                                          f"ultralytics_pro_tpu_torch yet: {QUEUED[m_name]}")
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
                args = [c1, c2, *args[1:]]
                if m_name in ("C2f", "RepC3"):  # the repeats are the block's own n
                    args.insert(2, n)
                    n = 1
                m = SCALED[m_name]
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
            elif m_name in HEADS:
                c2, m = None, HEADS[m_name]
                extra = []
                if m_name == "Segment":  # [nc, nm, npr], npr width-scaled
                    npr = args[2] if len(args) > 2 else 256
                    extra = [args[1] if len(args) > 1 else 32, make_divisible(min(npr, max_channels) * width, 8)]
                elif m_name == "OBB":  # [nc, ne]
                    extra = [args[1] if len(args) > 1 else 1]
                elif m_name == "Pose":  # [nc, kpt_shape]
                    extra = [tuple(args[1] if len(args) > 1 else (17, 3))]
                args = [args[0], [chs[x] for x in f], *extra]
            elif m_name == "Classify":  # [c2, k, s, p, g], the inputs' channels summed
                c2, m = args[0], Classify
                args = [c1 if c1 is not None else sum(chs[x] for x in f), *args]
            else:  # RTDETRDecoder [nc, hd, nq, ndl], as the JAX builder reads them (tasks.py:195)
                c2, m = None, RTDETRDecoder
                args = [args[0], [chs[x] for x in f], *args[1:4]]
            layer = nn.Sequential(*(m(*args) for _ in range(n))) if n > 1 else m(*args)
            # relative sources other than -1 become absolute layer indices (-2 -> i - 2)
            layer.f = f if f == -1 else f % i if isinstance(f, int) else [x if x == -1 else x % i for x in f]
            layer.i, layer.type = i, m_name
            layers.append(layer)
            save.extend(x % i for x in ([f] if isinstance(f, int) else f) if x != -1)
            if verbose:
                LOGGER.info(f"{i:>3} {str(f):>10} {n:>3} {m_name:<12} {args}")
            if i == 0:
                chs = []
            chs.append(c2)
    finally:
        Conv.default_act = "silu"
    return nn.Sequential(*layers), sorted(set(save)), {"scale": scale, "nc": nc}


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
    zero, BatchNorm and LayerNorm at identity, embeddings normal(1.0); then
    MSDeformAttn's own offset and attention init."""
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)) and m.weight.requires_grad:
            _lecun_normal_(m.weight, generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, MultiheadAttention):
            _lecun_normal_(m.in_proj_weight, generator)
            nn.init.zeros_(m.in_proj_bias)
        elif isinstance(m, (nn.BatchNorm2d, nn.LayerNorm)):
            m.reset_parameters()
        elif isinstance(m, nn.Embedding):
            with torch.no_grad():
                m.weight.copy_(torch.empty(m.weight.shape).normal_(generator=generator))
    for m in model.modules():
        if isinstance(m, MSDeformAttn):
            m.reset_parameters()


class BaseModel(nn.Module):
    """A YAML-built model: layers run in order with a save list of outputs that
    later layers read (the reference's `_predict_once`)."""

    task = "detect"

    def __init__(self, cfg="yolov8n.yaml", ch: int = 3, nc: Optional[int] = None,
                 verbose: bool = False, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.yaml = dict(cfg) if isinstance(cfg, dict) else yaml_model_load(cfg)
        if nc and nc != self.yaml.get("nc"):
            self.yaml["nc"] = nc
        self.model, self.save, meta = parse_model(self.yaml, ch=ch, verbose=verbose)
        self.nc = meta["nc"]
        self.names = {i: f"class{i}" for i in range(self.nc)}
        self.eval()
        self.stride = torch.tensor([32.0])
        head = self.model[-1]
        if isinstance(head, (Detect, RTDETRDecoder)):
            head.stride = self._infer_strides(ch)
            self.stride = head.stride
        init_weights(self, generator if generator is not None else torch.Generator().manual_seed(0))
        if isinstance(head, Detect):
            head.bias_init()

    def _infer_strides(self, ch: int) -> torch.Tensor:
        """Strides from the head's input map sizes on a 256 px dry run."""
        s = 256
        with torch.no_grad():
            feats = self._run(torch.zeros(1, ch, s, s), stop_at_head=True)
        return torch.tensor([s / x.shape[-2] for x in feats])

    def _run(self, x, stop_at_head: bool = False, decode: bool = True, aux: bool = True, dn=None):
        y = {}
        for m in self.model:
            if m.f != -1:
                x = y[m.f] if isinstance(m.f, int) else [x if j == -1 else y[j] for j in m.f]
            if isinstance(m, Detect):
                return x if stop_at_head else m(x, decode=decode and not self.training)
            if isinstance(m, RTDETRDecoder):
                return x if stop_at_head else m(x, aux=aux, dn=dn)
            x = m(x)
            if m.i in self.save:
                y[m.i] = x
        return x

    def forward(self, x: torch.Tensor, decode: bool = True, aux: bool = True, dn=None):
        """x (B, C, H, W) float. For a Detect model: (decoded (B, A, 4+nc), raw
        per-level maps), or the raw maps alone when decode=False or in train
        mode; Segment, OBB and Pose models give their head's (y, dict), or
        the dict alone (`Segment.forward`, `OBB.forward`, `Pose.forward`). For an RT-DETR model:
        (y (B, nq, 4+nc), aux), aux None when aux=False, and in train mode
        aux alone, with the denoising queries `dn` when given (see
        `RTDETRDecoder.forward`; the JAX model passes `dn` to its head as
        here, `nn/tasks.py:1241,1294`). For a classification model: (B, nc)
        logits in train mode, their softmax in eval mode."""
        return self._run(x, decode=decode, aux=aux, dn=dn)


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


def model_class_for(task: str):
    """The model class for a task: detect, segment, pose, obb and classify are ported."""
    if task not in TASK2MODEL:
        raise NotImplementedError(f"task '{task}' is not implemented in ultralytics_pro_tpu_torch; "
                                  f"implemented: {sorted(TASK2MODEL)} (every task of the JAX package; its "
                                  "World and YOLOE model classes wait for ROADMAP.md queue 1 item 9)")
    return TASK2MODEL[task]
