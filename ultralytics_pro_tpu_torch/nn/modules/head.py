"""The anchor-free Detect head and its decodes, the Segment, OBB and Pose
heads, the Classify head, and the RT-DETR decoder head.

Counterpart of `ultralytics_pro_tpu/nn/modules/head.py` (`_branch:30`,
`Detect:48`, `_decode:87`, `decode_single_label:127`, `Segment:170`,
`OBB:193`, `Pose:222`, `IDetect:259`, `DDetect:278`, `ISegment:300`,
`IOBB:304`, `IPose:308`, `DSegment:312`, `MAFDetect:342`,
`MAFSegment:406`, `MAFOBB:410`, `MAFPose:414`, `Classify:418`,
`RTDETRDecoder:440`, `v10Detect:709`, `AnchorDetect:795` with
`V5_ANCHORS:788`). Module names follow the
torch reference (`cv2.i.0.conv.weight`, `cv3.i.2.bias`, `dfl.conv.weight`,
`cv4.i.2.bias`, `proto.upsample.weight`, `conv.conv.weight`,
`linear.weight`, `decoder.layers.i.cross_attn.value_proj.weight`).

Raw per-level maps are NCHW (B, 4*reg_max + nc, H, W). Decoded outputs are
anchor-major like the JAX package's: (B, A, 4 + nc), anchors ordered level by
level, then row by row; Segment appends nm mask coefficients and Pose the
decoded keypoints to each anchor's row. OBB's rows are (B, A, 4 + nc + 1):
rotated (cx, cy, w, h), the class scores, then the angle in radians. Segment's prototypes stay NCHW
(B, nm, H/4, W/4), where the JAX package's are channel-last. v10Detect's
eval rows are (B, k, 6): xywh, conf, cls. AnchorDetect's raw maps are
(B, na * (5 + nc), H, W) and its decoded rows (B, A, 4 + nc), A = H * W * na
a level, anchors in (h, w, na) order.

Each head class says which task it serves (`task`: "detect", "segment",
"pose", "obb", "classify", or "rtdetr" for RT-DETR's NMS-free decoder) and
whether its predict takes test-time augmentation (`tta`); the predictors
read these and nothing else of a head's type. A head that combines two
(ISegment, MAFPose) takes both from its task's class through the MRO: the
I- and MAF- detect bases set neither.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ultralytics_pro_tpu_torch.nn.modules.block import DFL, Proto, dfl_expectation
from ultralytics_pro_tpu_torch.nn.modules.conv import (
    BN_EPS,
    BN_MOMENTUM,
    BatchNorm2d,
    Conv,
    DWConv,
    ImplicitA,
    ImplicitM,
)
from ultralytics_pro_tpu_torch.nn.modules.reparam import UniRepLKNetBlock
from ultralytics_pro_tpu_torch.nn.modules.transformer import LN_EPS, MLP, DeformableTransformerDecoderLayer
from ultralytics_pro_tpu_torch.ops.anchors import dist2bbox, dist2rbox, make_anchors
from ultralytics_pro_tpu_torch.ops.nms import _topk


def _level_boxes(dist: torch.Tensor, stride: float) -> torch.Tensor:
    """One level's distances (B, 4, H, W) -> (B, H*W, 4) xywh boxes in pixels."""
    _, _, h, w = dist.shape
    anchors, _ = make_anchors([(h, w)], [stride], device=dist.device)
    return dist2bbox(dist.flatten(2).transpose(1, 2), anchors, xywh=True) * stride


class Detect(nn.Module):
    """Anchor-free YOLOv8 detect head. legacy=False (a YAML with C3k2, C2fCIB
    or v10Detect) gives each class branch the light form: DWConv 3x3 and
    Conv 1x1, twice, then the 1x1 conv (`cv3.i.0.0`, `cv3.i.0.1`,
    `cv3.i.1.0`, `cv3.i.1.1`, `cv3.i.2`).

    fused_single_label: the predictor's `run` decodes this head's raw maps
    with `decode_single_label` and the fused NMS; True for this class only,
    as the JAX predictor takes that branch for a head named Detect alone."""

    task = "detect"
    tta = True  # predict(augment=True) runs the three-scale forward (not for an end-to-end head)
    end2end = False
    fused_single_label = True

    def __init__(self, nc: int = 80, ch=(), reg_max: int = 16, legacy: bool = True):
        super().__init__()
        self.nc = nc
        self.nl = len(ch)
        self.reg_max = reg_max
        self.legacy = legacy
        self.no = nc + 4 * reg_max
        self.stride = torch.zeros(self.nl)  # set by DetectionModel once strides are known
        self.c2, self.c3 = self._head_channels(ch[0])
        self.cv2 = nn.ModuleList(self._box_branch(x) for x in ch)
        self.cv3 = nn.ModuleList(self._cls_branch(x) for x in ch)
        self.dfl = DFL(reg_max)

    def _head_channels(self, ch0: int):
        """(box branch width, class branch width)."""
        return max(16, ch0 // 4, self.reg_max * 4), max(ch0, min(self.nc, 100))

    def _box_branch(self, x: int) -> nn.Sequential:
        return nn.Sequential(Conv(x, self.c2, 3), Conv(self.c2, self.c2, 3), nn.Conv2d(self.c2, 4 * self.reg_max, 1))

    def _cls_branch(self, x: int, legacy: bool | None = None) -> nn.Sequential:
        c3 = self.c3
        if self.legacy if legacy is None else legacy:
            return nn.Sequential(Conv(x, c3, 3), Conv(c3, c3, 3), nn.Conv2d(c3, self.nc, 1))
        return nn.Sequential(nn.Sequential(DWConv(x, x, 3), Conv(x, c3, 1)),
                             nn.Sequential(DWConv(c3, c3, 3), Conv(c3, c3, 1)), nn.Conv2d(c3, self.nc, 1))

    def branch_pairs(self):
        """(box branches, class branches) whose last convs take `bias_init`."""
        return [(self.cv2, self.cv3)]

    def bias_init(self) -> None:
        """Box bias 1.0, class bias log(5 / nc / (640 / s)^2), as the reference initialises them."""
        for box, cls in self.branch_pairs():
            for a, b, s in zip(box, cls, self.stride.tolist()):
                a[-1].bias.data[:] = 1.0
                b[-1].bias.data[: self.nc] = math.log(5 / self.nc / (640 / s) ** 2)

    def raw(self, feats, box=None, cls=None):
        """Per-level raw maps: box (4*reg_max) and class (nc) channels, concatenated."""
        box, cls = (self.cv2, self.cv3) if box is None else (box, cls)
        return [torch.cat([box[i](x), cls[i](x)], 1) for i, x in enumerate(feats)]

    def decode(self, raw) -> torch.Tensor:
        """(B, A, 4 + nc): xywh pixel boxes and sigmoid class scores."""
        outs = []
        for r, s in zip(raw, self.stride.tolist()):
            b = r.shape[0]
            dbox = _level_boxes(self.dfl(r[:, :4 * self.reg_max].float()), float(s))
            cls = r[:, 4 * self.reg_max:].float().sigmoid().flatten(2).transpose(1, 2)
            outs.append(torch.cat([dbox, cls.reshape(b, -1, self.nc)], -1))
        return torch.cat(outs, 1)

    def forward(self, feats, decode: bool = True):
        raw = self.raw(feats)
        if not decode:
            return raw
        return self.decode(raw), raw


class v10Detect(Detect):
    """YOLOv10's NMS-free head: Detect's branches (one-to-many) and a copy of
    them (`one2one_cv2`, `one2one_cv3`) that reads the levels detached, so
    its loss trains its own parameters only. Always the light class branch.

    Train mode (decode=False): {'feats': one-to-many raw maps, 'one2one':
    one-to-one raw maps}, as the JAX head returns them. Eval: the one-to-one
    maps decoded and their top min(max_det, A * nc) (anchor, class) pairs,
    (B, k, 6) rows of xywh, conf and cls (`postprocess_topk`), with the dict
    of both branches' maps; aux=False skips the one-to-many branch, which a
    predict does not read, and gives None for the dict."""

    end2end = True
    fused_single_label = False
    max_det = 300

    def __init__(self, nc: int = 80, ch=(), reg_max: int = 16, legacy: bool = False):
        super().__init__(nc, ch, reg_max, legacy=False)  # `legacy` is taken and ignored
        self.one2one_cv2 = nn.ModuleList(self._box_branch(x) for x in ch)
        self.one2one_cv3 = nn.ModuleList(self._cls_branch(x) for x in ch)

    def branch_pairs(self):
        return [(self.cv2, self.cv3), (self.one2one_cv2, self.one2one_cv3)]

    def forward(self, feats, decode: bool = True, aux: bool = True):
        o2o = self.raw([f.detach() for f in feats], self.one2one_cv2, self.one2one_cv3)
        if not decode:
            return {"feats": self.raw(feats), "one2one": o2o}
        y = self.postprocess_topk(self.decode(o2o))
        return y, ({"feats": self.raw(feats), "one2one": o2o} if aux else None)

    def postprocess_topk(self, y: torch.Tensor) -> torch.Tensor:
        """(B, A, 4 + nc) -> (B, k, 6): the top k = min(max_det, A * nc)
        scores over the flat (anchor, class) pairs, ties to the lower index as
        `lax.top_k` breaks them (a stable descending sort), each with its
        anchor's box and its class."""
        b, a, no = y.shape
        nc = no - 4
        top, idx = _topk(y[..., 4:].reshape(b, -1), min(self.max_det, a * nc))
        boxes = torch.gather(y[..., :4], 1, (idx // nc)[..., None].expand(-1, -1, 4))
        return torch.cat([boxes, top[..., None], (idx % nc).to(y.dtype)[..., None]], -1)


class DDetect(Detect):
    """YOLOv9's detect head: the box branch a 3x3 Conv, a 3x3 Conv of 4
    groups and a 1x1 conv of 4 groups (`cv2.i.2`), its width rounded up to
    a multiple of 4; the class branch Detect's, max(ch0, min(2 nc, 128)) wide."""

    fused_single_label = False

    def _head_channels(self, ch0: int):
        c2 = max(ch0 // 4, self.reg_max * 4, 16)
        return -(-c2 // 4) * 4, max(ch0, min(self.nc * 2, 128))

    def _box_branch(self, x: int) -> nn.Sequential:
        return nn.Sequential(Conv(x, self.c2, 3), Conv(self.c2, self.c2, 3, g=4),
                             nn.Conv2d(self.c2, 4 * self.reg_max, 1, groups=4))


def _branches(ch, mid: int, out: int) -> nn.ModuleList:
    """One extra branch per level (the JAX `_branch`, legacy form): Conv 3x3,
    Conv 3x3, 1x1 conv with bias."""
    return nn.ModuleList(nn.Sequential(Conv(x, mid, 3), Conv(mid, mid, 3), nn.Conv2d(mid, out, 1)) for x in ch)


def _per_anchor(branches, feats) -> torch.Tensor:
    """Every level's branch output, anchor-major: (B, A, out)."""
    return torch.cat([m(x).flatten(2) for m, x in zip(branches, feats)], 2).transpose(1, 2)


class Segment(Detect):
    """Detect plus nm mask coefficients per anchor (`cv4`) and the prototype
    masks (`proto`) on the first level's map.

    Eval: (y (B, A, 4 + nc + nm), {'feats': raw, 'mc': (B, A, nm), 'protos':
    (B, nm, H/4, W/4)}); with decode=False (and in train mode) the dict alone.
    """

    task = "segment"
    tta = False
    fused_single_label = False

    def __init__(self, nc: int = 80, ch=(), nm: int = 32, npr: int = 256, reg_max: int = 16,
                 legacy: bool = True):
        super().__init__(nc, ch, reg_max, legacy)
        self.nm, self.npr = nm, npr
        self.proto = Proto(ch[0], npr, nm)
        self.cv4 = _branches(ch, max(ch[0] // 4, nm), nm)

    def forward(self, feats, decode: bool = True):
        aux = {"feats": self.raw(feats), "mc": _per_anchor(self.cv4, feats), "protos": self.proto(feats[0])}
        if not decode:
            return aux
        return torch.cat([self.decode(aux["feats"]), aux["mc"]], -1), aux


class DSegment(DDetect, Segment):
    """DDetect over all inputs but the last, plus nm mask coefficients per
    anchor (`cv4`, max(ch0 // 4, nm) wide) and the prototypes, a 1x1 Conv
    (`proto`) on the last input. The outputs are Segment's."""

    def __init__(self, nc: int = 80, ch=(), nm: int = 32, npr: int = 256, reg_max: int = 16,
                 legacy: bool = True):
        DDetect.__init__(self, nc, ch[:-1], reg_max, legacy)
        self.nm, self.npr = nm, npr
        self.proto = Conv(ch[-1], nm, 1)
        self.cv4 = _branches(ch[:-1], max(ch[0] // 4, nm), nm)

    def forward(self, feats, decode: bool = True):
        det = feats[:-1]
        aux = {"feats": self.raw(det), "mc": _per_anchor(self.cv4, det), "protos": self.proto(feats[-1])}
        if not decode:
            return aux
        return torch.cat([self.decode(aux["feats"]), aux["mc"]], -1), aux


class OBB(Detect):
    """Detect plus ne rotation angles per anchor (`cv4`), (sigmoid - 0.25) * pi,
    in [-pi/4, 3pi/4).

    Eval: (y (B, A, 4 + nc + ne), {'feats': raw, 'angle': (B, A, ne)}), the
    boxes decoded by `dist2rbox` with the first angle; with decode=False (and
    in train mode) the dict alone.
    """

    task = "obb"
    tta = False
    fused_single_label = False

    def __init__(self, nc: int = 80, ch=(), ne: int = 1, reg_max: int = 16, legacy: bool = True):
        super().__init__(nc, ch, reg_max, legacy)
        self.ne = ne
        self.cv4 = _branches(ch, max(ch[0] // 4, ne), ne)

    def forward(self, feats, decode: bool = True):
        angle = (_per_anchor(self.cv4, feats).float().sigmoid() - 0.25) * math.pi
        aux = {"feats": self.raw(feats), "angle": angle}
        if not decode:
            return aux
        return self.decode_rotated(aux["feats"], angle), aux

    def decode_rotated(self, raw, angle: torch.Tensor) -> torch.Tensor:
        """(B, A, 4 + nc + ne): rotated xywh pixel boxes, sigmoid class scores, angles."""
        anchors, stride_t = make_anchors([tuple(r.shape[2:]) for r in raw], self.stride.tolist(),
                                         device=raw[0].device)
        per_anchor = lambda maps: torch.cat([m.flatten(2) for m in maps], 2).transpose(1, 2)  # noqa: E731
        dist = per_anchor([self.dfl(r[:, :4 * self.reg_max].float()) for r in raw])
        cls = per_anchor([r[:, 4 * self.reg_max:].float() for r in raw]).sigmoid()
        dbox = dist2rbox(dist, angle[..., :1], anchors[None]) * stride_t[None]
        return torch.cat([dbox, cls, angle], -1)


class Pose(Detect):
    """Detect plus kpt_shape[0] keypoints of kpt_shape[1] values per anchor (`cv4`).

    Eval: (y (B, A, 4 + nc + nk), {'feats': raw, 'kpt': (B, A, nk) raw}), the
    keypoints of y decoded in pixels (`kpts_decode`); with decode=False (and
    in train mode) the dict alone.
    """

    task = "pose"
    tta = False
    fused_single_label = False

    def __init__(self, nc: int = 80, ch=(), kpt_shape=(17, 3), reg_max: int = 16, legacy: bool = True):
        super().__init__(nc, ch, reg_max, legacy)
        self.kpt_shape = tuple(kpt_shape)
        self.nk = self.kpt_shape[0] * self.kpt_shape[1]
        self.cv4 = _branches(ch, max(ch[0] // 4, self.nk), self.nk)

    def forward(self, feats, decode: bool = True):
        aux = {"feats": self.raw(feats), "kpt": _per_anchor(self.cv4, feats)}
        if not decode:
            return aux
        anchors, stride_t = make_anchors([tuple(f.shape[2:]) for f in feats], self.stride.tolist(),
                                         device=feats[0].device)
        return torch.cat([self.decode(aux["feats"]), self.kpts_decode(aux["kpt"], anchors, stride_t)], -1), aux

    def kpts_decode(self, kpt: torch.Tensor, anchors: torch.Tensor, stride_t: torch.Tensor) -> torch.Tensor:
        """(B, A, nk) raw keypoints -> pixels: xy as (2k + anchor - 0.5) * stride,
        the visibility through a sigmoid when kpt_shape[1] is 3."""
        b, a, _ = kpt.shape
        k = kpt.float().reshape(b, a, *self.kpt_shape)
        xy = (k[..., :2] * 2.0 + (anchors[None, :, None, :] - 0.5)) * stride_t[None, :, None, :]
        if self.kpt_shape[1] == 3:
            xy = torch.cat([xy, k[..., 2:3].sigmoid()], -1)
        return xy.reshape(b, a, -1)


class IDetect(Detect):
    """YOLOR's and YOLOv7's anchor-free detect head: Detect with YOLOR's
    implicit knowledge around each level's branches, an ImplicitA before the
    box and the class branch (`ia2.i`, `ia3.i`) and an ImplicitM after them
    (`im2.i`, `im3.i`). The box branch is Detect's (always the legacy one).
    Not the fused single-label path: the JAX predictor takes that for a head
    named Detect alone."""

    fused_single_label = False

    def __init__(self, nc: int = 80, ch=(), reg_max: int = 16, legacy: bool = True):
        super().__init__(nc, ch, reg_max, legacy)
        self._implicit(ch)

    def _implicit(self, ch) -> None:
        self.ia2 = nn.ModuleList(ImplicitA(x) for x in ch)
        self.ia3 = nn.ModuleList(ImplicitA(x) for x in ch)
        self.im2 = nn.ModuleList(ImplicitM(4 * self.reg_max) for _ in ch)
        self.im3 = nn.ModuleList(ImplicitM(self.nc) for _ in ch)

    def raw(self, feats):
        return [torch.cat([self.im2[i](self.cv2[i](self.ia2[i](x))), self.im3[i](self.cv3[i](self.ia3[i](x)))], 1)
                for i, x in enumerate(feats)]


class ISegment(IDetect, Segment):
    """IDetect plus Segment's mask coefficients and prototypes, which read
    the plain maps (no implicit layers)."""

    def __init__(self, nc: int = 80, ch=(), nm: int = 32, npr: int = 256, reg_max: int = 16,
                 legacy: bool = True):
        Segment.__init__(self, nc, ch, nm, npr, reg_max, legacy)
        self._implicit(ch)


class IOBB(IDetect, OBB):
    """IDetect plus OBB's angle branch, which reads the plain maps."""

    def __init__(self, nc: int = 80, ch=(), ne: int = 1, reg_max: int = 16, legacy: bool = True):
        OBB.__init__(self, nc, ch, ne, reg_max, legacy)
        self._implicit(ch)


class IPose(IDetect, Pose):
    """IDetect plus Pose's keypoint branch, which reads the plain maps."""

    def __init__(self, nc: int = 80, ch=(), kpt_shape=(17, 3), reg_max: int = 16, legacy: bool = True):
        Pose.__init__(self, nc, ch, kpt_shape, reg_max, legacy)
        self._implicit(ch)


class MAFDetect(Detect):
    """MAF-YOLO's detect head: the box branch a 1x1 Conv, a UniRepLKNetBlock
    (k 5), a 1x1 Conv (`cv2.i.0`-`.2`) and the 1x1 conv to 4 reg_max
    (`cv2.i.3`, bias 1.0); the class branch always the light one (`cv3.i.0.0`
    to `cv3.i.2`), whatever the YAML's legacy flag. Not the fused
    single-label path (the JAX predictor takes that for a head named Detect
    alone)."""

    fused_single_label = False

    def _box_branch(self, x: int) -> nn.Sequential:
        return nn.Sequential(Conv(x, self.c2, 1), UniRepLKNetBlock(self.c2, 5), Conv(self.c2, self.c2, 1),
                             nn.Conv2d(self.c2, 4 * self.reg_max, 1))

    def _cls_branch(self, x: int, legacy: bool | None = None) -> nn.Sequential:
        return super()._cls_branch(x, legacy=False)


class MAFSegment(MAFDetect, Segment):
    """MAFDetect plus Segment's mask coefficients and prototypes."""


class MAFOBB(MAFDetect, OBB):
    """MAFDetect plus OBB's angle branch."""


class MAFPose(MAFDetect, Pose):
    """MAFDetect plus Pose's keypoint branch."""


V5_ANCHORS = (  # pixels, per level (P3, P4, P5): the COCO anchors of the YOLOv5 YAMLs
    ((10, 13), (16, 30), (33, 23)),
    ((30, 61), (62, 45), (59, 119)),
    ((116, 90), (156, 198), (373, 326)),
)


class AnchorDetect(nn.Module):
    """YOLOv5's anchor-based head: one 1x1 conv a level (`m.i`, with bias)
    giving na * (5 + nc) channels, anchor after anchor: xywh, objectness,
    classes. Eval decodes each (cell, anchor) as xy = (2 sig - 0.5 + grid) *
    stride, wh = (2 sig)^2 * anchor, score = sig(obj) * sig(cls), to (B, A,
    4 + nc) rows, Detect's contract, so NMS, predict and val take it as
    Detect's. Train mode (decode=False) returns {'feats': raw, 'anchor_feats':
    raw}, the maps `v5AnchorLoss` reads. Not a Detect subclass: it has none
    of Detect's branches; the model, the detect validator and trainer, and
    the predictor name it beside Detect.

    implicit=True is YOLOv7's anchor head: an ImplicitA before each level's
    conv (`ia.i`) and an ImplicitM after it (`im.i`), the same decode."""

    task = "detect"
    tta = True
    end2end = False
    fused_single_label = False

    def __init__(self, nc: int = 80, ch=(), anchors=V5_ANCHORS, implicit: bool = False, legacy: bool = True):
        super().__init__()
        self.nc, self.nl, self.legacy, self.implicit = nc, len(ch), legacy, implicit
        self.na = len(anchors[0])
        self.no = 5 + nc
        self.stride = torch.zeros(self.nl)
        self.anchor_list = tuple(tuple(tuple(float(v) for v in a) for a in lvl) for lvl in anchors)
        self.register_buffer("anchors", torch.tensor(self.anchor_list, dtype=torch.float32), persistent=False)
        self.m = nn.ModuleList(nn.Conv2d(x, self.na * self.no, 1) for x in ch)
        if implicit:
            self.ia = nn.ModuleList(ImplicitA(x) for x in ch)
            self.im = nn.ModuleList(ImplicitM(self.na * self.no) for _ in ch)

    def raw(self, feats):
        if self.implicit:
            return [im(m(ia(x))) for m, ia, im, x in zip(self.m, self.ia, self.im, feats)]
        return [m(x) for m, x in zip(self.m, feats)]

    def decode(self, raw) -> torch.Tensor:
        outs = []
        for i, (r, s) in enumerate(zip(raw, self.stride.tolist())):
            b, _, h, w = r.shape
            sig = r.float().view(b, self.na, self.no, h, w).permute(0, 3, 4, 1, 2).sigmoid()  # (B, H, W, na, no)
            gy, gx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=r.device),
                                    torch.arange(w, dtype=torch.float32, device=r.device), indexing="ij")
            grid = torch.stack([gx, gy], -1)[None, :, :, None, :]
            xy = (sig[..., :2] * 2.0 - 0.5 + grid) * s
            wh = (sig[..., 2:4] * 2.0) ** 2 * self.anchors[i]
            outs.append(torch.cat([xy, wh, sig[..., 5:] * sig[..., 4:5]], -1).reshape(b, -1, 4 + self.nc))
        return torch.cat(outs, 1)

    def forward(self, feats, decode: bool = True):
        raw = self.raw(feats)
        if not decode:
            return {"feats": raw, "anchor_feats": raw}
        return self.decode(raw), raw


class Classify(nn.Module):
    """Image classification head: a Conv to 1280 channels, the global mean,
    then a Linear to c2 classes; logits in train mode, their softmax in eval
    mode. Several inputs are concatenated along the channels first."""

    task = "classify"
    tta = False

    def __init__(self, c1: int, c2: int = 1000, k=1, s=1, p=None, g: int = 1):
        super().__init__()
        c_ = 1280
        self.conv = Conv(c1, c_, k, s, p, g)
        self.linear = nn.Linear(c_, c2)

    def forward(self, x) -> torch.Tensor:
        if isinstance(x, (list, tuple)):
            x = torch.cat(x, 1)
        logits = self.linear(self.conv(x).mean((2, 3)))
        return logits if self.training else logits.softmax(-1)


def decode_single_label(raw, strides, nc: int, reg_max: int = 16):
    """Fused single-label decode over per-level raw maps.

    Returns (boxes (B, A, 4) xywh f32, conf (B, A) f32, cls (B, A) int32)
    without building the (B, A, nc) score tensor: the class max and argmax are
    taken over all classes per level, and the sigmoid is applied to the max.
    """
    boxes_out, conf_out, cls_out = [], [], []
    bins = torch.arange(reg_max, dtype=torch.float32, device=raw[0].device)
    for r, s in zip(raw, strides):
        boxes_out.append(_level_boxes(dfl_expectation(r[:, :4 * reg_max].float(), bins), float(s)))
        logits = r[:, 4 * reg_max:]
        conf_out.append(logits.amax(1).float().sigmoid().flatten(1))
        cls_out.append(logits.argmax(1).to(torch.int32).flatten(1))
    return torch.cat(boxes_out, 1), torch.cat(conf_out, 1), torch.cat(cls_out, 1)


class RTDETRDecoder(nn.Module):
    """RT-DETR decoder head: project and flatten the multiscale maps, pick
    the top-nq encoder queries by their best class logit, and refine them
    through `ndl` deformable decoder layers. In train mode it takes the
    contrastive-denoising queries (`dn`, from `utils/detr_loss.py:make_cdn_batch`)
    and returns the aux dict alone, as the JAX decoder does.

    Output (B, nq, 4 + nc): normalised cxcywh boxes and sigmoid scores. No NMS.
    """

    task = "rtdetr"
    tta = False

    def __init__(self, nc: int = 80, ch=(), hd: int = 256, nq: int = 300, ndl: int = 6, nh: int = 8,
                 ndp: int = 4, d_ffn: int = 1024):
        super().__init__()
        self.nc, self.hd, self.nq, self.nl = nc, hd, nq, len(ch)
        self.stride = torch.zeros(self.nl)  # set by the model once strides are known
        self.input_proj = nn.ModuleList(
            nn.Sequential(nn.Conv2d(c, hd, 1, bias=False),
                          BatchNorm2d(hd, eps=BN_EPS, momentum=BN_MOMENTUM)) for c in ch)
        self.decoder = nn.Module()  # the reference's name for the layers: decoder.layers.i
        self.decoder.layers = nn.ModuleList(DeformableTransformerDecoderLayer(hd, nh, d_ffn, self.nl, ndp)
                                            for _ in range(ndl))
        self.denoising_class_embed = nn.Embedding(nc + 1, hd)
        self.query_pos_head = MLP(4, 2 * hd, hd, num_layers=2)
        self.enc_output = nn.Sequential(nn.Linear(hd, hd), nn.LayerNorm(hd, eps=LN_EPS))
        self.enc_score_head = nn.Linear(hd, nc)
        self.enc_bbox_head = MLP(hd, hd, 4, num_layers=3)
        self.dec_score_head = nn.ModuleList(nn.Linear(hd, nc) for _ in range(ndl))
        self.dec_bbox_head = nn.ModuleList(MLP(hd, hd, 4, num_layers=3) for _ in range(ndl))

    @staticmethod
    def anchors(shapes, device, grid_size: float = 0.05, eps: float = 1e-2):
        """Grid anchors of every level in logit space, +inf where invalid,
        and the (1, A, 1) validity mask."""
        out = []
        for i, (h, w) in enumerate(shapes):
            sy = (torch.arange(h, dtype=torch.float32, device=device) + 0.5) / h
            sx = (torch.arange(w, dtype=torch.float32, device=device) + 0.5) / w
            gy, gx = torch.meshgrid(sy, sx, indexing="ij")
            xy = torch.stack([gx, gy], -1).reshape(h * w, 2)
            wh = torch.full((h * w, 2), grid_size * (2.0 ** i), dtype=torch.float32, device=device)
            out.append(torch.cat([xy, wh], -1))
        anchors = torch.cat(out, 0)[None]  # (1, A, 4)
        valid = ((anchors > eps) & (anchors < 1 - eps)).all(-1, keepdim=True)
        anchors = torch.log(anchors / (1 - anchors))
        return torch.where(valid, anchors, torch.inf), valid.to(torch.float32)

    @staticmethod
    def dn_attn_mask(t_dn: int, two_g: int, nq: int, device) -> torch.Tensor:
        """The (1, 1, t, t) self-attention mask of a train step with t_dn
        denoising queries in groups of two_g before nq matching queries
        (`head.py:527-541` of the JAX package), True where a query may
        attend: the matching queries see each other only, a denoising query
        sees its own group and the matching queries."""
        t = t_dn + nq
        allowed = torch.zeros((t, t), dtype=torch.bool, device=device)
        allowed[t_dn:, t_dn:] = True
        gi = torch.arange(t_dn, device=device) // two_g
        allowed[:t_dn, :t_dn] = gi[:, None] == gi[None, :]
        allowed[:t_dn, t_dn:] = True
        return allowed[None, None]

    def forward(self, feats, aux: bool = True, dn=None):
        """feats: NCHW maps, one per level. In eval mode returns (y (B, nq,
        4 + nc), aux); in train mode aux alone.

        aux carries the JAX decoder's keys and shapes: 'enc_scores' (B, nq, nc)
        and 'enc_bboxes' (B, nq, 4), the selected queries' encoder logits and
        boxes; 'dec_bboxes' (ndl, B, nq, 4) and 'dec_scores' (ndl, B, nq, nc),
        every decoder layer's boxes and score logits. The port adds
        'topk_index' (B, nq) and 'enc_scores_dense' (B, A, nc), the encoder
        logits of every anchor before the query selection. With aux=False (eval
        only) it is None, and only the last layer's score head runs: what a
        predict keeps of the JAX decoder once its jitted run drops the unused
        outputs.

        dn (train mode only): {"cls": (B, ng, 2G) int, "bbox_logit": (B, ng,
        2G, 4)}. Their t_dn = ng * 2G queries (`denoising_class_embed` rows and
        sigmoid boxes) go before the matching ones, under `dn_attn_mask`, and
        aux gains 'dn_bboxes' (ndl, B, t_dn, 4) and 'dn_scores' (ndl, B, t_dn,
        nc). Gradients stop where the JAX decoder stops them: at the selected
        encoder rows that start the queries, at the boxes each layer samples
        around, and, in train mode, at each layer's output boxes; layer 0's
        query position and box logit read the encoder's boxes undetached."""
        b = feats[0].shape[0]
        shapes = [tuple(f.shape[2:]) for f in feats]
        memory = torch.cat([p(f).flatten(2).transpose(1, 2) for p, f in zip(self.input_proj, feats)], 1)

        anchors, valid = self.anchors(shapes, memory.device)
        enc = self.enc_output(memory * valid)
        enc_scores = self.enc_score_head(enc)  # (B, A, nc)
        # top-nq queries by best class logit, ties in index order as lax.top_k gives them
        nq = min(self.nq, enc_scores.shape[1])
        _, topi = _topk(enc_scores.amax(-1).detach(), nq)  # (B, nq)
        feat_sel = torch.gather(enc, 1, topi[..., None].expand(-1, -1, self.hd))
        anc = torch.gather(anchors.expand(b, -1, -1), 1, topi[..., None].expand(-1, -1, 4))
        refer_bbox = torch.sigmoid(self.enc_bbox_head(feat_sel) + anc)  # (B, nq, 4) cxcywh

        embed, bbox, t_dn, attn_mask = feat_sel.detach(), refer_bbox, 0, None
        if self.training and dn is not None:
            ng, two_g = dn["cls"].shape[1:3]
            t_dn = ng * two_g
            dn_embed = self.denoising_class_embed.weight[dn["cls"].reshape(b, t_dn).long()]
            embed = torch.cat([dn_embed.to(embed.dtype), embed], 1)
            bbox = torch.cat([torch.sigmoid(dn["bbox_logit"].reshape(b, t_dn, 4)), bbox], 1)
            attn_mask = self.dn_attn_mask(t_dn, two_g, nq, memory.device)
        aux = aux or self.training

        ndl = len(self.decoder.layers)
        dec_bboxes, dec_scores = [], []
        for i, layer in enumerate(self.decoder.layers):
            embed = layer(embed, bbox.detach(), memory, shapes, query_pos=self.query_pos_head(bbox),
                          attn_mask=attn_mask)
            logit_prev = torch.log(bbox / (1 - bbox + 1e-9) + 1e-9)
            bbox = torch.sigmoid(self.dec_bbox_head[i](embed) + logit_prev)
            dec_bboxes.append(bbox)
            if aux or i == ndl - 1:
                dec_scores.append(self.dec_score_head[i](embed))
            if self.training:
                bbox = bbox.detach()
        if not aux:
            return torch.cat([bbox, dec_scores[-1].sigmoid()], -1), None
        dec_bboxes, dec_scores = torch.stack(dec_bboxes), torch.stack(dec_scores)
        out = {"dec_bboxes": dec_bboxes[:, :, t_dn:], "dec_scores": dec_scores[:, :, t_dn:],
               "enc_bboxes": refer_bbox,
               "enc_scores": torch.gather(enc_scores, 1, topi[..., None].expand(-1, -1, self.nc)),
               "topk_index": topi, "enc_scores_dense": enc_scores}
        if t_dn:
            out["dn_bboxes"], out["dn_scores"] = dec_bboxes[:, :, :t_dn], dec_scores[:, :, :t_dn]
        if self.training:
            return out
        return torch.cat([dec_bboxes[-1], dec_scores[-1].sigmoid()], -1), out
