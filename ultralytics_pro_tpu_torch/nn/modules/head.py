"""The anchor-free Detect head and its decodes, the Segment, OBB and Pose
heads, the Classify head, and the RT-DETR decoder head.

Counterpart of `ultralytics_pro_tpu/nn/modules/head.py` (`Detect:48`,
`_decode:87`, `decode_single_label:127`, `Segment:170`, `OBB:193`,
`Pose:222`, `Classify:418`, `RTDETRDecoder:440`). Module names follow the
torch reference (`cv2.i.0.conv.weight`, `cv3.i.2.bias`, `dfl.conv.weight`,
`cv4.i.2.bias`, `proto.upsample.weight`, `conv.conv.weight`,
`linear.weight`, `decoder.layers.i.cross_attn.value_proj.weight`).

Raw per-level maps are NCHW (B, 4*reg_max + nc, H, W). Decoded outputs are
anchor-major like the JAX package's: (B, A, 4 + nc), anchors ordered level by
level, then row by row; Segment appends nm mask coefficients and Pose the
decoded keypoints to each anchor's row. OBB's rows are (B, A, 4 + nc + 1):
rotated (cx, cy, w, h), the class scores, then the angle in radians. Segment's prototypes stay NCHW
(B, nm, H/4, W/4), where the JAX package's are channel-last.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ultralytics_pro_tpu_torch.nn.modules.block import DFL, Proto, dfl_expectation
from ultralytics_pro_tpu_torch.nn.modules.conv import BN_EPS, BN_MOMENTUM, BatchNorm2d, Conv
from ultralytics_pro_tpu_torch.nn.modules.transformer import LN_EPS, MLP, DeformableTransformerDecoderLayer
from ultralytics_pro_tpu_torch.ops.anchors import dist2bbox, dist2rbox, make_anchors
from ultralytics_pro_tpu_torch.ops.nms import _topk


def _level_boxes(dist: torch.Tensor, stride: float) -> torch.Tensor:
    """One level's distances (B, 4, H, W) -> (B, H*W, 4) xywh boxes in pixels."""
    _, _, h, w = dist.shape
    anchors, _ = make_anchors([(h, w)], [stride], device=dist.device)
    return dist2bbox(dist.flatten(2).transpose(1, 2), anchors, xywh=True) * stride


class Detect(nn.Module):
    """Anchor-free YOLOv8 detect head (legacy branch form)."""

    def __init__(self, nc: int = 80, ch=(), reg_max: int = 16):
        super().__init__()
        self.nc = nc
        self.nl = len(ch)
        self.reg_max = reg_max
        self.no = nc + 4 * reg_max
        self.stride = torch.zeros(self.nl)  # set by DetectionModel once strides are known
        c2, c3 = max(16, ch[0] // 4, reg_max * 4), max(ch[0], min(nc, 100))
        self.cv2 = nn.ModuleList(
            nn.Sequential(Conv(x, c2, 3), Conv(c2, c2, 3), nn.Conv2d(c2, 4 * reg_max, 1))
            for x in ch)
        self.cv3 = nn.ModuleList(
            nn.Sequential(Conv(x, c3, 3), Conv(c3, c3, 3), nn.Conv2d(c3, nc, 1)) for x in ch)
        self.dfl = DFL(reg_max)

    def bias_init(self) -> None:
        """Box bias 1.0, class bias log(5 / nc / (640 / s)^2), as the reference initialises them."""
        for a, b, s in zip(self.cv2, self.cv3, self.stride.tolist()):
            a[-1].bias.data[:] = 1.0
            b[-1].bias.data[: self.nc] = math.log(5 / self.nc / (640 / s) ** 2)

    def raw(self, feats):
        """Per-level raw maps: box (4*reg_max) and class (nc) channels, concatenated."""
        return [torch.cat([self.cv2[i](x), self.cv3[i](x)], 1) for i, x in enumerate(feats)]

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

    def __init__(self, nc: int = 80, ch=(), nm: int = 32, npr: int = 256, reg_max: int = 16):
        super().__init__(nc, ch, reg_max)
        self.nm, self.npr = nm, npr
        self.proto = Proto(ch[0], npr, nm)
        self.cv4 = _branches(ch, max(ch[0] // 4, nm), nm)

    def forward(self, feats, decode: bool = True):
        aux = {"feats": self.raw(feats), "mc": _per_anchor(self.cv4, feats), "protos": self.proto(feats[0])}
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

    def __init__(self, nc: int = 80, ch=(), ne: int = 1, reg_max: int = 16):
        super().__init__(nc, ch, reg_max)
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

    def __init__(self, nc: int = 80, ch=(), kpt_shape=(17, 3), reg_max: int = 16):
        super().__init__(nc, ch, reg_max)
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


class Classify(nn.Module):
    """Image classification head: a Conv to 1280 channels, the global mean,
    then a Linear to c2 classes; logits in train mode, their softmax in eval
    mode. Several inputs are concatenated along the channels first."""

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
