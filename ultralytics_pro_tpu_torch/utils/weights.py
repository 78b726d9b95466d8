"""Weights between the JAX package's variables and the port's state_dict.

The JAX package names parameters by flax path
(`params/layers_22/cv2_0_0/conv/kernel`, `batch_stats/layers_2/cv1/bn/mean`);
the port uses the torch reference's names (`model.22.cv2.0.0.conv.weight`,
`model.2.cv1.bn.running_mean`). These functions are the inverse of
`ultralytics_pro_tpu/utils/torch_import.py` (`torch_key_to_flax:42`,
`_convert_array:62`), copied so the port needs nothing of that package:
HWIO conv kernels become OIHW, dense kernels are transposed, `scale` ->
`weight`, `mean`/`var` -> `running_mean`/`running_var`. Only the first path
token `layers_N` is the model's layer `model.N`; a nested one (an MLP's
`layers_0`) is `layers.0`. A layer that the YAML stacks n times (a row
`[-1, 6, Conv, ...]`) is an nn.Sequential here, `model.N.i`, and the JAX
`Repeat`'s children `layers_N/i`.

The extra branch of Segment, Pose and OBB heads (`cv4_i_j` in flax,
`cv4.i.j` here) takes the generic rule.

Segment's `proto.upsample` is a transposed conv. flax keeps its kernel as
(kh, kw, out, in) under `transpose_kernel=True`, and the JAX package loads a
torch `ConvTranspose2d` weight (in, out, kh, kw) through the same
OIHW -> HWIO transpose as a conv (`torch_import.py:13-15`), so the one 4-D
rule carries it both ways: HWIO's last axis becomes torch's first, which for
this kernel is its input channels (`_to_torch_array`).

The YOLOv6 YAMLs' `nn.ConvTranspose2d` layer is a bare module, `model.N`
(`weight`, `bias`), where the JAX package nests it as
`layers_N/conv_transpose`; its kernel takes the transposed conv's rule above.
RepNCSPELAN4's `cv2_csp`, `cv2_conv`, `cv3_csp` and `cv3_conv` are the
reference's `cv2.0`, `cv2.1`, `cv3.0` and `cv3.1` (`ELAN_NAMES`), which a
Detect head's `cv2.0.0` does not match: there a digit follows. A2C2f's
`gamma`, FullPAD_Tunnel's 0-d `gate` and AdaHGComputation's
`prototype_base` are bare parameters under their own names (`PARAM_LEAVES`),
carried as they are; so are the attention modules' `rel_h`, `rel_w` (MHSA),
`cweight`, `cbias`, `sweight`, `sbias` (ShuffleAttention), `pos` and `scale`
(FocusedLinearAttention) and CrissCrossAttention's `gamma`. ImplicitA's and
ImplicitM's `implicit` (YOLOR's implicit knowledge: `ia2_0`, `im3_0` in an
IDetect head, `ia_0`, `im_0` in the implicit AnchorDetect) is also carried
under its name, its flax (1, 1, 1, C) reshaped to the reference's
(1, C, 1, 1) and back (`IMPLICIT`).
GRN's `beta` (with its `gamma`) and UniRepLKNetBlock's layer-scale `gamma`
are bare 1-D parameters too; its dense layers (`se_fc0`, `se_fc1`,
`pwconv1`, `pwconv2`) and HyperComputeModule's `fc` take the generic dense
rule to an `nn.Linear`. DCNv2's and DeformConvDW's kernels are bare `weight`
leaves, flax HWIO (k, k, Cin, Co) and (k, k, 1, C), torch OIHW, with a bare
`bias`: a flax `weight` is always such a kernel; a torch `weight` is one
where its module is named as these modules are (`BARE_WEIGHT`: C2f_DCN's
and C3_DCN's `m_i_cv2`, deformable_LKA's `conv0` and `conv_spatial` under a
`spatial_gating_unit`), every other 4-D `weight` a conv's `kernel`.
FocusedLinearAttention's `scale` is a bare (1, 1, C) parameter, where every
other flax `scale` is a norm's 1-D weight: a `scale` leaf of one dimension
is a norm's `weight`, any other keeps its name both ways. ECAAttention's
1-D conv kernel, flax (k, in, out), is a Conv1d's (out, in, k). The YOLOv13 blocks' other names take the generic rule
(`dwconv`, `pwconv`, `m_0` -> `m.0`, `fuse_conv`, `branch1`, `channel_adjust`,
the AdaHGComputation's dense layers `context_net`, `pre_head_proj`,
`edge_proj`, `node_proj`).

The whole backbones of the 11/ YAMLs (`nn/modules/backbones*.py`,
`efficientformer.py`) keep their flax names, so the generic rule carries
them: `s2_b4` stays, `down_1`, `merge_norm_1`, `out_norm_0` and `s2_attn_0`
are `down.1`, `merge_norm.1`, `out_norm.0` and `s2_attn.0`. Their bare
parameters are carried under their names (Swin's `rel_bias`,
EfficientFormerV2's `attention_biases`, `talking_head{1,2}_{w,b}` and
`layer_scale_{1,2}`; ConvNeXt's layer-scale `gamma`), their `nn.Dense`
kernels are `nn.Linear` weights and their LayerNorm `scale` a `weight`.
Bi_FPN's bare 1-D `weight` is a layer's own `model.N.weight`, where a 4-D
`weight` there is a transposed conv's.

RT-DETR adds two kinds of names:
- flax attention (`ma/query|key|value|out`, kernels (C, nh, hd) and
  (nh, hd, C)) <-> `nn.MultiheadAttention`'s `in_proj_weight` (3C, C) and
  `in_proj_bias` (q, k, v rows in that order) and `out_proj`;
- the decoder head's own names, from the explicit table `HEAD_NAMES`.

Arrays are numpy on the JAX side. Load the result with
`model.load_state_dict(sd)`, which is strict: a key missing or left over
raises.
"""

from __future__ import annotations

import re
from typing import Dict, Tuple

import numpy as np
import torch

# (flax module path, torch module name) of the RT-DETR decoder head's modules
# whose names differ; "{i}" stands for an index.
HEAD_NAMES = (
    ("decoder_layer_{i}", "decoder.layers.{i}"),
    ("input_proj_{i}/conv", "input_proj.{i}.0"),
    ("input_proj_{i}/bn", "input_proj.{i}.1"),
    ("enc_output_norm", "enc_output.1"),
    ("enc_output", "enc_output.0"),
)
BARE_PARAMS = ("denoising_class_embed",)  # flax `self.param` leaves: a module's one `weight`
# flax `self.param` leaves kept under their name: A2C2f's `model.N.gamma`,
# FullPAD_Tunnel's 0-d `model.N.gate`, AdaHGComputation's `prototype_base` (ne, C),
# and the attention modules' (nn/modules/attention.py); so is a `scale` of more
# than one dimension (FocusedLinearAttention's)
PARAM_LEAVES = ("gamma", "gate", "prototype_base", "rel_h", "rel_w", "cweight", "cbias", "sweight", "sbias", "pos",
                "beta", "rel_bias", "attention_biases", "talking_head1_w", "talking_head1_b", "talking_head2_w",
                "talking_head2_b", "layer_scale_1", "layer_scale_2")
BARE_KERNEL = "weight"  # DCNv2's and DeformConvDW's flax leaf: an HWIO kernel; Bi_FPN's 1-D one is not
# the torch modules whose `weight` is that bare kernel (DCNv2, DeformConvDW)
BARE_WEIGHT = re.compile(r"(?:^|\.)(?:m_\d+_cv2|spatial_gating_unit\.(?:conv0|conv_spatial))$")
IMPLICIT = "implicit"  # ImplicitA/ImplicitM's leaf: flax (1, 1, 1, C), torch (1, C, 1, 1)
# RepNCSPELAN4's children (flax name, torch name); torch -> flax only where a
# non-digit token follows, so that a Detect head's `cv2.0.0` keeps its name
ELAN_NAMES = (("cv2_csp", "cv2.0"), ("cv2_conv", "cv2.1"), ("cv3_csp", "cv3.0"), ("cv3_conv", "cv3.1"))
TRANSPOSED = "conv_transpose"  # the flax module of a bare `nn.ConvTranspose2d` layer
MHA_PARTS = ("query", "key", "value")  # the rows of in_proj_weight, in order


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _flatten(v, (*prefix, str(k)))
        else:
            yield (*prefix, str(k)), v


def _rename(name: str, sep: str, src: str, dst: str) -> str:
    """Replace the whole-token occurrence of template src in name (tokens
    split by sep) by template dst."""
    pat = re.escape(src).replace(re.escape("{i}"), r"(\d+)")
    return re.sub(rf"(?<![^{re.escape(sep)}]){pat}(?![^{re.escape(sep)}])",
                  lambda m: dst.format(i=m.group(1) if m.groups() else ""), name)


def _flax_path_to_torch(path) -> str:
    """('layers_28', 'dec_bbox_head_0', 'layers_0') -> 'model.28.dec_bbox_head.0.layers.0'."""
    if len(path) == 2 and path[1] == TRANSPOSED and path[0].startswith("layers_"):
        path = path[:1]
    joined = "/".join(path)
    for flax_name, torch_name in (*HEAD_NAMES, *ELAN_NAMES):
        joined = _rename(joined, "/", flax_name, torch_name)
    out = []
    for pos, tok in enumerate(joined.split("/")):
        if "." in tok:  # renamed by HEAD_NAMES
            out.append(tok)
            continue
        parts = tok.split("_")
        cut = len(parts)
        while cut > 1 and parts[cut - 1].isdigit():
            cut -= 1
        head = "_".join(parts[:cut])
        out.append("model" if pos == 0 and head == "layers" and cut == 1 and len(parts) > 1 else head)
        out.extend(parts[cut:])
    return ".".join(out)


def _torch_name_to_flax(name: str) -> Tuple[str, ...]:
    """'model.28.decoder.layers.3.cross_attn' -> ('layers_28', 'decoder_layer_3', 'cross_attn')."""
    parts = name.split(".")
    if parts[0] == "model":
        parts = parts[1:]
    path = []
    if parts and parts[0].isdigit():
        path.append(f"layers_{parts[0]}")
        parts = parts[1:]
        if parts and parts[0].isdigit():  # a layer stacked n times: the JAX `Repeat` names its copies '0', '1', ...
            path.append(parts[0])
            parts = parts[1:]
    joined = ".".join(parts)
    for flax_name, torch_name in HEAD_NAMES:
        joined = _rename(joined, ".", torch_name, flax_name)
    for flax_name, torch_name in ELAN_NAMES:
        joined = re.sub(rf"(?<![^.]){re.escape(torch_name)}(?=\.[^\d.])", flax_name, joined)
    for p in joined.split(".") if joined else []:
        if p.isdigit() and path:
            path[-1] = f"{path[-1]}_{p}"
        else:
            path.extend(p.split("/"))
    return tuple(path)


def torch_key_to_flax(key: str, ndim: int) -> Tuple[Tuple[str, ...], str, str]:
    """A torch state_dict key of an array with ndim dims -> (flax path, leaf
    name, collection). A 1-D `weight` is a norm's `scale`. Attention's packed
    `in_proj_*` keys have no single flax leaf; see torch_state_dict_to_jax."""
    name, _, leaf = key.rpartition(".")  # a bare module's own parameter has no module name
    path = _torch_name_to_flax(name)
    if path and path[-1] == "out_proj":
        path = (*path[:-1], "out")
    if path and path[-1] in BARE_PARAMS:
        return path[:-1], path[-1], "params"
    if leaf == "weight" and ndim == 4 and BARE_WEIGHT.search(name):
        return path, BARE_KERNEL, "params"
    if len(path) == 1 and path[0].startswith("layers_") and leaf == "weight" and ndim == 1:
        return path, BARE_KERNEL, "params"  # Bi_FPN's fusion weights
    if len(path) == 1 and path[0].startswith("layers_") and leaf in ("weight", "bias"):
        path = (*path, TRANSPOSED)  # a bare layer with a weight: nn.ConvTranspose2d
    if leaf == "weight":
        return path, "scale" if ndim == 1 else "kernel", "params"
    if leaf == "running_mean":
        return path, "mean", "batch_stats"
    if leaf == "running_var":
        return path, "var", "batch_stats"
    return path, leaf, "params"


def _to_torch_array(w: np.ndarray, leaf: str, attention_part: str = "") -> np.ndarray:
    if attention_part == "out" and leaf == "kernel":
        return w.reshape(-1, w.shape[-1]).T  # (nh, hd, C) -> out_proj.weight (C, nh*hd)
    if attention_part and leaf == "kernel":
        return w.reshape(w.shape[0], -1).T  # (C, nh, hd) -> (nh*hd, C) rows of in_proj_weight
    if attention_part in MHA_PARTS:
        return w.reshape(-1)  # bias (nh, hd) -> rows of in_proj_bias
    if leaf == "kernel" and w.ndim == 4:
        return w.transpose(3, 2, 0, 1)  # HWIO -> OIHW; a transposed conv's (kh, kw, out, in) -> (in, out, kh, kw)
    if leaf == "kernel" and w.ndim in (2, 3):
        return w.transpose(*range(w.ndim - 1, -1, -1))  # dense (in, out); a 1-D conv's (k, in, out)
    return w


def jax_to_torch_state_dict(variables: dict, reg_max: int = 16) -> Dict[str, torch.Tensor]:
    """The JAX package's {'params', 'batch_stats'} trees (numpy leaves) as the
    port's state_dict. Buffers that JAX has no counterpart for are filled in:
    `num_batches_tracked` (0) beside every BatchNorm and the Detect head's
    frozen `dfl.conv.weight` (arange(reg_max))."""
    leaf_names = {"params": {"kernel": "weight", "scale": "weight", "bias": "bias"},
                  "batch_stats": {"mean": "running_mean", "var": "running_var"}}
    params = list(_flatten(variables.get("params", {})))
    # flax attention modules: those whose `query` kernel is (C, nh, hd)
    attention = {path[:-2] for path, w in params
                 if path[-2:] == ("query", "kernel") and np.ndim(w) == 3}
    sd: Dict[str, torch.Tensor] = {}
    packed: Dict[str, Dict[str, np.ndarray]] = {}  # in_proj_* key -> {query|key|value: rows}
    for coll, leaves in (("params", params), ("batch_stats", _flatten(variables.get("batch_stats", {})))):
        for path, w in leaves:
            *mods, leaf = path
            arr = np.asarray(w, dtype=np.float32)
            if coll == "params" and leaf in BARE_PARAMS:
                sd[f"{_flax_path_to_torch((*mods, leaf))}.weight"] = torch.from_numpy(arr.copy())
                continue
            if coll == "params" and leaf == IMPLICIT:
                arr = arr.reshape(1, -1, 1, 1)
            if coll == "params" and leaf == BARE_KERNEL and arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
            if coll == "params" and (leaf in (*PARAM_LEAVES, IMPLICIT, BARE_KERNEL)
                                     or leaf == "scale" and arr.ndim != 1):
                sd[".".join(filter(None, (_flax_path_to_torch(mods), leaf)))] = torch.from_numpy(arr.copy())
                continue
            if leaf not in leaf_names[coll]:
                raise KeyError(f"unknown {coll} leaf {'/'.join(path)}")
            part = mods[-1] if coll == "params" and tuple(mods[:-1]) in attention else ""
            arr = _to_torch_array(arr, leaf, part)
            if part in MHA_PARTS:
                key = f"{_flax_path_to_torch(mods[:-1])}.in_proj_{leaf_names[coll][leaf]}"
                packed.setdefault(key, {})[part] = arr
                continue
            if part == "out":
                mods = [*mods[:-1], "out_proj"]
            key = ".".join(filter(None, (_flax_path_to_torch(mods), leaf_names[coll][leaf])))  # a bare module's own
            sd[key] = torch.from_numpy(np.ascontiguousarray(arr))
            if coll == "batch_stats" and leaf == "mean":
                sd[key.rsplit(".", 1)[0] + ".num_batches_tracked"] = torch.tensor(0)
    for key, parts in packed.items():
        if set(parts) != set(MHA_PARTS):
            raise KeyError(f"attention {key} has parts {sorted(parts)}, wants {list(MHA_PARTS)}")
        sd[key] = torch.from_numpy(np.ascontiguousarray(np.concatenate([parts[p] for p in MHA_PARTS])))
    heads = {k[:k.index("cv2.0.2.")] for k in sd if k.startswith("cv2.0.2.") or ".cv2.0.2." in k}
    for prefix in heads:  # '' for a bare Detect module, 'model.22.' inside a model
        sd[f"{prefix}dfl.conv.weight"] = torch.arange(reg_max, dtype=torch.float32).view(1, reg_max, 1, 1)
    return sd


def _put(tree: dict, path, leaf: str, arr: np.ndarray) -> None:
    for p in path:
        tree = tree.setdefault(p, {})
    tree[leaf] = arr


def torch_state_dict_to_jax(state_dict: Dict[str, torch.Tensor], num_heads: int = 8) -> dict:
    """The port's state_dict as the JAX package's {'params', 'batch_stats'}
    trees of numpy arrays, copies that later training does not change (the
    buffers JAX has no counterpart for drop).
    `num_heads` splits attention projections into flax's (C, nh, hd) form."""
    out: dict = {"params": {}, "batch_stats": {}}
    for key, t in state_dict.items():
        if key.endswith("num_batches_tracked") or key.endswith("dfl.conv.weight"):
            continue
        w = t.detach().cpu().numpy().copy()  # on the CPU .numpy() would alias the model's tensor
        name, _, leaf = key.rpartition(".")
        if leaf in ("in_proj_weight", "in_proj_bias"):
            path = _torch_name_to_flax(name)
            for part, rows in zip(MHA_PARTS, np.split(w, 3)):
                if leaf == "in_proj_weight":  # (nh*hd, C) -> (C, nh, hd)
                    _put(out["params"], (*path, part), "kernel", rows.T.reshape(rows.shape[1], num_heads, -1))
                else:
                    _put(out["params"], (*path, part), "bias", rows.reshape(num_heads, -1))
            continue
        path, fleaf, coll = torch_key_to_flax(key, w.ndim)
        if fleaf == "kernel" and path[-1] == "out" and name.endswith(".out_proj"):
            w = w.T.reshape(num_heads, -1, w.shape[0])  # (C, nh*hd) -> (nh, hd, C)
        elif fleaf in ("kernel", BARE_KERNEL) and w.ndim == 4:
            w = w.transpose(2, 3, 1, 0)  # OIHW -> HWIO
        elif fleaf == "kernel" and w.ndim in (2, 3):
            w = w.transpose(*range(w.ndim - 1, -1, -1))
        elif fleaf == IMPLICIT:
            w = w.reshape(1, 1, 1, -1)
        _put(out[coll], path, fleaf, w)
    return out


def load_torch_state_dict_file(path) -> Dict[str, torch.Tensor]:
    """The `sd::`-prefixed state_dict stored in an .npz fixture, as tensors."""
    with np.load(path) as data:
        return {k[4:]: torch.from_numpy(np.array(data[k])) for k in data.files if k.startswith("sd::")}

