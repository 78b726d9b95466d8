"""K2: multiscale deformable-attention sampling — CUDA kernel wrapper, and its
plain version: the coordinate math and the gather-accumulate it fuses.

Replaces `ultralytics_pro_tpu/kernels/msda_pallas.py:msda_sample_pallas` and
the `msda_flatten_coords` that feeds it there. The kernel
(`csrc/msda_sample.cu`) runs one warp per (batch, query, head): lanes first
compute the bilinear corners of the sampling points in registers, then read
each corner's value row directly from the (B, V, nh, hd) table, with several
points' gathers in flight, and write (B, Q, nh*hd). No corner tensors, no
transpose copies: one launch per decoder layer. It is bound by bytes (the
value rows it gathers, locs, attn and out); the note in the source says more.

`msda_sample_fused` takes CPU tensors to `msda_sample_fused_plain`, which is
`msda_flatten_coords` followed by `msda_sample_plain` (each held to its JAX
counterpart by the CPU tests), and launches the kernel for CUDA tensors or
raises; there is no fallback. `launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from ultralytics_pro_tpu_torch.kernels.build import check, load_library

launches = 0


def msda_flatten_coords(shapes, locs: torch.Tensor, attn: torch.Tensor):
    """Sampling locations in [0, 1] -> flat corner rows and combined weights
    over the level-concatenated value table.

    shapes: [(H_l, W_l)]; locs (B, Q, nh, L, P, 2); attn (B, Q, nh, L, P).
    Corners follow grid_sample with align_corners=False (pixel x = x*W - 0.5);
    an out-of-bounds corner keeps its clipped row and gets weight 0.
    Returns idx (B, nh, Q, L*P*4) int32 and w (B, nh, Q, L*P*4) f32.
    """
    b, q, nh, nl, p, _ = locs.shape
    idx_all, w_all = [], []
    base = 0
    for lvl, (hl, wl) in enumerate(shapes):
        xy = locs[:, :, :, lvl]  # (B, Q, nh, P, 2)
        x = xy[..., 0] * wl - 0.5
        y = xy[..., 1] * hl - 0.5
        x0 = torch.floor(x)
        y0 = torch.floor(y)
        dx = x - x0
        dy = y - y0
        a = attn[:, :, :, lvl]  # (B, Q, nh, P)
        for cx, cy, cw in ((x0, y0, (1 - dx) * (1 - dy)), (x0 + 1, y0, dx * (1 - dy)),
                           (x0, y0 + 1, (1 - dx) * dy), (x0 + 1, y0 + 1, dx * dy)):
            ib = (cx >= 0) & (cx <= wl - 1) & (cy >= 0) & (cy <= hl - 1)
            flat = (cy.clamp(0, hl - 1).to(torch.int32) * wl
                    + cx.clamp(0, wl - 1).to(torch.int32)) + base
            idx_all.append(flat)
            w_all.append(cw * a * ib)
        base += hl * wl
    idx = torch.stack(idx_all, -1).reshape(b, q, nh, nl * p * 4).transpose(1, 2)
    w = torch.stack(w_all, -1).reshape(b, q, nh, nl * p * 4).transpose(1, 2)
    return idx.contiguous(), w.contiguous()


def msda_sample_plain(val: torch.Tensor, idx: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch gather-accumulate, the counterpart of
    `msda_pallas.py:msda_gather_xla`.

    val (B, nh, V, hd) f32; idx (B, nh, Q, S) int32 rows into V; w (B, nh, Q,
    S) f32. A row outside [0, V) adds 0. Returns (B, nh, Q, hd) f32.
    """
    b, nh, v, hd = val.shape
    q, s = idx.shape[2], idx.shape[3]
    ok = (idx >= 0) & (idx < v)
    rows = torch.where(ok, idx, 0).long().reshape(b, nh, q * s, 1).expand(-1, -1, -1, hd)
    g = torch.gather(val, 2, rows).reshape(b, nh, q, s, hd)
    g = torch.where(ok[..., None], g, 0.0)
    return (g * w[..., None]).sum(3).to(torch.float32)


def msda_sample_fused_plain(value: torch.Tensor, shapes, locs: torch.Tensor,
                            attn: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch multiscale deformable sampling: `msda_flatten_coords`,
    then `msda_sample_plain` over the table as (B, nh, V, hd).

    value (B, V, nh, hd) f32, the level-concatenated table; shapes [(H_l, W_l)];
    locs (B, Q, nh, L, P, 2) in [0, 1]; attn (B, Q, nh, L, P). Returns
    (B, Q, nh*hd) f32.
    """
    b, q = locs.shape[:2]
    idx, w = msda_flatten_coords(shapes, locs, attn)
    out = msda_sample_plain(value.transpose(1, 2), idx, w)  # (B, nh, Q, hd)
    return out.transpose(1, 2).reshape(b, q, -1)


MAX_LEVELS = 8  # csrc/msda_sample.cu kMaxLevels


def msda_sample_fused(value: torch.Tensor, shapes, locs: torch.Tensor,
                      attn: torch.Tensor) -> torch.Tensor:
    """Multiscale deformable sampling: the CUDA kernel for CUDA tensors, the
    plain version for CPU ones. Same contract as `msda_sample_fused_plain`."""
    tensors = (value, locs, attn)
    if all(t.device.type == "cpu" for t in tensors):
        return msda_sample_fused_plain(value, shapes, locs, attn)
    if value.device.type != "cuda" or any(t.device != value.device for t in tensors):
        raise ValueError(f"msda_sample_fused: value on {value.device}, locs on {locs.device}, "
                         f"attn on {attn.device}; all must be on one CUDA device (or all on the CPU)")
    if any(t.requires_grad for t in tensors):
        raise RuntimeError("msda_sample_fused has no backward: the kernel would cut the autograd "
                           "graph; call it under torch.no_grad()")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"msda_sample_fused takes float32 value, locs and attn; got {value.dtype}, "
                        f"{locs.dtype}, {attn.dtype}")
    shapes = [(int(h), int(w)) for h, w in shapes]
    if value.ndim != 4 or locs.ndim != 6 or locs.shape[-1] != 2 \
            or tuple(attn.shape) != tuple(locs.shape[:5]) or locs.shape[0] != value.shape[0] \
            or locs.shape[2] != value.shape[2] or locs.shape[3] != len(shapes) \
            or value.shape[1] != sum(h * w for h, w in shapes):
        raise ValueError(f"msda_sample_fused wants value (B, V, nh, hd) with V the levels' total "
                         f"area, locs (B, Q, nh, L, P, 2), attn (B, Q, nh, L, P) and L level "
                         f"shapes; got {tuple(value.shape)}, {tuple(locs.shape)}, "
                         f"{tuple(attn.shape)} and {shapes}")
    if not 1 <= len(shapes) <= MAX_LEVELS:
        raise ValueError(f"msda_sample_fused takes 1 to {MAX_LEVELS} levels, got {len(shapes)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("msda_sample_fused takes contiguous tensors")
    b, v, nh, hd = value.shape
    q, nl, npl = locs.shape[1], locs.shape[3], locs.shape[4]
    out = torch.empty((b, q, nh * hd), dtype=torch.float32, device=value.device)
    if out.numel() == 0:
        return out
    level_hw = (ctypes.c_int * (2 * nl))(*(x for hw in shapes for x in hw))
    lib = load_library()
    with torch.cuda.device(value.device):
        stream = torch.cuda.current_stream(value.device).cuda_stream
        check(lib.upt_msda_sample_fused(value.data_ptr(), locs.data_ptr(), attn.data_ptr(),
                                        out.data_ptr(), b, q, nh, hd, v, nl, npl, level_hw,
                                        stream), "msda_sample_fused kernel launch")
    global launches
    launches += 1
    return out
