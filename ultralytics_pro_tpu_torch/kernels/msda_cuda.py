"""K2: multiscale deformable-attention gather-accumulate — CUDA kernel wrapper,
its plain version, and the coordinate math that feeds it.

Replaces `ultralytics_pro_tpu/kernels/msda_pallas.py:msda_sample_pallas`.
The kernel (`csrc/msda_sample.cu`) runs one warp per (batch*head, query),
lanes over the head channels, and gathers each corner's value row directly
instead of the TPU kernel's one-hot matmul. It is bound by bytes (the value
rows it gathers, plus idx, w and out); at batch 1 those take about one
launch's time, so the design launches once per decoder layer with no host
sync (the note in the source says more).

`msda_sample` takes CPU tensors to `msda_sample_plain`, and launches the
kernel for CUDA tensors or raises; there is no fallback. `launches` counts
kernel launches. `msda_flatten_coords` is plain PyTorch on either device, as
the JAX package leaves it to XLA (`msda_pallas.py:msda_flatten_coords:83`).
"""

from __future__ import annotations

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


def msda_sample(val: torch.Tensor, idx: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Gather-accumulate: the CUDA kernel for CUDA tensors, the plain version
    for CPU ones. Same contract as `msda_sample_plain`."""
    tensors = (val, idx, w)
    if all(t.device.type == "cpu" for t in tensors):
        return msda_sample_plain(val, idx, w)
    if val.device.type != "cuda" or any(t.device != val.device for t in tensors):
        raise ValueError(f"msda_sample: val on {val.device}, idx on {idx.device}, w on {w.device}; "
                         "all must be on one CUDA device (or all on the CPU)")
    if any(t.requires_grad for t in tensors):
        raise RuntimeError("msda_sample has no backward: the kernel would cut the autograd graph; "
                           "call it under torch.no_grad()")
    if val.dtype != torch.float32 or w.dtype != torch.float32 or idx.dtype != torch.int32:
        raise TypeError(f"msda_sample takes val f32, idx int32, w f32; got {val.dtype}, "
                        f"{idx.dtype}, {w.dtype}")
    if val.ndim != 4 or idx.ndim != 4 or tuple(w.shape) != tuple(idx.shape) \
            or tuple(idx.shape[:2]) != tuple(val.shape[:2]):
        raise ValueError(f"msda_sample wants val (B, nh, V, hd) and idx, w (B, nh, Q, S), got "
                         f"{tuple(val.shape)}, {tuple(idx.shape)}, {tuple(w.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("msda_sample takes contiguous tensors")
    b, nh, v, hd = val.shape
    q, s = idx.shape[2], idx.shape[3]
    out = torch.empty((b, nh, q, hd), dtype=torch.float32, device=val.device)
    if out.numel() == 0:
        return out
    lib = load_library()
    with torch.cuda.device(val.device):
        stream = torch.cuda.current_stream(val.device).cuda_stream
        check(lib.upt_msda_sample(val.data_ptr(), idx.data_ptr(), w.data_ptr(), out.data_ptr(),
                                  b * nh, v, q, s, hd, stream), "msda_sample kernel launch")
    global launches
    launches += 1
    return out
