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

For training, the kernel has a backward (`upt_msda_sample_fused_backward` in
the same source): `msda_sample_fused` on CUDA tensors is a
`torch.autograd.Function` that saves value, locs and attn, and its backward
launches that kernel, which computes exactly the gradients that autograd
takes through the plain version (`msda_sample_fused_backward_plain`). On CPU
tensors the plain version's own autograd is the backward.
`backward_launches` counts the backward kernel's launches. The JAX package
has no backward kernel; it differentiates its XLA gather.
"""

from __future__ import annotations

import ctypes

import torch

from ultralytics_pro_tpu_torch.kernels.build import check, load_library

launches = 0
backward_launches = 0


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
    S) f32. A row outside [0, V) adds 0. Returns (B, nh, Q, hd) in the
    inputs' type (f32 on every path of the port; f64 inputs give f64, for
    checks against a float64 reference).
    """
    b, nh, v, hd = val.shape
    q, s = idx.shape[2], idx.shape[3]
    ok = (idx >= 0) & (idx < v)
    rows = torch.where(ok, idx, 0).long().reshape(b, nh, q * s, 1).expand(-1, -1, -1, hd)
    g = torch.gather(val, 2, rows).reshape(b, nh, q, s, hd)
    g = torch.where(ok[..., None], g, 0.0)
    return (g * w[..., None]).sum(3)


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


def msda_sample_fused_backward_plain(value: torch.Tensor, shapes, locs: torch.Tensor, attn: torch.Tensor,
                                     grad_out: torch.Tensor):
    """The gradients of `msda_sample_fused_plain`'s output for grad_out (B, Q,
    nh*hd), by autograd: (grad_value, grad_locs, grad_attn), shaped as value,
    locs and attn."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (value, locs, attn)]
        out = msda_sample_fused_plain(leaves[0], shapes, leaves[1], leaves[2])
        return torch.autograd.grad(out, leaves, grad_out)


MAX_LEVELS = 8  # csrc/msda_sample.cu kMaxLevels


def _checked(value: torch.Tensor, shapes, locs: torch.Tensor, attn: torch.Tensor, what: str):
    """Raise on what the kernels do not take; returns shapes as int pairs."""
    tensors = (value, locs, attn)
    if value.device.type != "cuda" or any(t.device != value.device for t in tensors):
        raise ValueError(f"{what}: value on {value.device}, locs on {locs.device}, "
                         f"attn on {attn.device}; all must be on one CUDA device (or all on the CPU)")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"{what} takes float32 value, locs and attn; got {value.dtype}, "
                        f"{locs.dtype}, {attn.dtype}")
    shapes = [(int(h), int(w)) for h, w in shapes]
    if value.ndim != 4 or locs.ndim != 6 or locs.shape[-1] != 2 \
            or tuple(attn.shape) != tuple(locs.shape[:5]) or locs.shape[0] != value.shape[0] \
            or locs.shape[2] != value.shape[2] or locs.shape[3] != len(shapes) \
            or value.shape[1] != sum(h * w for h, w in shapes):
        raise ValueError(f"{what} wants value (B, V, nh, hd) with V the levels' total "
                         f"area, locs (B, Q, nh, L, P, 2), attn (B, Q, nh, L, P) and L level "
                         f"shapes; got {tuple(value.shape)}, {tuple(locs.shape)}, "
                         f"{tuple(attn.shape)} and {shapes}")
    if not 1 <= len(shapes) <= MAX_LEVELS:
        raise ValueError(f"{what} takes 1 to {MAX_LEVELS} levels, got {len(shapes)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what} takes contiguous tensors")
    return shapes


def _launch_forward(value: torch.Tensor, shapes, locs: torch.Tensor, attn: torch.Tensor) -> torch.Tensor:
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


def _launch_backward(value: torch.Tensor, shapes, locs: torch.Tensor, attn: torch.Tensor,
                     grad_out: torch.Tensor):
    b, v, nh, hd = value.shape
    q, nl, npl = locs.shape[1], locs.shape[3], locs.shape[4]
    if tuple(grad_out.shape) != (b, q, nh * hd) or grad_out.dtype != torch.float32 \
            or grad_out.device != value.device:
        raise ValueError(f"msda_sample_fused_backward wants grad_out ({b}, {q}, {nh * hd}) float32 on "
                         f"{value.device}; got {tuple(grad_out.shape)} {grad_out.dtype} on {grad_out.device}")
    grad_out = grad_out.contiguous()
    grad_value = torch.zeros_like(value)  # the kernel adds into it
    grad_locs, grad_attn = torch.empty_like(locs), torch.empty_like(attn)
    if grad_out.numel() == 0:
        return grad_value, grad_locs.zero_(), grad_attn.zero_()
    level_hw = (ctypes.c_int * (2 * nl))(*(x for hw in shapes for x in hw))
    lib = load_library()
    with torch.cuda.device(value.device):
        stream = torch.cuda.current_stream(value.device).cuda_stream
        check(lib.upt_msda_sample_fused_backward(value.data_ptr(), locs.data_ptr(), attn.data_ptr(),
                                                 grad_out.data_ptr(), grad_value.data_ptr(),
                                                 grad_locs.data_ptr(), grad_attn.data_ptr(), b, q, nh, hd,
                                                 v, nl, npl, level_hw, stream),
              "msda_sample_fused_backward kernel launch")
    global backward_launches
    backward_launches += 1
    return grad_value, grad_locs, grad_attn


class _MSDASampleFused(torch.autograd.Function):
    """The forward kernel, with the backward kernel as its gradient."""

    @staticmethod
    def forward(ctx, value, locs, attn, shapes):
        ctx.shapes = shapes
        ctx.save_for_backward(value, locs, attn)
        return _launch_forward(value, shapes, locs, attn)

    @staticmethod
    def backward(ctx, grad_out):
        value, locs, attn = ctx.saved_tensors
        return (*_launch_backward(value, ctx.shapes, locs, attn, grad_out), None)


def msda_sample_fused(value: torch.Tensor, shapes, locs: torch.Tensor,
                      attn: torch.Tensor) -> torch.Tensor:
    """Multiscale deformable sampling: the CUDA kernel for CUDA tensors, with
    the backward kernel as its gradient, the plain version for CPU ones. Same
    contract as `msda_sample_fused_plain`."""
    if all(t.device.type == "cpu" for t in (value, locs, attn)):
        return msda_sample_fused_plain(value, shapes, locs, attn)
    shapes = _checked(value, shapes, locs, attn, "msda_sample_fused")
    return _MSDASampleFused.apply(value, locs, attn, shapes)

