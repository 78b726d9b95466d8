"""K1: batched exact greedy NMS — CUDA kernel wrapper and its plain version.

Replaces `ultralytics_pro_tpu/kernels/nms_pallas.py:pallas_greedy_nms`. The
kernel (`csrc/greedy_nms.cu`) takes rows sorted by score (descending, ties in
index order), where exact greedy NMS is an in-order scan: one thread block per
row streams the candidates through shared memory in tiles of 64, tests each
tile against the row's keeps so far and resolves the tile's survivors among
themselves through a 64-bit IoU mask, and stops at `max_det` keeps or at the
first score that is not positive. Its bound on the card is that chain of tile
rounds, not bytes or operations (the note in the source says more).

`greedy_nms` takes a CPU tensor to `greedy_nms_plain` (the argmax form, the
reference semantics, which needs no sort), and launches the kernel for a CUDA
tensor or raises; there is no fallback. On the card, rows that are not flagged
`presorted` are sorted by the wrapper, and `keep` is mapped back to the rows'
own indices. `launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from ultralytics_pro_tpu_torch.kernels.build import check, load_library

launches = 0
_max_keep: dict[int, int] = {}  # device index -> largest max_det one block's shared memory holds


def greedy_nms_plain(boxes: torch.Tensor, scores: torch.Tensor, max_det: int = 300,
                     iou_thres: float = 0.45):
    """Plain PyTorch greedy NMS over batch rows; the counterpart of
    `ops/nms.py:_greedy_nms_scores` run on every row.

    boxes (B, K, 4) f32 xyxy (class offset applied), scores (B, K) f32 with
    invalid candidates < 0. Returns (keep (B, max_det) int32, valid (B, max_det) bool).
    """
    b, k, _ = boxes.shape
    dev = boxes.device
    x1, y1, x2, y2 = boxes.unbind(-1)
    areas = (x2 - x1) * (y2 - y1)
    thres = torch.tensor(iou_thres, dtype=torch.float32, device=dev)
    eps = torch.tensor(1e-7, dtype=torch.float32, device=dev)
    s = scores.clone()
    keep = torch.zeros((b, max_det), dtype=torch.int32, device=dev)
    valid = torch.zeros((b, max_det), dtype=torch.bool, device=dev)
    rows = torch.arange(b, device=dev)
    i = 0
    while i < max_det:
        j = s.argmax(dim=1)  # first index of the maximum
        sj = s[rows, j]
        active = sj > 0  # rows still holding a positive score
        if not bool(active.any()):
            break
        xx1 = torch.maximum(x1[rows, j][:, None], x1)
        yy1 = torch.maximum(y1[rows, j][:, None], y1)
        xx2 = torch.minimum(x2[rows, j][:, None], x2)
        yy2 = torch.minimum(y2[rows, j][:, None], y2)
        inter = (xx2 - xx1).clamp(min=0) * (yy2 - yy1).clamp(min=0)
        iou = inter / (areas[rows, j][:, None] + areas - inter + eps)
        s = torch.where((iou > thres) & active[:, None], -1.0, s)
        keep[:, i] = torch.where(active, j.to(torch.int32), keep[:, i])
        valid[:, i] = active
        i += 1
    return keep, valid


def _on_sorted_rows(fn, boxes, scores, max_det, iou_thres):
    """fn on each row sorted by score (stable, descending), keep mapped back to
    the row's own indices. The argmax form picks the same boxes in the same
    order on both: equal scores keep their index order in a stable sort."""
    order = torch.sort(scores, dim=1, descending=True, stable=True).indices
    keep, valid = fn(torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4)),
                     torch.gather(scores, 1, order), max_det, iou_thres)
    return torch.where(valid, torch.gather(order, 1, keep.long()), 0).to(torch.int32), valid


def greedy_nms(boxes: torch.Tensor, scores: torch.Tensor, max_det: int = 300,
               iou_thres: float = 0.45, presorted: bool = False):
    """Greedy NMS: the CUDA kernel for CUDA tensors, the plain version for CPU ones.

    Same contract as `greedy_nms_plain`. presorted: each row's scores already
    do not increase along K, with equal scores in index order (a stable
    descending sort, as `ops/nms.py:_topk` gives them); without it the wrapper
    sorts the rows itself on the card (the plain version takes any order).
    """
    if boxes.device.type == "cpu" and scores.device.type == "cpu":
        return greedy_nms_plain(boxes, scores, max_det, iou_thres)
    if boxes.device.type != "cuda" or scores.device != boxes.device:
        raise ValueError(f"greedy_nms: boxes on {boxes.device}, scores on {scores.device}; "
                         "both must be on one CUDA device (or both on the CPU)")
    if boxes.dtype != torch.float32 or scores.dtype != torch.float32:
        raise TypeError(f"greedy_nms takes float32, got {boxes.dtype} and {scores.dtype}")
    if boxes.ndim != 3 or boxes.shape[-1] != 4 or tuple(scores.shape) != tuple(boxes.shape[:2]):
        raise ValueError(f"greedy_nms wants boxes (B, K, 4) and scores (B, K), got "
                         f"{tuple(boxes.shape)} and {tuple(scores.shape)}")
    b, k, _ = boxes.shape
    if k < 1 or max_det < 1:
        raise ValueError(f"greedy_nms needs K >= 1 and max_det >= 1, got K={k}, max_det={max_det}")
    if not presorted:
        return _on_sorted_rows(_launch, boxes, scores, max_det, iou_thres)
    return _launch(boxes, scores, max_det, iou_thres)


def _launch(boxes: torch.Tensor, scores: torch.Tensor, max_det: int, iou_thres: float):
    """The kernel on sorted rows, checked CUDA tensors of one device."""
    if not (boxes.is_contiguous() and scores.is_contiguous()):
        raise ValueError("greedy_nms takes contiguous tensors")
    if boxes.data_ptr() % 16:
        raise ValueError("greedy_nms reads boxes as float4: boxes must be 16-byte aligned")
    b, k, _ = boxes.shape
    lib = load_library()
    with torch.cuda.device(boxes.device):
        dev = torch.cuda.current_device()
        if dev not in _max_keep:
            max_keep = ctypes.c_int(0)
            check(lib.upt_greedy_nms_init(ctypes.byref(max_keep)), "upt_greedy_nms_init")
            _max_keep[dev] = max_keep.value
        if max_det > _max_keep[dev]:
            raise ValueError(f"greedy_nms: max_det={max_det} keeps exceed the {_max_keep[dev]} "
                             "that one block's shared memory holds on this device")
        keep = torch.empty((b, max_det), dtype=torch.int32, device=boxes.device)
        valid = torch.empty((b, max_det), dtype=torch.bool, device=boxes.device)
        if b == 0:
            return keep, valid
        stream = torch.cuda.current_stream(boxes.device).cuda_stream
        check(lib.upt_greedy_nms(boxes.data_ptr(), scores.data_ptr(), keep.data_ptr(),
                                 valid.data_ptr(), b, k, max_det, float(iou_thres), stream),
              "greedy_nms kernel launch")
    global launches
    launches += 1
    return keep, valid
