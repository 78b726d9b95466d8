"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py    # needs one CUDA card

Phases, one JSON line each on stdout (a failed phase raises and the script
exits non-zero):
  env     card name, `nvidia-smi` name and power limit; TF32 off throughout
  build   nvcc builds every kernel of csrc/ (seconds)
  k1      kernel K1 (greedy NMS) against its plain version on the card, bit
          for bit (max_abs_err over keep, valid and the kept boxes), at the
          predict (B=16, K=8400) and val (B=2, K=30000) sizes, with times
          and the bound
  main    YOLO("yolov8s.yaml", device="cuda").predict(4 images) at 640 px,
          with K1's launch count read around the call; warm predict latency
          per image over 200 calls (median and spread), the device's busy
          time and idle share on those calls (one torch.profiler window of
          20 calls against the unprofiled median), and the device
          function's images/s at batch 16
  parity  the same weights on the card and on the CPU: decoded outputs
          within boxes 1e-3 px / scores 1e-4, and NMS on the CPU's decoded
          outputs equal on both devices
  k2      kernel K2 (deformable-attention gather) against its plain version
          on the card within 1e-5, at the rtdetr-l predict shape (B=1), the
          batch-16 device-function shape, and an edge case (hd=8, Q=37,
          out-of-range rows); times, the bound, and the one PyTorch call that
          computes the same function (embedding_bag) as the yardstick
  rtdetr  RTDETR("rtdetr-l.yaml", device="cuda").predict(4 images) at 640 px,
          default conf 0.25, with K2's launches read around the call (6 per
          image); warm predict latency per image over 100 calls, the device
          idle share from one profiled window of 10 calls, and the device
          function's images/s at batch 16
  rtdetr_parity  the same weights and letterboxed batch on the card and on
          the CPU: dense encoder scores within 1e-3, top-k query indices
          that differ (reported), final outputs within 1e-3 over the
          queries whose index agrees
  kernels the per-kernel summary line
The last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

# Peak rates of one H100 SXM (NVIDIA data sheet): HBM bytes/s, f32 (non-tensor) FLOP/s.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
NMS_OPS_PER_CANDIDATE_STEP = 18  # IoU (min/max x4, sub x4, clip x2, mul x2, add/sub x3, div) + compare + argmax
CONF = 1e-6  # random-init class logits sit near log(5/nc/(640/s)^2), i.e. scores ~1e-5
MIN_CANDIDATES = 1000
IMAGE_SHAPES = ((480, 640), (720, 1280), (640, 640), (333, 500))
PREDICT_CALLS = 200  # timed warm predict calls of the 4 images, one at a time
PROFILED_CALLS = 20  # predict calls traced by torch.profiler for the device's busy time
RTDETR_CALLS = 100  # the same for RT-DETR
RTDETR_PROFILED_CALLS = 10
RTDETR_LEVELS = ((80, 80), (40, 40), (20, 20))  # rtdetr-l's P3-P5 at 640 px: V = 8400 value rows
PARITY_TOL = 1e-3  # card vs CPU, rtdetr-l encoder scores and final outputs
# cuDNN's f32 convolutions run as implicit GEMM (fprop) or FFT (fft*,
# pointwise_mult_and_sum_complex, gemv2T on float2); cuBLAS's matmuls as gemm.
CONV_KERNELS = ("conv", "fprop", "implicit_gemm", "winograd", "fft", "pointwise_mult_and_sum",
                "region_transform", "float2")
MATMUL_KERNELS = ("gemm", "gemv", "xmma", "cutlass")


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else \
        f"nvidia-smi failed: {out.stderr.strip()}"


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of fn() over iters calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def seeded_images():
    """The main path's 4 uint8 BGR images, from seed 0."""
    rng = np.random.default_rng(0)
    return [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for h, w in IMAGE_SHAPES]


def category(name: str) -> str:
    """Coarse kernel class (CONV_KERNELS and MATMUL_KERNELS say how)."""
    n = name.lower()
    if "greedy_nms" in n:
        return "k1_greedy_nms"
    if "msda_sample" in n:
        return "k2_msda_sample"
    if any(s in n for s in CONV_KERNELS):
        return "convolution"
    if any(s in n for s in MATMUL_KERNELS):
        return "matmul"
    if "bn_fw" in n or "batch_norm" in n:
        return "batchnorm"
    if "layer_norm" in n:
        return "layernorm"
    if "sort" in n or "radix" in n:
        return "sort"
    if "memcpy" in n:
        return "memcpy"
    return "other_elementwise_reduce"


def profile_window(fn, reps: int) -> dict:
    """Trace reps warm calls of fn with torch.profiler. Device busy ms per call
    is the sum of the kernels' device times (one stream, so they do not
    overlap); the profiler adds host time, so the window's own wall time and
    idle share read high. device_busy_ms_per_call is None if the trace holds
    no device time."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    by_cat, kernels = {}, []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        if dev_us <= 0 or ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        cat = category(ev.key)
        by_cat[cat] = by_cat.get(cat, 0.0) + dev_us / 1e3 / reps
        kernels.append((dev_us / 1e3 / reps, ev.count // reps, ev.key[:90]))
    busy = sum(by_cat.values()) or None
    kernels.sort(reverse=True)
    return {"profiled_calls": reps, "profiled_wall_ms_per_call": wall_ms,
            "device_busy_ms_per_call": busy,
            "profiled_idle_share": None if busy is None else max(0.0, 1 - busy / wall_ms),
            "device_ms_by_category": by_cat,
            "kernel_launches_per_call": sum(k[1] for k in kernels),
            "top_kernels": [{"ms": k[0], "per_call": k[1], "name": k[2]} for k in kernels[:12]]}


def nms_inputs(rng, b: int, k: int, nc: int = 80, max_wh: float = 7680.0):
    """Class-offset xyxy boxes and scores in [0, 1] or -1, with the cases K1
    must get right: an all -1 row, a row that runs out after a few picks, and
    rows of duplicate scores (ties)."""
    c = rng.uniform(0, 640, (b, k, 2))
    wh = rng.uniform(4, 160, (b, k, 2))
    cls = rng.integers(0, nc, (b, k, 1))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], -1) + cls * max_wh
    scores = np.where(rng.uniform(0, 1, (b, k)) < 0.7, rng.uniform(0, 1, (b, k)), -1.0)
    scores[0] = -1.0
    if b > 2:
        scores[1] = -1.0
        scores[1, rng.choice(k, 5, replace=False)] = rng.uniform(0.1, 1, 5)
    scores[b - 1] = np.where(scores[b - 1] > 0, np.ceil(scores[b - 1] * 16) / 16, -1.0)  # ties
    if b > 4:
        scores[2] = np.where(scores[2] > 0, 0.5, -1.0)  # every live score equal
    return boxes.astype(np.float32), scores.astype(np.float32)


def kept_outputs(boxes, keep, valid):
    """keep and valid as floats, and the kept boxes (zero where not valid)."""
    kept = torch.gather(boxes, 1, keep.long()[..., None].expand(-1, -1, 4)) * valid[..., None]
    return keep.double(), valid.double(), kept.double()


def k1_check(nms_cuda, name: str, b: int, k: int, max_det: int, iou: float, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    boxes_np, scores_np = nms_inputs(rng, b, k)
    boxes = torch.from_numpy(boxes_np).cuda()
    scores = torch.from_numpy(scores_np).cuda()
    keep, valid = nms_cuda.greedy_nms(boxes, scores, max_det, iou)
    torch.cuda.synchronize()
    keep_p, valid_p = nms_cuda.greedy_nms_plain(boxes, scores, max_det, iou)
    keep_c, valid_c = nms_cuda.greedy_nms_plain(boxes.cpu(), scores.cpu(), max_det, iou)
    mismatch = int((keep != keep_p).sum() + (valid != valid_p).sum()
                   + (keep.cpu() != keep_c).sum() + (valid.cpu() != valid_c).sum())
    # max |kernel - plain| over keep indices, valid flags and the kept boxes
    # (what a caller gathers), against the plain version on the card and on the CPU
    out = kept_outputs(boxes.cpu(), keep.cpu(), valid.cpu())
    max_abs_err = max(float((a - b).abs().max())
                      for ref_k, ref_v in ((keep_p.cpu(), valid_p.cpu()), (keep_c, valid_c))
                      for a, b in zip(out, kept_outputs(boxes.cpu(), ref_k, ref_v)))
    if mismatch or max_abs_err:
        raise AssertionError(f"K1 {name}: {mismatch} entries differ from the plain version "
                             f"(max abs error {max_abs_err})")
    kept = valid.sum(1).cpu().numpy()
    ms = cuda_ms(lambda: nms_cuda.greedy_nms(boxes, scores, max_det, iou), iters=20)
    plain_ms = cuda_ms(lambda: nms_cuda.greedy_nms_plain(boxes, scores, max_det, iou), iters=3, warmup=1)
    # bound: bytes read/written once, and the operations this data needs (each
    # row runs kept steps over K, plus one final argmax pass if it stops early)
    nbytes = b * k * (16 + 4) + b * max_det * (4 + 1)
    ops = sum(int(s) * k * NMS_OPS_PER_CANDIDATE_STEP + (k if s < max_det else 0) for s in kept)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_FLOPS * 1e3
    return {"size": name, "B": b, "K": k, "max_det": max_det, "iou": iou, "max_mismatch": mismatch,
            "max_abs_err": max_abs_err,
            "kept_per_row": kept.tolist(), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes > t_ops else "operations",
            "bytes": nbytes, "ops": ops}


def main_path(YOLO, nms_cuda, decode_single_label, card: str, smi: str):
    imgs = seeded_images()
    model = YOLO("yolov8s.yaml", device="cuda", seed=0)
    model.predict(imgs[:1], conf=CONF)  # first call: cuDNN and allocator set-up
    torch.cuda.synchronize()

    nms_cuda.launches = 0
    results = model.predict(imgs, conf=CONF)
    torch.cuda.synchronize()
    launches = nms_cuda.launches
    if launches != len(imgs):
        raise AssertionError(f"K1 launched {launches} times for {len(imgs)} images")
    dets = []
    for r, im in zip(results, imgs):
        d = r.boxes.data
        h, w = im.shape[:2]
        if not np.isfinite(d).all():
            raise AssertionError("non-finite detection")
        if len(d) > 300 or len(d) == 0:
            raise AssertionError(f"{len(d)} detections for one image")
        if (d[:, [0, 2]].min() < 0 or d[:, [0, 2]].max() > w or d[:, [1, 3]].min() < 0
                or d[:, [1, 3]].max() > h):
            raise AssertionError("box outside its image")
        dets.append(len(d))

    pred = model.predictor
    head = model.model.model[-1]
    with torch.no_grad():
        batch = pred.preprocess(imgs)
        x = batch.flip(-1).permute(0, 3, 1, 2).float() / 255.0
        _, conf, _ = decode_single_label(model.model(x, decode=False), head.stride.tolist(), head.nc)
    above = (conf > CONF).sum(1).tolist()
    if min(above) < MIN_CANDIDATES:
        raise AssertionError(f"only {above} of {conf.shape[1]} candidates score above conf={CONF}")

    # Warm predict latency: host clock around each call (predict returns host
    # arrays, so each call ends synchronised), per image.
    per_image = []
    for _ in range(PREDICT_CALLS):
        t0 = time.perf_counter()
        model.predict(imgs, conf=CONF)
        per_image.append((time.perf_counter() - t0) * 1e3 / len(imgs))
    q = np.percentile(per_image, [0, 10, 50, 90, 100])
    # The device's busy time on the same calls, from one profiled window of this
    # run; the idle share sets it against the unprofiled median wall time.
    prof = profile_window(lambda: model.predict(imgs, conf=CONF), PROFILED_CALLS)
    call_ms = q[2] * len(imgs)
    busy = prof["device_busy_ms_per_call"]

    batch16 = batch.repeat(4, 1, 1, 1)
    ms16 = cuda_ms(lambda: pred.run(batch16), iters=10)
    info = dict(model="yolov8s", imgsz=640, images=[list(s) for s in IMAGE_SHAPES], conf=CONF,
                k1_launches=launches, detections=dets, candidates_above_conf=above,
                candidates=int(conf.shape[1]), predict_calls=PREDICT_CALLS,
                predict_ms_per_image={"median": q[2], "p10": q[1], "p90": q[3], "min": q[0], "max": q[4]},
                predict_median_ms_per_call=call_ms,
                device_idle_share=None if busy is None else max(0.0, 1 - busy / call_ms),
                predict_profile=prof,
                device_fn_batch16_ms=ms16, device_fn_batch16_images_per_s=16 * 1e3 / ms16,
                card=card, nvidia_smi=smi)
    return model, batch, info


def parity(YOLO, nms_cuda, ops_nms, decode_single_label, model, batch):
    cpu_model = YOLO("yolov8s.yaml", device="cpu", seed=0)
    for (k, a), b in zip(model.model.state_dict().items(), cpu_model.model.state_dict().values()):
        if not torch.equal(a.cpu(), b):
            raise AssertionError(f"seeded weights differ between devices at {k}")
    x = batch[:1].cpu().flip(-1).permute(0, 3, 1, 2).float() / 255.0
    with torch.no_grad():
        y_gpu, _ = model.model(x.cuda())
        y_cpu, raw_cpu = cpu_model.model(x)
    y_gpu = y_gpu.cpu()
    box_err = float((y_gpu[..., :4] - y_cpu[..., :4]).abs().max())
    score_err = float((y_gpu[..., 4:] - y_cpu[..., 4:]).abs().max())
    if not (box_err <= 1e-3 and score_err <= 1e-4):
        raise AssertionError(f"card vs CPU decoded output: boxes {box_err} px, scores {score_err}")

    head = cpu_model.model.model[-1]
    b4, cf, cl = decode_single_label(raw_cpu, head.stride.tolist(), head.nc)
    kw = dict(conf_thres=CONF, iou_thres=0.7, max_det=300)
    out_cpu = ops_nms.non_max_suppression_fused(b4, cf, cl, **kw)
    out_gpu = ops_nms.non_max_suppression_fused(b4.cuda(), cf.cuda(), cl.cuda(), **kw)
    nms_diff = sum(int((out_gpu[k].cpu() != out_cpu[k]).sum()) for k in out_cpu)
    # K1 itself on the CPU's candidates: keep indices equal to the plain version's
    masked = torch.where(cf > CONF, cf, -1.0)
    top, idx = ops_nms._topk(masked, cf.shape[1])
    cand = ops_nms.xywh2xyxy(torch.gather(b4, 1, idx[..., None].expand(-1, -1, 4)))
    cand = (cand + torch.gather(cl, 1, idx).float()[..., None] * 7680.0).contiguous()
    keep_c, valid_c = nms_cuda.greedy_nms_plain(cand, top, 300, 0.7)
    keep_g, valid_g = nms_cuda.greedy_nms(cand.cuda(), top.cuda(), 300, 0.7)
    keep_diff = int((keep_g.cpu() != keep_c).sum() + (valid_g.cpu() != valid_c).sum())
    if nms_diff or keep_diff:
        raise AssertionError(f"NMS on the card differs from the CPU: {nms_diff} output entries, "
                             f"{keep_diff} keep entries")
    return dict(decoded_shape=list(y_cpu.shape), max_abs_box_err_px=box_err,
                max_abs_score_err=score_err, tolerance={"boxes_px": 1e-3, "scores": 1e-4},
                nms_output_mismatch=nms_diff, k1_keep_mismatch=keep_diff, kept=int(valid_c.sum()))


def k2_inputs(rng, b: int, q: int, nh: int, hd: int, shapes, p: int = 4, out_of_range: bool = False):
    """A value table (B, nh, V, hd) and the flat corner rows and weights that
    msda_flatten_coords makes of random locations in [-0.1, 1.1] (so corners
    fall outside the maps) and softmax-like attention, all on the card. With
    out_of_range, a fifth of the rows move outside [0, V) and every weight
    is positive, so a row the kernel failed to skip would show."""
    from ultralytics_pro_tpu_torch.kernels.msda_cuda import msda_flatten_coords

    v = sum(h * w for h, w in shapes)
    val = torch.from_numpy(rng.normal(size=(b, nh, v, hd)).astype(np.float32)).cuda()
    locs = torch.from_numpy(rng.uniform(-0.1, 1.1, (b, q, nh, len(shapes), p, 2)).astype(np.float32)).cuda()
    attn = rng.uniform(0, 1, (b, q, nh, len(shapes), p)).astype(np.float32)
    attn = torch.from_numpy(attn / attn.sum((-1, -2), keepdims=True)).cuda()
    idx, w = msda_flatten_coords(list(shapes), locs, attn)
    if out_of_range:
        mask = torch.from_numpy(rng.uniform(size=tuple(idx.shape)) < 0.2).cuda()
        bad = torch.from_numpy(rng.choice([-1, -7, v, v + 5, 2 ** 30], size=tuple(idx.shape))
                               .astype(np.int32)).cuda()
        idx, w = torch.where(mask, bad, idx).contiguous(), (w + 0.1).contiguous()
    return val, idx, w


def k2_check(msda_cuda, name: str, b: int, q: int, nh: int, hd: int, shapes, seed: int,
             out_of_range: bool = False) -> dict:
    val, idx, w = k2_inputs(np.random.default_rng(seed), b, q, nh, hd, shapes, out_of_range=out_of_range)
    out = msda_cuda.msda_sample(val, idx, w)
    torch.cuda.synchronize()
    ref = msda_cuda.msda_sample_plain(val, idx, w)
    ref_cpu = msda_cuda.msda_sample_plain(val.cpu(), idx.cpu(), w.cpu())
    max_abs_err = max(float((out - ref).abs().max()), float((out.cpu() - ref_cpu).abs().max()))
    if not (bool(torch.isfinite(out).all()) and max_abs_err <= 1e-5):
        raise AssertionError(f"K2 {name}: max abs error {max_abs_err} against the plain version")
    ms = cuda_ms(lambda: msda_cuda.msda_sample(val, idx, w), iters=50)
    plain_ms = cuda_ms(lambda: msda_cuda.msda_sample_plain(val, idx, w), iters=10)
    # bound: the distinct in-range value rows this run's indices touch, idx, w
    # and out once each, at the HBM rate; 2*hd operations per in-range corner
    v = val.shape[2]
    ok = (idx >= 0) & (idx < v)
    bh_base = (torch.arange(b * nh, device=idx.device, dtype=torch.int64) * v).view(b, nh, 1, 1)
    rows = int(torch.unique((idx.long() + bh_base)[ok]).numel())
    nbytes = rows * hd * 4 + idx.numel() * 4 + w.numel() * 4 + out.numel() * 4
    ops = 2 * hd * int(ok.sum())
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_FLOPS * 1e3
    info = {"size": name, "B": b, "nh": nh, "V": v, "hd": hd, "Q": q, "S": idx.shape[-1],
            "out_of_range_rows": int((~ok).sum()), "max_abs_err": max_abs_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes > t_ops else "operations", "bytes": nbytes,
            "distinct_value_rows": rows, "ops": ops, "library_ms": None, "library_max_abs_err": None}
    if not out_of_range:
        # the yardstick: one PyTorch call computing the same weighted row sums
        # (the port never calls it); it takes in-range rows only
        flat_val = val.reshape(-1, hd)
        bags = (idx.long() + bh_base).reshape(-1, idx.shape[-1])
        bag_w = w.reshape(-1, idx.shape[-1])

        def library():
            return torch.nn.functional.embedding_bag(bags, flat_val, per_sample_weights=bag_w, mode="sum")

        info["library_max_abs_err"] = float((library().view_as(out) - out).abs().max())
        info["library_ms"] = cuda_ms(library, iters=50)
    return info


def rtdetr_path(RTDETR, msda_cuda, nms_cuda, card: str, smi: str):
    imgs = seeded_images()
    model = RTDETR("rtdetr-l.yaml", device="cuda", seed=0)
    n_params = sum(p.numel() for p in model.model.parameters())
    model.predict(imgs[:1])  # first call: cuDNN, cuBLAS and allocator set-up
    torch.cuda.synchronize()

    msda_cuda.launches = 0
    nms_cuda.launches = 0
    results = model.predict(imgs)
    torch.cuda.synchronize()
    launches, k1_launches = msda_cuda.launches, nms_cuda.launches
    if launches != 6 * len(imgs):
        raise AssertionError(f"K2 launched {launches} times for {len(imgs)} images (6 decoder layers each)")
    kept = [len(r) for r in results]
    for r in results:
        if not np.isfinite(r.boxes.data).all() or len(r) > 300:
            raise AssertionError(f"{len(r)} detections, finite: {np.isfinite(r.boxes.data).all()}")
    if not any(kept):
        raise AssertionError("no image kept a box at conf 0.25")

    per_image = []
    for _ in range(RTDETR_CALLS):
        t0 = time.perf_counter()
        model.predict(imgs)
        per_image.append((time.perf_counter() - t0) * 1e3 / len(imgs))
    q = np.percentile(per_image, [0, 10, 50, 90, 100])
    prof = profile_window(lambda: model.predict(imgs), RTDETR_PROFILED_CALLS)
    call_ms = q[2] * len(imgs)
    busy = prof["device_busy_ms_per_call"]

    pred = model.predictor
    batch = pred.preprocess(imgs)
    batch16 = batch.repeat(4, 1, 1, 1)
    ms16 = cuda_ms(lambda: pred.run(batch16), iters=5)
    info = dict(model="rtdetr-l", parameters=n_params, imgsz=640, images=[list(s) for s in IMAGE_SHAPES],
                conf=pred.conf, k2_launches=launches, k1_launches=k1_launches, kept=kept,
                predict_calls=RTDETR_CALLS,
                predict_ms_per_image={"median": q[2], "p10": q[1], "p90": q[3], "min": q[0], "max": q[4]},
                predict_median_ms_per_call=call_ms,
                device_idle_share=None if busy is None else max(0.0, 1 - busy / call_ms),
                predict_profile=prof,
                device_fn_batch16_ms=ms16, device_fn_batch16_images_per_s=16 * 1e3 / ms16,
                card=card, nvidia_smi=smi)
    return model, batch, info


def rtdetr_parity(RTDETR, model, batch):
    cpu_model = RTDETR("rtdetr-l.yaml", device="cpu", seed=0)
    for (k, a), b in zip(model.model.state_dict().items(), cpu_model.model.state_dict().values()):
        if not torch.equal(a.cpu(), b):
            raise AssertionError(f"seeded weights differ between devices at {k}")
    x = batch.cpu().flip(-1).permute(0, 3, 1, 2).float() / 255.0
    with torch.no_grad():
        y_gpu, aux_gpu = model.model(x.cuda())
        y_cpu, aux_cpu = cpu_model.model(x)
    score_err = float((aux_gpu["enc_scores"].cpu() - aux_cpu["enc_scores"]).abs().max())
    same = aux_gpu["topk_index"].cpu() == aux_cpu["topk_index"]
    n_diff = int((~same).sum())
    out_err = float(((y_gpu.cpu() - y_cpu).abs() * same[..., None]).max())
    # where an index differs, how far apart the CPU's best-class scores of the
    # two anchors are: a gap within the score error is a near-tie, not a fault
    best = aux_cpu["enc_scores"].amax(-1)
    gaps = (best.gather(1, aux_gpu["topk_index"].cpu()) - best.gather(1, aux_cpu["topk_index"]))[~same]
    if not (score_err <= PARITY_TOL and out_err <= PARITY_TOL):
        raise AssertionError(f"card vs CPU: encoder scores {score_err}, outputs {out_err} "
                             f"(tolerance {PARITY_TOL}); {n_diff} top-k indices differ")
    return dict(batch=list(batch.shape), output_shape=list(y_cpu.shape), max_abs_enc_score_err=score_err,
                topk_index_mismatch=n_diff,
                max_abs_score_gap_at_mismatch=float(gaps.abs().max()) if n_diff else None,
                max_abs_output_err_where_index_agrees=out_err, tolerance=PARITY_TOL,
                cpu_threads=torch.get_num_threads())


def main() -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA card",
              file=sys.stderr)
        return 2

    from ultralytics_pro_tpu_torch import RTDETR, YOLO
    from ultralytics_pro_tpu_torch.kernels import build, msda_cuda, nms_cuda
    from ultralytics_pro_tpu_torch.nn.modules.head import decode_single_label
    from ultralytics_pro_tpu_torch.ops import nms as ops_nms

    t_all = time.perf_counter()
    t = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    emit("env", card=card, nvidia_smi=smi, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda, python=sys.version.split()[0],
         tf32=False, seconds=time.perf_counter() - t)

    t = time.perf_counter()
    path = build.build()
    ptxas = [ln.strip() for ln in build.build_info["ptxas"].splitlines()
             if "registers" in ln or "Compiling entry" in ln]
    emit("build", library=path.name, built=build.build_info["built"],
         nvcc_seconds=build.build_info["seconds"], ptxas=ptxas, seconds=time.perf_counter() - t)

    t = time.perf_counter()
    k1 = [k1_check(nms_cuda, "predict", 16, 8400, 300, 0.7, seed=1),
          k1_check(nms_cuda, "val", 2, 30000, 300, 0.7, seed=2)]
    emit("k1", checks=k1, card=card, nvidia_smi=smi, seconds=time.perf_counter() - t)

    t = time.perf_counter()
    model, batch, info = main_path(YOLO, nms_cuda, decode_single_label, card, smi)
    launches = info["k1_launches"]
    emit("main", **info, seconds=time.perf_counter() - t)
    t = time.perf_counter()
    info = parity(YOLO, nms_cuda, ops_nms, decode_single_label, model, batch)
    emit("parity", **info, seconds=time.perf_counter() - t)
    del model

    t = time.perf_counter()
    k2 = [k2_check(msda_cuda, "predict", 1, 300, 8, 32, RTDETR_LEVELS, seed=3),
          k2_check(msda_cuda, "device_fn_batch16", 16, 300, 8, 32, RTDETR_LEVELS, seed=4),
          k2_check(msda_cuda, "edge_hd8_q37_out_of_range", 2, 37, 4, 8, ((12, 16), (6, 8), (3, 4)), seed=5,
                   out_of_range=True)]
    emit("k2", checks=k2, card=card, nvidia_smi=smi, seconds=time.perf_counter() - t)

    t = time.perf_counter()
    model, batch, info = rtdetr_path(RTDETR, msda_cuda, nms_cuda, card, smi)
    k2_launches = info["k2_launches"]
    emit("rtdetr", **info, seconds=time.perf_counter() - t)
    t = time.perf_counter()
    info = rtdetr_parity(RTDETR, model, batch)
    emit("rtdetr_parity", **info, seconds=time.perf_counter() - t)

    pred = k1[0]
    kernels = [{
        "name": "greedy_nms", "route": "cuda",
        "source": "ultralytics_pro_tpu_torch/csrc/greedy_nms.cu",
        "replaces": "ultralytics_pro_tpu/kernels/nms_pallas.py:79",
        "tpu_kernel": "ultralytics_pro_tpu/kernels/nms_pallas.py:pallas_greedy_nms",
        "launches": launches, "max_mismatch": max(c["max_mismatch"] for c in k1),
        "max_abs_err": max(c["max_abs_err"] for c in k1), "ms": pred["ms"], "plain_ms": pred["plain_ms"],
        "bound_ms": pred["bound_ms"], "bound_by": pred["bound_by"],
        "library_ms": None,  # no single PyTorch call computes greedy NMS (no torchvision)
        "val_ms": k1[1]["ms"], "val_plain_ms": k1[1]["plain_ms"], "val_bound_ms": k1[1]["bound_ms"],
    }, {
        "name": "msda_sample", "route": "cuda",
        "source": "ultralytics_pro_tpu_torch/csrc/msda_sample.cu",
        "replaces": "ultralytics_pro_tpu/kernels/msda_pallas.py:52",
        "tpu_kernel": "ultralytics_pro_tpu/kernels/msda_pallas.py:msda_sample_pallas",
        "launches": k2_launches, "max_abs_err": max(c["max_abs_err"] for c in k2),
        "ms": k2[0]["ms"], "plain_ms": k2[0]["plain_ms"], "bound_ms": k2[0]["bound_ms"],
        "bound_by": k2[0]["bound_by"], "library_ms": k2[0]["library_ms"],  # F.embedding_bag
        "batch16_ms": k2[1]["ms"], "batch16_plain_ms": k2[1]["plain_ms"],
        "batch16_bound_ms": k2[1]["bound_ms"], "batch16_library_ms": k2[1]["library_ms"],
    }]
    emit("total", seconds=time.perf_counter() - t_all)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
