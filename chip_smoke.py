"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py    # needs one CUDA card

Phases, one JSON line each on stdout (a failed phase raises and the script
exits non-zero):
  build   nvcc builds every kernel of csrc/ (seconds)
  env     card name, `nvidia-smi` name and power limit, versions; torch's
          TF32 flags as found, as seen inside the device function of a
          yolov8n and an rtdetr-l predict call (both off: the predictors run
          in full f32), and after each call (as found)
  k1      kernel K1 (greedy NMS) against its plain version on the card and
          on the CPU, bit for bit (max_mismatch and max_abs_err over keep,
          valid and the kept boxes), on rows sorted as the main path hands
          them over and on unsorted rows through the wrapper's sort, at the
          predict (B=16, K=8400) and val (B=2, K=30000) sizes: on the timed
          rows (overlapping copies of 320 objects, ties in one row, every
          row 300 keeps) and on edge rows, checked and not timed (a
          zero-area box with ties, a row that runs out, all -1, all equal);
          times, and the bound recounted for the work exact greedy needs on
          the timed rows
  main    YOLO("yolov8s.yaml", device="cuda").predict(4 images) at 640 px,
          with K1's launch count read around the call; warm predict latency
          per image over 200 calls (median and spread), the device's busy
          time, idle share and kernel launches per image on those calls (one
          torch.profiler window of 20 calls against the unprofiled median),
          and the device function's images/s at batch 16
  parity  the same weights on the card and on the CPU: decoded outputs
          within boxes 1e-3 px / scores 1e-4, and NMS on the CPU's decoded
          outputs equal on both devices
  k2      kernel K2 (deformable-attention sampling, coordinates fused in)
          against its plain composition (msda_flatten_coords, then
          msda_sample_plain) on the card and on the CPU within 1e-5, at the
          rtdetr-l predict shape (B=1), the batch-16 device-function shape,
          and an edge case (hd=8, Q=37, locations outside [0, 1]); times,
          the bound, and embedding_bag on the equivalent corner rows as the
          yardstick of the gather part
  k2_grad K2 under autograd (the forward kernel, then the backward kernel)
          against the plain version's autograd on the card, each gradient
          (value, locs, attn) within K2_GRAD_TOL of its largest magnitude,
          at the train shape (B=16, Q=556: 256 denoising + 300 queries,
          V=8400, 8 heads of 32, 3 levels x 4 points) and on an edge case
          (hd=8, locations outside the maps, also against the CPU); the
          backward's time, the plain backward's, the bound, and index_add_
          of the same corner rows as the yardstick of its scatter
  rtdetr  RTDETR("rtdetr-l.yaml", device="cuda").predict(4 images) at 640 px,
          default conf 0.25, with K2's launches read around the call (6 per
          image); warm predict latency per image over 100 calls, the device
          idle share, kernel launches and comparison launches per image from
          one profiled window of 10 calls, and the device function's
          images/s at batch 16
  rtdetr_parity  the same weights and letterboxed batch on the card and on
          the CPU: aux under the JAX decoder's keys and shapes, dense
          encoder scores within 1e-3, top-k query indices that differ
          (reported), final outputs within 1e-3 over the queries whose index
          agrees
  val_fixture  accuracy on the card: YOLO(yolov8n, nc=3).val(...) with the
          reference-trained weights of tests/fixtures/val_parity_model.npz
          on the committed fixture set (a temporary copy) at 160 px, batch 8,
          conf 0.001, on the card and on the CPU; P, R, mAP50 and mAP50-95
          beside val_parity_ref.json's, and the differences; fails if the
          card's mAP50 or mAP50-95 is more than 0.005 from the reference's
  val     detect val at full size: yolov8s, 80 classes, seeded weights, 640
          px, on the fixture images copied 8 times (128 images, 16 a batch,
          grown by the bilinear branch), conf 1e-6 so every row of K1 holds
          K = 30000 candidates; images/s of the whole val() call, the
          validator's per-stage ms per image, K1's launches read around the
          call (8), and from one torch.profiler window of the same call the
          device's busy ms, idle share, K1's device ms per launch and the
          `_topk` sort's device ms per batch
  val_k1  K1 on one batch's real candidate rows captured from the val path
          (offset boxes and sorted scores, (16, 30000)), bit for bit against
          its plain version, timed, with the bound recounted on those rows
          and the candidates each row scans before it stops (greedy_work)
  train_parity  one optimizer step of yolov8n (val_parity_model.npz, nc=3)
          on 8 fixture images at 160 px, batch 8, nbs 8 (accumulate 1), no
          warmup, through YOLO(...).train on the card and on the CPU; the
          largest relative difference of each loss part, and of the updated
          parameters, momentum buffers, EMA and BN statistics (from each
          run's last.ckpt, against each tensor's largest magnitude); fails
          beyond TRAIN_PARITY_TOL
  train_overfit  tests/test_train_dynamics.py's overfit criterion on the
          card: yolov8n (nc rebuilt to 3), 30 epochs at 128 px, batch 8, nbs
          8, warmup_epochs 1.0, lr0 0.01, on the 16 fixture images (train =
          val), val=True so K1 runs at every epoch end; fails unless the mean
          total loss of the last 3 epochs is below 0.75x the first 3's, the
          box loss falls and every epoch's fitness is a number; the final
          EMA mAP50 and mAP50-95 on the set
  train   yolov8s at full width, 640 px, batch 16 (nbs 64, accumulate 4,
          the JAX defaults otherwise), 2 epochs on the val phase's 128
          images (train = val, 80 class names), val after each epoch: train
          images/s over epoch 2 (host clock, val excluded), device ms per
          micro-batch (CUDA events), the model's FLOPs per step against the
          f32 peak, one profiled micro-batch with its optimizer step (idle
          share, device ms by category, the optimizer's among them,
          launches), the criterion alone (TAL and loss, forward and
          backward) in a profiled window, peak memory, the
          loss parts, K1's launches in the two vals and its profiled ms a
          launch there, and K1 on one batch of those rows captured from one
          more val call, bit for bit against its plain version, timed, with
          its bound; fails on a non-finite loss or a None fitness
  seg_train_parity, pose_train_parity, obb_train_parity  train_parity for
          the other tasks, with the epoch-end val: the reference-trained
          yolov8n-seg, yolov8n-pose ([5, 3]) and yolov8n-obb on 8 images of
          their fixture sets, one step at 160 px, batch 8, nbs 8, on the card
          and on the CPU, within TRAIN_PARITY_TOL; K1's launches in the card's
          val (one) or the rotated NMS's calls (obb, one); for segment and
          pose K1's rows captured there (candidates clear conf: the weights
          are trained) bit for bit against the plain version, timed, with
          the bound, and K1's device ms a launch from a profiled val
  seg_train, pose_train, obb_train  phase train for the other tasks:
          yolov8s-seg (80 classes) and yolov8s-pose (rebuilt at the set's nc
          3 and [5, 3]) at 640, yolov8s-obb (nc 15) at 1024, batch 16, the
          JAX defaults, 2 epochs on 128 images of the task's set with val:
          the same numbers as train (the criterion alone is the task's, its
          device ms by category too), K1's launches in the vals or the
          rotated NMS's calls, and the NMS's device ms a val batch
  seg_fixture, pose_fixture  accuracy of the other tasks on the card: the
          reference-trained yolov8n-seg and yolov8n-pose
          (val_parity_{segment,pose}_model.npz, nc 3, pose's kpt_shape [5, 3])
          through YOLO(...).val on tests/fixtures/torch_val_synth_{segment,pose}
          at 160 px, batch 8, conf 0.001, iou 0.7, on the card and on the CPU;
          fails if a box, mask or pose mAP50 or mAP50-95 of the card is more
          than TASK_FIXTURE_TOL from the CPU's or 0.005 from the *_ref.json's
  seg, pose  YOLO("yolov8s-seg.yaml") (80 classes) and YOLO("yolov8s-pose.yaml")
          (nc 1, 17x3 keypoints), seeded weights, predict on the 4 images at
          640 px with conf 1e-6: K1's launches around the call (one an image),
          masks (bool, the original image's size) or keypoints checked; warm
          latency per image over TASK_CALLS calls, the idle share, launches
          an image and K1's ms a launch from one profiled window, the device
          function's images/s at batch 16, the copies' device ms an image;
          segment's mask step (combine, pad cut, resize, crop) in device ms
          an image beside the forward's (both from the profiler), and its
          mask probabilities against the same step on the CPU (within
          MASK_TOL, > 0.5 bits flipped on at most MASK_EDGE_SHARE);
          K1 on one batch's captured rows (the 4 images, K = 8400) bit for
          bit against its plain version, timed, with its bound, and the NMS
          outputs, the `extra` payload among them, equal to the plain path's
  seg_val yolov8s-seg val at 640, 80 classes, seeded weights, the segment set
          copied 8 times (128 images, batch 16), conf 1e-6: multi-label K1 at
          K = 30000 with the 32-wide payload; images/s, idle share, `_topk`'s
          sort and K1 from one profiled call, and K1 on one batch's captured
          rows (bit for bit, timed, bound) with the payload's gather equal to
          the plain path's
  obb_fixture  accuracy of the OBB task on the card: the reference-trained
          yolov8n-obb (val_parity_obb_model.npz, nc 3) through YOLO(...).val
          on tests/fixtures/torch_val_synth_obb at 160 px, batch 8, conf
          0.001, iou 0.7, on the card and on the CPU; fails if a box mAP50 or
          mAP50-95 of the card is more than TASK_FIXTURE_TOL from the CPU's
          or 0.005 from val_parity_obb_ref.json's; K1 is not launched, the
          rotated NMS once a batch
  obb     YOLO("yolov8s-obb.yaml") (nc 15, DOTA's), seeded weights, predict
          on the 4 images at 1024 px (A = 21,504 anchors) with conf 1e-6, so
          each image keeps 300 rboxes of K = 4096 candidates: 1-300 finite
          rboxes an image with (n, 4, 2) corners; warm latency per image over
          TASK_CALLS calls, the idle share and launches an image from one
          profiled window, the rotated NMS's device ms and launches a call
          from that window (the kernels launched inside its
          record_function, category rotated_nms) and on one image's decoded
          outputs alone, the device function's images/s at batch 16; card
          against CPU on one image: decoded outputs within OBB_PARITY_TOL,
          and the rotated NMS on the CPU's outputs keeping the same
          candidates on both devices (rboxes, scores, cls, valid equal)
  obb_val yolov8s-obb val at 1024 on the OBB set copied 8 times (128 images,
          batch 16, conf 1e-6): images/s, idle share and launches from one
          profiled call, the rotated NMS's device ms a batch there, and on
          one batch's decoded outputs alone its device ms, launches and peak
          memory
  rtdetr_val  RTDETR("rtdetr-l.yaml").val at 640, seeded weights, 80
          classes, on the detect fixture images copied 8 times (128 images,
          batch 16, conf 0.001): images/s, K2's launches read around the call
          (48, 6 a batch), the idle share, the device ms a batch by kernel
          class and K2's ms a launch from one profiled call; K2 on one val
          batch's captured inputs against its plain version, timed, with its
          bound and embedding_bag's time on the same corner rows; card
          against CPU on the first 16 images (mAPs within RTDETR_VAL_TOL,
          kept queries and boxes where the images' top-k rows agree)
  rtdetr_train_parity  one optimizer step of seeded rtdetr-l (nc 3) on 8
          fixture images at 160 px, batch 8, nbs 8, through
          RTDETR(...).train on the CPU and on the card, the same denoising
          noise (each trainer's generator from seed 0) and, replayed on the
          card, the CPU run's top-k selection and matching: card against
          CPU within RTDETR_TRAIN_PARITY_TOL (loss parts relative; params,
          EMA and BN statistics against the tree's largest magnitude;
          momentum buffers as relative L2 distances, the tree's and the
          worst leaf's), and the card's own top-k indices and matched
          queries that differ from the CPU's, reported with their gaps
  rtdetr_train  RTDETR("rtdetr-l.yaml").train at 640, 80 classes, batch 16,
          the JAX defaults, 2 epochs on the fixture images 8 times over (no
          epoch-end val, as the JAX RT-DETR trainer): K2's forward and
          backward launches read around the run (6 + 6 a micro-batch), the
          matcher's host ms a step, train images/s in epoch 2, device ms a
          micro-batch, the idle share, the criterion's device ms and
          launches, K2's forward and backward ms a launch from the profile,
          peak memory, and K2 on one micro-batch's captured inputs and
          gradient, forward and backward, against the plain version, timed,
          with their bounds
  cls     YOLO("yolov8s-cls.yaml") (nc 1000), seeded weights, predict at 224
          on the 4 images: warm latency an image over CLS_CALLS calls, the
          idle share from a profiled window, the device function's images/s
          at batch 16, its probabilities on the card against the CPU's on the
          same resized batch within CLS_TOL
  cls_fixture  the JAX-trained yolov8n-cls (val_parity_cls_model.npz, nc 3)
          through YOLO(...).val on tests/fixtures/torch_cls_synth at 64 px,
          batch 16, on the card and on the CPU: top1 and top5 equal to each
          other and to val_parity_cls_ref.json's
  cls_val yolov8s-cls val at 224 on the fixture's val images 8 times over
          (128 images, batch 16): images/s, idle share
  cls_train_parity  one optimizer step of the fixture yolov8n-cls on 8
          images at 64 px, batch 8, nbs 8, with the epoch-end val, on the card
          and on the CPU, within TRAIN_PARITY_TOL and the same fitness
  cls_train  yolov8s-cls at 224 rebuilt at nc 3, batch 16, the JAX defaults,
          2 epochs on 128 images: the numbers of phase train (images/s, device
          ms a micro-batch, idle share, the criterion's ms and launches, the
          FLOP share)
  kernels the per-kernel summary line
The last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

# Peak rates of one H100 SXM (NVIDIA data sheet): HBM bytes/s, f32 (non-tensor) FLOP/s.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
IOU_TEST_OPS = 17  # one IoU test: min/max x4, sub x4, clip x2, mul x2, add/sub x3, div, compare
NMS_OPS_PER_CANDIDATE_STEP = 18  # the argmax form: an IoU test and the argmax, per candidate and step
# K1's timed rows: candidates are jittered copies of NMS_OBJECTS boxes a row,
# so most are suppressed and a row scans some 800-900 candidates before its
# 300th keep at IoU 0.7, as yolov8s predict's rows scan 621-1,361 (PERF.md)
NMS_OBJECTS = 320
NMS_JITTER = 0.02  # std of a copy's centre and log size, relative to its object's size
CONF = 1e-6  # random-init class logits sit near log(5/nc/(640/s)^2), i.e. scores ~1e-5
MIN_CANDIDATES = 1000
IMAGE_SHAPES = ((480, 640), (720, 1280), (640, 640), (333, 500))
PREDICT_CALLS = 200  # timed warm predict calls of the 4 images, one at a time
PROFILED_CALLS = 20  # predict calls traced by torch.profiler for the device's busy time
RTDETR_CALLS = 100  # the same for RT-DETR
RTDETR_PROFILED_CALLS = 10
RTDETR_LEVELS = ((80, 80), (40, 40), (20, 20))  # rtdetr-l's P3-P5 at 640 px: V = 8400 value rows
PARITY_TOL = 1e-3  # card vs CPU, rtdetr-l encoder scores and final outputs
FIXTURES = Path(__file__).resolve().parent / "tests" / "fixtures"
VAL_FIXTURE_TOL = 0.005  # card vs val_parity_ref.json, the tolerance of tests/test_val_parity.py
VAL_COPIES = 8  # the val phase's data: the fixture's 16 images 8 times over
VAL_BATCH = 16
VAL_IMGSZ = 640
SLEEP_CYCLES = 100_000_000  # cuda_ms's head start for the host: about 50 ms at the H100's clock
# cuDNN's f32 convolutions run as implicit GEMM (fprop) or FFT (fft*,
# pointwise_mult_and_sum_complex, gemv2T on float2); cuBLAS's matmuls as gemm.
CONV_KERNELS = ("conv", "fprop", "dgrad", "wgrad", "implicit_gemm", "winograd", "fft", "pointwise_mult_and_sum",
                "region_transform", "float2")
MATMUL_KERNELS = ("gemm", "gemv", "xmma", "cutlass")
# The optimizer's foreach kernels (SGD, gradient clipping, EMA) run as multi_tensor_apply.
OPTIMIZER_KERNELS = ("multi_tensor_apply", "foreach")
# train_parity: card against CPU after one step, the tolerances of the CPU
# tests that hold the port's step against the JAX step (tests/test_torch_train.py):
# loss parts relative, trees against each tensor's largest magnitude
TRAIN_PARITY_TOL = {"loss": 1e-4, "params": 1e-4, "ema": 1e-4, "batch_stats": 1e-4, "momentum_buffer": 2e-3}
TRAIN_PARITY_IMAGES = 8
TRAIN_IMGSZ, TRAIN_BATCH, TRAIN_EPOCHS = 640, 16, 2
TASK_FIXTURE_TOL = 1e-4  # card vs CPU, each mAP on the segment, pose and obb fixture sets
TASK_CALLS = 50  # timed warm predict calls of yolov8s-seg and yolov8s-pose
TASK_PROFILED_CALLS = 5
MASK_TOL, MASK_EDGE_SHARE = 1e-5, 1e-3  # mask step, card vs CPU: probabilities, and > 0.5 bits that flip
# the other tasks: the reference-trained fixture model and set, the served
# model, the mAPs against the reference's keys, and the K1 launches and
# rotated-NMS calls of the fixture val (16 images, batch 8)
TASKS = {
    "segment": dict(stem="val_parity_segment", fixture_yaml="yolov8n-seg.yaml", set="torch_val_synth_segment",
                    served="yolov8s-seg", maps=(("box.map50", "metrics/mAP50(B)"), ("box.map", "metrics/mAP50-95(B)"),
                                                ("seg.map50", "metrics/mAP50(M)"), ("seg.map", "metrics/mAP50-95(M)")),
                    fixture_k1=2, fixture_rotated=0),
    "pose": dict(stem="val_parity_pose", fixture_yaml="yolov8n-pose.yaml", set="torch_val_synth_pose",
                 served="yolov8s-pose", maps=(("box.map50", "metrics/mAP50(B)"), ("box.map", "metrics/mAP50-95(B)"),
                                              ("pose.map50", "metrics/mAP50(P)"), ("pose.map", "metrics/mAP50-95(P)")),
                 fixture_k1=2, fixture_rotated=0),
    "obb": dict(stem="val_parity_obb", fixture_yaml="yolov8n-obb.yaml", set="torch_val_synth_obb",
                served="yolov8s-obb", maps=(("box.map50", "metrics/mAP50(B)"), ("box.map", "metrics/mAP50-95(B)")),
                fixture_k1=0, fixture_rotated=2),
}
OBB_IMGSZ = 1024  # yolov8s-obb's DOTAv1 size: A = 21,504 anchors, K = 4096 candidates an image
OBB_MAX_NMS = 4096
# card vs CPU, yolov8s-obb's decoded outputs on one image at 1024 px
OBB_PARITY_TOL = {"xywh_px": 2e-3, "scores": 1e-4, "angle_rad": 1e-4}
ROTATED_NMS_SCOPE = "nms_rotated"  # ops/nms.py's record_function around non_max_suppression_rotated
RTDETR_VAL_CONF = 0.001  # the val default; random rtdetr-l scores sit near sigmoid(-4.6) = 0.01
# card vs CPU, rtdetr-l val on the first 16 images: boxes in letterbox pixels
# where the image's top-k rows agree, and the mAPs. The boxes' aim was 1e-3
# px; the card's f32 differs from the CPU's by 1.22e-3 px there (2e-6 of the
# 640 px frame after 6 decoder layers), so the bound is OBB_PARITY_TOL's
RTDETR_VAL_TOL = {"boxes_px": 2e-3, "map": 1e-4}
# K2's backward: every gradient against the plain version's autograd within
# this share of its largest magnitude (grad_value is summed with atomics, in
# no fixed order, so not bit for bit)
K2_GRAD_TOL = 1e-5
# rtdetr-l training at 640: the JAX defaults (max_gt 128, num_dn 100), so one
# denoising group of 2 x 128 queries before the 300: K2 at Q = 556
RTDETR_TRAIN_Q = 556
RTDETR_PARITY_IMGSZ = 160
# rtdetr_train_parity: card against CPU after one rtdetr-l step (rtdetr_step_diffs).
# Loss parts, params, EMA and BN statistics at TRAIN_PARITY_TOL. The momentum
# buffers (the step's gradient) cannot be held to its 2e-3: the step's
# gradient is only piecewise smooth (sampling points crossing pixel edges,
# ReLU kinks), so the float64 step itself moves by 0.028 (tree) and 0.044
# (worst leaf) when its input moves by 1e-7, and the card's float32 step is
# 0.028 and 0.069 from the CPU's (tools/torch_rtdetr_step_precision.py, in
# PERF.md). The limits below are about 3x those readings: a missing,
# sign-flipped or misplaced gradient fails them (a leaf at 1 or more), a 10%
# fault in one of K2's gradients does not (0.1 at most), which the k2_grad
# phase holds to K2_GRAD_TOL instead.
RTDETR_TRAIN_PARITY_TOL = {**TRAIN_PARITY_TOL, "momentum_buffer": 0.1, "momentum_leaf": 0.2}
MOMENTUM_LEAF_FLOOR = 1e-8  # rtdetr_step_diffs: leaves below this share of the largest norm hold rounding only
CLS_IMGSZ = 224  # yolov8s-cls's ImageNet size
CLS_CALLS = 100  # timed warm predict calls of yolov8s-cls
CLS_PROFILED_CALLS = 10
CLS_TOL = 1e-5  # card vs CPU, yolov8s-cls probabilities
CLS_SET = "torch_cls_synth"  # the classify fixture set: 3 classes, 24 train and 16 val PNGs of 80 x 64


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else \
        f"nvidia-smi failed: {out.stderr.strip()}"


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of fn() over iters calls, by CUDA events. The calls
    queue behind a sleep kernel of some 50 ms, so the card runs them back to
    back however long the host takes to launch them: a short kernel's time is
    its own, not its wrapper's host time. (A function that synchronises, or
    that queues more launches than the card's queue holds, is still paced by
    the host in part.)"""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
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


def category(name: str, scope: str | None = None) -> str:
    """Coarse kernel class (CONV_KERNELS and MATMUL_KERNELS say how). A
    kernel that an op inside the rotated NMS's record_function launched
    (scope ROTATED_NMS_SCOPE, see scoped_kernels) is rotated_nms: plain
    PyTorch, its kernels have no names of their own."""
    if scope == ROTATED_NMS_SCOPE:
        return "rotated_nms"
    n = name.lower()
    if "greedy_nms" in n:
        return "k1_greedy_nms"
    if "msda_sample_fused_backward" in n:
        return "k2_msda_backward"
    if "msda_sample" in n:
        return "k2_msda_sample"
    if any(s in n for s in OPTIMIZER_KERNELS):
        return "optimizer"
    if any(s in n for s in CONV_KERNELS):
        return "convolution"
    if any(s in n for s in MATMUL_KERNELS):
        return "matmul"
    if "bn_fw" in n or "bn_bw" in n or "batch_norm" in n or "batchnorm" in n:
        return "batchnorm"
    if "nhwctonchw" in n or "nchwtonhwc" in n:  # cuDNN's layout copies around its NHWC engines
        return "layout_transpose"
    if "layer_norm" in n:
        return "layernorm"
    if "sort" in n or "radix" in n:
        return "sort"
    if "memcpy" in n:
        return "memcpy"
    return "other_elementwise_reduce"


def scoped_kernels(prof, scope: str) -> dict:
    """{category: [device ms, launches]} of the kernels launched by ops that
    ran inside record_function(scope), over the whole trace: each CPU op's
    kernels as the profiler links them, the op kept when scope is among its
    ancestors."""
    out = {}
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CPU or not getattr(ev, "kernels", None):
            continue
        p = ev
        while p is not None and p.name != scope:
            p = p.cpu_parent
        if p is None:
            continue
        for k in ev.kernels:
            acc = out.setdefault(category(k.name), [0.0, 0])
            acc[0] += k.duration / 1e3
            acc[1] += 1
    return out


def profile_window(fn, reps: int, warmup: int = 2, ops=(), top: int = 12, scope: str | None = None) -> dict:
    """Trace reps warm calls of fn with torch.profiler. Device busy ms per call
    is the sum of the kernels' device times (one stream, so they do not
    overlap); the profiler adds host time, so the window's own wall time and
    idle share read high. device_busy_ms_per_call is None if the trace holds
    no device time. For each torch op named in ops (e.g. "aten::sort"), the
    device time of the kernels it launched and its calls, per call of fn.
    With scope, the kernels launched inside record_function(scope) move from
    their own categories to category(_, scope), and 'scope' holds their
    device ms and launches per call of fn."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    by_cat, kernels, compares = {}, [], 0
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        if dev_us <= 0 or ev.device_type != torch.autograd.DeviceType.CUDA or ev.key == scope:
            continue  # (a range's own device-side span is no kernel)
        cat = category(ev.key)
        by_cat[cat] = by_cat.get(cat, 0.0) + dev_us / 1e3 / reps
        kernels.append((dev_us / 1e3 / reps, ev.count / reps, ev.key[:90]))
        if "compare_scalar" in ev.key:
            compares += ev.count / reps
    scoped = None
    if scope:
        inside = scoped_kernels(prof, scope)
        scoped = {"name": scope, "device_ms_per_call": None, "launches_per_call": 0}  # none linked
    if scope and inside:
        for cat, (ms, _) in inside.items():
            left = by_cat.get(cat, 0.0) - ms / reps
            if left > 1e-9:
                by_cat[cat] = left
            else:  # every kernel of the class ran inside the scope
                by_cat.pop(cat, None)
        by_cat[category("", scope)] = sum(ms for ms, _ in inside.values()) / reps
        scoped = {"name": scope, "device_ms_per_call": by_cat[category("", scope)],
                  "launches_per_call": sum(n for _, n in inside.values()) / reps,
                  "device_ms_by_category": {c: ms / reps for c, (ms, _) in inside.items()}}
    busy = sum(by_cat.values()) or None
    kernels.sort(reverse=True)
    op_times = {}
    for ev in prof.key_averages():
        if ev.key in ops:
            dev_us = getattr(ev, "device_time_total", None)
            if dev_us is None:
                dev_us = getattr(ev, "cuda_time_total", 0.0)
            op_times[ev.key] = {"device_ms_per_call": dev_us / 1e3 / reps, "calls_per_call": ev.count / reps}
    return {"profiled_calls": reps, "profiled_wall_ms_per_call": wall_ms, "ops": op_times,
            "device_busy_ms_per_call": busy,
            "profiled_idle_share": None if busy is None else max(0.0, 1 - busy / wall_ms),
            "device_ms_by_category": by_cat,
            "kernel_launches_per_call": sum(k[1] for k in kernels),
            "compare_scalar_launches_per_call": compares, "scope": scoped,
            "top_kernels": [{"ms": k[0], "per_call": k[1], "name": k[2]} for k in kernels[:top]]}


def nms_rows(rng, b: int, k: int, nc: int = 80, max_wh: float = 7680.0):
    """K1's timed rows: class-offset xyxy boxes, each a jittered copy of one of
    the row's NMS_OBJECTS objects, and scores in [0, 1] or -1, unsorted; the
    last row's scores on a grid of 1/16 (ties). Every row reaches 300 keeps."""
    c = rng.uniform(0, 640, (b, NMS_OBJECTS, 2))
    wh = rng.uniform(8, 160, (b, NMS_OBJECTS, 2))
    cls = rng.integers(0, nc, (b, NMS_OBJECTS))
    obj = rng.integers(0, NMS_OBJECTS, (b, k))
    c = np.take_along_axis(c, obj[..., None], 1)
    wh = np.take_along_axis(wh, obj[..., None], 1)
    c = c + rng.normal(0, NMS_JITTER, (b, k, 2)) * wh
    wh = wh * np.exp(rng.normal(0, NMS_JITTER, (b, k, 2)))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], -1) + np.take_along_axis(cls, obj, 1)[..., None] * max_wh
    scores = np.where(rng.uniform(0, 1, (b, k)) < 0.7, rng.uniform(0, 1, (b, k)), -1.0)
    scores[b - 1] = np.where(scores[b - 1] > 0, np.ceil(scores[b - 1] * 16) / 16, -1.0)
    return boxes.astype(np.float32), scores.astype(np.float32)


def nms_edge_rows(rng, b: int, k: int, nc: int = 80, max_wh: float = 7680.0):
    """K1's edge cases, checked and not timed: random class-offset boxes and
    scores, and in the first rows (as many as b holds) a zero-area box at the
    100th best of scores with ties, which does not suppress itself and so
    fills every slot after it; a row that runs out after 5 picks; an all -1
    row; a row whose live scores are all equal."""
    c = rng.uniform(0, 640, (b, k, 2))
    wh = rng.uniform(4, 160, (b, k, 2))
    cls = rng.integers(0, nc, (b, k, 1))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], -1) + cls * max_wh
    scores = np.where(rng.uniform(0, 1, (b, k)) < 0.7, rng.uniform(0, 1, (b, k)), -1.0)
    scores[0] = np.where(scores[0] > 0, np.ceil(scores[0] * 16) / 16, -1.0)  # ties
    j = np.argsort(-scores[0], kind="stable")[99]
    boxes[0, j, 2] = boxes[0, j, 0]  # zero width
    if b > 1:
        scores[1] = -1.0
        scores[1, rng.choice(k, 5, replace=False)] = rng.uniform(0.1, 1, 5)
    if b > 2:
        scores[2] = -1.0
    if b > 3:
        scores[3] = np.where(scores[3] > 0, 0.5, -1.0)
    return boxes.astype(np.float32), scores.astype(np.float32)


def kept_outputs(boxes, keep, valid):
    """keep and valid as floats, and the kept boxes (zero where not valid)."""
    kept = torch.gather(boxes, 1, keep.long()[..., None].expand(-1, -1, 4)) * valid[..., None]
    return keep.double(), valid.double(), kept.double()


def iou_suppresses(winners, cands, thres: float):
    """(W, C) bool: ops/nms.py:40-45 in f32, winners (W, 4) in the winner's place."""
    f32 = np.float32
    bj, bt = winners[:, None], cands[None]
    w = np.maximum(np.minimum(bj[..., 2], bt[..., 2]) - np.maximum(bj[..., 0], bt[..., 0]), f32(0))
    h = np.maximum(np.minimum(bj[..., 3], bt[..., 3]) - np.maximum(bj[..., 1], bt[..., 1]), f32(0))
    area = lambda b: (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])  # noqa: E731
    inter = w * h
    with np.errstate(divide="ignore", invalid="ignore"):
        return inter / (area(bj) + area(bt) - inter + f32(1e-7)) > f32(thres)


def greedy_work(boxes, scores, keep, valid, max_det: int, thres: float):
    """The work exact greedy NMS needs on these sorted rows, from the plain
    version's result: per candidate ahead of the row's stop, the IoU tests
    against the keeps before it up to the first that suppresses it (a keep
    also tests itself), and the candidates read (those ahead of the stop,
    plus the first non-positive score where that ends the row). Returns the
    two counts per row."""
    tests, reads = [], []
    for bx, sc, kp, vd in zip(boxes, scores, keep, valid):
        kept = []
        for x in kp[vd].tolist():  # the distinct keeps; a lazy box then repeats
            if kept and x <= kept[-1]:
                break
            kept.append(x)
        if kept and (len(kept) == max_det or len(kept) < int(vd.sum())):
            stop = kept[-1] + 1
            reads.append(stop)
        else:
            nonpos = np.flatnonzero(~(sc > 0))
            stop = int(nonpos[0]) if len(nonpos) else len(sc)
            reads.append(min(len(sc), stop + 1))
        if not kept:
            tests.append(0)
            continue
        kept = np.asarray(kept)
        before = np.searchsorted(kept, np.arange(stop))  # keeps ahead of each candidate
        hit = iou_suppresses(bx[kept], bx[:stop], thres) & (np.arange(len(kept))[:, None] < before)
        first = np.where(hit.any(0), hit.argmax(0) + 1, before + 1)  # a keep: all before it, then itself
        tests.append(int(first.sum()))
    return tests, reads


def k1_bound(boxes, scores, keep, valid, max_det: int, thres: float) -> dict:
    """The least time for K1's work on these sorted rows (greedy_work): the
    candidates read and the outputs written once at the HBM rate, or the IoU
    tests at the f32 rate, whichever is longer."""
    tests, reads = greedy_work(boxes, scores, keep, valid, max_det, thres)
    nbytes = sum(reads) * (16 + 4) + len(reads) * max_det * (4 + 1)
    ops = sum(tests) * IOU_TEST_OPS
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_FLOPS * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes > t_ops else "operations",
            "bytes": nbytes, "candidates_read": sum(reads), "iou_tests": sum(tests), "ops": ops,
            "read_per_row": reads}


@contextlib.contextmanager
def capture_k1(ops_nms):
    """Records the first K1 call NMS makes inside the block: K1's rows as it
    received them (class-offset boxes, scores) and its keyword arguments,
    and the arguments and result of the gather around it
    (`_suppress_and_gather`, which gathers the `extra` payload). Yields a
    dict that holds 'rows', 'k1_kwargs', 'gather_args' and 'gather_out'
    once a call has been made."""
    cap, greedy_nms, gather = {}, ops_nms.greedy_nms, ops_nms._suppress_and_gather

    def k1(boxes, scores, **k):
        if "rows" not in cap:
            cap["rows"], cap["k1_kwargs"] = (boxes.clone(), scores.clone()), k
        return greedy_nms(boxes, scores, **k)

    def suppress_and_gather(*args):
        out = gather(*args)
        if "gather_out" not in cap:
            cap["gather_args"] = tuple(a.clone() if torch.is_tensor(a) else a for a in args)
            cap["gather_out"] = {k: v.clone() for k, v in out.items()}
        return out

    ops_nms.greedy_nms, ops_nms._suppress_and_gather = k1, suppress_and_gather
    try:
        yield cap
    finally:
        ops_nms.greedy_nms, ops_nms._suppress_and_gather = greedy_nms, gather


@contextlib.contextmanager
def capture_rotated(*modules):
    """Counts the calls of `non_max_suppression_rotated` that the given
    modules (the predictor's, the validator's) make inside the block, and
    records the first call's inputs: yields a dict with 'calls' and, once a
    call has been made, 'args' (rboxes, scores) and 'kwargs'."""
    cap = {"calls": 0}
    fns = [m.non_max_suppression_rotated for m in modules]

    def counted(fn):
        def nms(rboxes, scores, **kw):
            cap["calls"] += 1
            if "args" not in cap:
                cap["args"], cap["kwargs"] = (rboxes.clone(), scores.clone()), kw
            return fn(rboxes, scores, **kw)
        return nms

    for m, fn in zip(modules, fns):
        m.non_max_suppression_rotated = counted(fn)
    try:
        yield cap
    finally:
        for m, fn in zip(modules, fns):
            m.non_max_suppression_rotated = fn


def gather_mismatch(ops_nms, nms_cuda, cap) -> int:
    """Entries of the captured NMS outputs (boxes, scores, cls, valid and the
    `extra` payload) that differ from the same gather run with K1's plain
    version on the same candidates."""
    greedy_nms = ops_nms.greedy_nms
    ops_nms.greedy_nms = lambda b, sc, max_det, iou_thres, presorted=False: nms_cuda.greedy_nms_plain(
        b, sc, max_det, iou_thres)
    try:
        plain = ops_nms._suppress_and_gather(*cap["gather_args"])
    finally:
        ops_nms.greedy_nms = greedy_nms
    got = cap["gather_out"]
    if plain.keys() != got.keys():
        raise AssertionError(f"NMS outputs {sorted(got)} against the plain path's {sorted(plain)}")
    return sum(int((got[k] != plain[k]).sum()) for k in got)


def k1_compare(nms_cuda, boxes, scores, max_det: int, iou: float):
    """K1 against its plain version on the card and on the CPU, on the rows
    sorted (stable, descending) and as they are (through the wrapper's sort).
    Returns the entries that differ, the max |kernel - plain| over keep
    indices, valid flags and kept boxes (what a caller gathers), the sorted
    rows and the kernel's result on them (host arrays)."""
    order = torch.sort(scores, dim=1, descending=True, stable=True).indices
    sboxes = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
    sscores = torch.gather(scores, 1, order)
    mismatch, max_abs_err, on_sorted = 0, 0.0, []
    for bx, sc, presorted in ((sboxes, sscores, True), (boxes, scores, False)):
        keep, valid = nms_cuda.greedy_nms(bx, sc, max_det, iou, presorted=presorted)
        torch.cuda.synchronize()
        out = kept_outputs(bx.cpu(), keep.cpu(), valid.cpu())
        refs = (nms_cuda.greedy_nms_plain(bx, sc, max_det, iou),
                nms_cuda.greedy_nms_plain(bx.cpu(), sc.cpu(), max_det, iou))
        for ref_k, ref_v in refs:
            ref_k, ref_v = ref_k.cpu(), ref_v.cpu()
            mismatch += int((keep.cpu() != ref_k).sum() + (valid.cpu() != ref_v).sum())
            max_abs_err = max(max_abs_err, *(float((x - y).abs().max()) for x, y in
                                              zip(out, kept_outputs(bx.cpu(), ref_k, ref_v))))
        on_sorted.append((keep.cpu().numpy(), valid.cpu().numpy()))
    return mismatch, max_abs_err, sboxes, sscores, on_sorted[0]


def k1_check(nms_cuda, name: str, b: int, k: int, max_det: int, iou: float, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    boxes, scores = (torch.from_numpy(a).cuda() for a in nms_rows(rng, b, k))
    edge_boxes, edge_scores = (torch.from_numpy(a).cuda() for a in nms_edge_rows(rng, b, k))
    mismatch, max_abs_err, sboxes, sscores, (keep_s, valid_s) = k1_compare(
        nms_cuda, boxes, scores, max_det, iou)
    edge_mismatch, edge_err, _, _, (_, edge_valid) = k1_compare(
        nms_cuda, edge_boxes, edge_scores, max_det, iou)
    mismatch, max_abs_err = mismatch + edge_mismatch, max(max_abs_err, edge_err)
    if mismatch or max_abs_err:
        raise AssertionError(f"K1 {name}: {mismatch} entries differ from the plain version "
                             f"(max abs error {max_abs_err})")
    kept, edge_kept = valid_s.sum(1), edge_valid.sum(1)
    if kept.min() != max_det:
        raise AssertionError(f"K1 {name}: timed rows kept {kept.tolist()}, want {max_det} each")
    if edge_kept[0] != max_det:
        raise AssertionError(f"K1 {name}: the zero-area box did not fill its row ({edge_kept[0]} kept)")
    ms = cuda_ms(lambda: nms_cuda.greedy_nms(sboxes, sscores, max_det, iou, presorted=True), iters=50)
    unsorted_ms = cuda_ms(lambda: nms_cuda.greedy_nms(boxes, scores, max_det, iou), iters=50)
    plain_ms = cuda_ms(lambda: nms_cuda.greedy_nms_plain(sboxes, sscores, max_det, iou), iters=3, warmup=1)
    # bound: the candidates exact greedy must read and the IoU tests it must
    # make on this data (greedy_work), the outputs written once; beside it the
    # argmax form's operations (kept steps over K, plus one final argmax pass
    # where a row stops early), the count PRs 4 and 5 used
    bound = k1_bound(sboxes.cpu().numpy(), sscores.cpu().numpy(), keep_s, valid_s, max_det, iou)
    del bound["read_per_row"]
    argmax_ops = sum(int(n) * k * NMS_OPS_PER_CANDIDATE_STEP + (k if n < max_det else 0) for n in kept)
    return {"size": name, "B": b, "K": k, "max_det": max_det, "iou": iou, "max_mismatch": mismatch,
            "max_abs_err": max_abs_err, "checked": ["timed sorted", "timed unsorted", "edge sorted", "edge unsorted"],
            "rows": {"timed": f"{NMS_OBJECTS} objects a row, jittered copies; ties in the last row",
                     "edge": ["zero-area box at the 100th best, ties", "runs out after 5",
                              "all -1", "all equal"][:b]},
            "kept_per_row": kept.tolist(), "edge_kept_per_row": edge_kept.tolist(), "ms": ms, "unsorted_ms": unsorted_ms, "plain_ms": plain_ms,
            **bound, "argmax_form_ops": argmax_ops, "argmax_form_bound_ms": argmax_ops / F32_FLOPS * 1e3}


def main_path(YOLO, nms_cuda, decode_single_label, full_f32, card: str, smi: str):
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
    with torch.no_grad(), full_f32():
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
                kernel_launches_per_image=prof["kernel_launches_per_call"] / len(imgs),
                predict_profile=prof,
                device_fn_batch16_ms=ms16, device_fn_batch16_images_per_s=16 * 1e3 / ms16,
                card=card, nvidia_smi=smi)
    return model, batch, info


def parity(YOLO, nms_cuda, ops_nms, decode_single_label, full_f32, model, batch):
    cpu_model = YOLO("yolov8s.yaml", device="cpu", seed=0)
    for (k, a), b in zip(model.model.state_dict().items(), cpu_model.model.state_dict().values()):
        if not torch.equal(a.cpu(), b):
            raise AssertionError(f"seeded weights differ between devices at {k}")
    x = batch[:1].cpu().flip(-1).permute(0, 3, 1, 2).float() / 255.0
    with torch.no_grad(), full_f32():  # the predictors' precision
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
    keep_g, valid_g = nms_cuda.greedy_nms(cand.cuda(), top.cuda(), 300, 0.7, presorted=True)
    keep_diff = int((keep_g.cpu() != keep_c).sum() + (valid_g.cpu() != valid_c).sum())
    if nms_diff or keep_diff:
        raise AssertionError(f"NMS on the card differs from the CPU: {nms_diff} output entries, "
                             f"{keep_diff} keep entries")
    return dict(decoded_shape=list(y_cpu.shape), max_abs_box_err_px=box_err,
                max_abs_score_err=score_err, tolerance={"boxes_px": 1e-3, "scores": 1e-4},
                nms_output_mismatch=nms_diff, k1_keep_mismatch=keep_diff, kept=int(valid_c.sum()))


def k2_inputs(rng, b: int, q: int, nh: int, hd: int, shapes, p: int = 4, lo: float = -0.1,
              hi: float = 1.1):
    """A value table (B, V, nh, hd) as MSDeformAttn makes it, locations
    uniform in [lo, hi] (outside [0, 1] their corners fall outside the maps)
    and attention weights that sum to 1 over each query's points, on the card."""
    v = sum(h * w for h, w in shapes)
    value = torch.from_numpy(rng.normal(size=(b, v, nh, hd)).astype(np.float32)).cuda()
    locs = torch.from_numpy(rng.uniform(lo, hi, (b, q, nh, len(shapes), p, 2)).astype(np.float32)).cuda()
    attn = rng.uniform(0, 1, (b, q, nh, len(shapes), p)).astype(np.float32)
    attn = torch.from_numpy(attn / attn.sum((-1, -2), keepdims=True)).cuda()
    return value, locs, attn


def k2_check(msda_cuda, name: str, b: int, q: int, nh: int, hd: int, shapes, seed: int,
             lo: float = -0.1, hi: float = 1.1) -> dict:
    shapes = list(shapes)
    value, locs, attn = k2_inputs(np.random.default_rng(seed), b, q, nh, hd, shapes, lo=lo, hi=hi)
    return {**k2_measure(msda_cuda, name, value, shapes, locs, attn), "locations": [lo, hi]}


def k2_measure(msda_cuda, name: str, value, shapes, locs, attn) -> dict:
    """K2 on these inputs (on the card) against its plain version on the card
    and on the CPU, within 1e-5; its time, the plain version's, the bound and
    embedding_bag's time on the same corner rows."""
    shapes = [tuple(int(v) for v in s) for s in shapes]
    b, q, nh = locs.shape[:3]
    hd = value.shape[-1]
    out = msda_cuda.msda_sample_fused(value, shapes, locs, attn)
    torch.cuda.synchronize()
    ref = msda_cuda.msda_sample_fused_plain(value, shapes, locs, attn)
    ref_cpu = msda_cuda.msda_sample_fused_plain(value.cpu(), shapes, locs.cpu(), attn.cpu())
    max_abs_err = max(float((out - ref).abs().max()), float((out.cpu() - ref_cpu).abs().max()))
    if not (bool(torch.isfinite(out).all()) and max_abs_err <= 1e-5):
        raise AssertionError(f"K2 {name}: max abs error {max_abs_err} against the plain version")
    ms = cuda_ms(lambda: msda_cuda.msda_sample_fused(value, shapes, locs, attn), iters=50)
    plain_ms = cuda_ms(lambda: msda_cuda.msda_sample_fused_plain(value, shapes, locs, attn), iters=10)
    # bound: the distinct value rows (b, head, row) that corners inside the
    # maps touch, locs, attn and out once each, at the HBM rate; 2*hd
    # operations per such corner
    idx, w = msda_cuda.msda_flatten_coords(shapes, locs, attn)  # (B, nh, Q, S)
    v = value.shape[1]
    inside = w != 0
    b_idx = torch.arange(b, device=idx.device).view(b, 1, 1, 1)
    h_idx = torch.arange(nh, device=idx.device).view(1, nh, 1, 1)
    flat = (b_idx * v + idx.long()) * nh + h_idx  # rows of value viewed as (B*V*nh, hd)
    rows = int(torch.unique(flat[inside]).numel())
    nbytes = rows * hd * 4 + (locs.numel() + attn.numel() + out.numel()) * 4
    ops = 2 * hd * int(inside.sum())
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_FLOPS * 1e3
    info = {"size": name, "B": b, "nh": nh, "V": v, "hd": hd, "Q": q, "S": idx.shape[-1],
            "corners_outside": int((~inside).sum()), "max_abs_err": max_abs_err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes > t_ops else "operations", "bytes": nbytes,
            "distinct_value_rows": rows, "ops": ops}
    # the yardstick: one PyTorch call computing the gather-accumulate part on
    # the corner rows and weights that msda_flatten_coords made (not timed);
    # no single call computes the fused function. The port never calls it.
    flat_value = value.reshape(-1, hd)
    bags, bag_w = flat.reshape(-1, idx.shape[-1]), w.reshape(-1, idx.shape[-1])

    def library():
        return torch.nn.functional.embedding_bag(bags, flat_value, per_sample_weights=bag_w, mode="sum")

    lib_out = library().view(b, nh, q, hd).transpose(1, 2).reshape(b, q, nh * hd)
    info["library_max_abs_err"] = float((lib_out - out).abs().max())
    info["library_ms"] = cuda_ms(library, iters=50)
    info["library_covers"] = "the gather-accumulate on msda_flatten_coords' rows and weights"
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
                kernel_launches_per_image=prof["kernel_launches_per_call"] / len(imgs),
                compare_scalar_launches_per_image=prof["compare_scalar_launches_per_call"] / len(imgs),
                predict_profile=prof,
                device_fn_batch16_ms=ms16, device_fn_batch16_images_per_s=16 * 1e3 / ms16,
                card=card, nvidia_smi=smi)
    return model, batch, info


def rtdetr_parity(RTDETR, full_f32, model, batch):
    cpu_model = RTDETR("rtdetr-l.yaml", device="cpu", seed=0)
    for (k, a), b in zip(model.model.state_dict().items(), cpu_model.model.state_dict().values()):
        if not torch.equal(a.cpu(), b):
            raise AssertionError(f"seeded weights differ between devices at {k}")
    x = batch.cpu().flip(-1).permute(0, 3, 1, 2).float() / 255.0
    with torch.no_grad(), full_f32():  # the predictors' precision
        y_gpu, aux_gpu = model.model(x.cuda())
        y_cpu, aux_cpu = cpu_model.model(x)
    dec = cpu_model.model.model[-1]
    b, nq, nc, ndl = x.shape[0], dec.nq, dec.nc, len(dec.decoder.layers)
    want = {"enc_scores": (b, nq, nc), "enc_bboxes": (b, nq, 4), "dec_bboxes": (ndl, b, nq, 4),
            "dec_scores": (ndl, b, nq, nc), "topk_index": (b, nq)}
    shapes = {k: tuple(v.shape) for k, v in aux_gpu.items()}
    if any(shapes.get(k) != v for k, v in want.items()):
        raise AssertionError(f"aux shapes {shapes}, want {want} (the JAX decoder's keys)")
    score_err = float((aux_gpu["enc_scores_dense"].cpu() - aux_cpu["enc_scores_dense"]).abs().max())
    same = aux_gpu["topk_index"].cpu() == aux_cpu["topk_index"]
    n_diff = int((~same).sum())
    out_err = float(((y_gpu.cpu() - y_cpu).abs() * same[..., None]).max())
    # where an index differs, how far apart the CPU's best-class scores of the
    # two anchors are: a gap within the score error is a near-tie, not a fault
    best = aux_cpu["enc_scores_dense"].amax(-1)
    gaps = (best.gather(1, aux_gpu["topk_index"].cpu()) - best.gather(1, aux_cpu["topk_index"]))[~same]
    if not (score_err <= PARITY_TOL and out_err <= PARITY_TOL):
        raise AssertionError(f"card vs CPU: encoder scores {score_err}, outputs {out_err} "
                             f"(tolerance {PARITY_TOL}); {n_diff} top-k indices differ")
    return dict(batch=list(batch.shape), output_shape=list(y_cpu.shape), aux_shapes=shapes,
                max_abs_enc_score_err=score_err, topk_index_mismatch=n_diff,
                max_abs_score_gap_at_mismatch=float(gaps.abs().max()) if n_diff else None,
                max_abs_output_err_where_index_agrees=out_err, tolerance=PARITY_TOL,
                cpu_threads=torch.get_num_threads())


def parity_yolov8n(YOLO, yaml_model_load, ref: dict, device: str, stem: str = "val_parity",
                   model_yaml: str = "yolov8n.yaml"):
    """A yolov8n at the reference's nc (and the synthetic set's kpt_shape for
    pose) with the reference-trained weights of {stem}_model.npz."""
    fx = np.load(FIXTURES / f"{stem}_model.npz")
    y = yaml_model_load(model_yaml)
    y["nc"] = ref["dataset_args"]["nc"]
    if ref.get("task") == "pose":
        y["kpt_shape"] = [5, 3]
    model = YOLO(y, device=device)
    model.load_state_dict({k[4:]: fx[k] for k in fx.files if k.startswith("sd::")})
    return model


def val_fixture(YOLO, yaml_model_load, nms_cuda, tmp: Path, card: str, smi: str) -> dict:
    ref = json.loads((FIXTURES / "val_parity_ref.json").read_text())
    data = shutil.copytree(FIXTURES / "torch_val_synth", tmp / "fixture_set") / "data.yaml"
    va = ref["val_args"]
    kw = dict(imgsz=va["imgsz"], batch=8, conf=va["conf"], iou=va["iou"], max_det=va["max_det"])
    keys = ("metrics/precision(B)", "metrics/recall(B)", "metrics/mAP50(B)", "metrics/mAP50-95(B)")
    runs = {}
    for device in ("cuda", "cpu"):
        model = parity_yolov8n(YOLO, yaml_model_load, ref, device)
        nms_cuda.launches = 0
        t0 = time.perf_counter()
        m = model.val(data=str(data), **kw)
        runs[device] = {**{k: float(m.results_dict[k]) for k in keys}, "seconds": time.perf_counter() - t0,
                        "k1_launches": nms_cuda.launches}
    want = {k: ref["results"][k] for k in keys}
    card_minus_ref = {k: runs["cuda"][k] - want[k] for k in keys}
    card_minus_cpu = {k: runs["cuda"][k] - runs["cpu"][k] for k in keys}
    for k in keys[2:]:
        if not abs(card_minus_ref[k]) <= VAL_FIXTURE_TOL:
            raise AssertionError(f"card {k} {runs['cuda'][k]} is {card_minus_ref[k]} from the reference's "
                                 f"{want[k]} (tolerance {VAL_FIXTURE_TOL})")
    if runs["cuda"]["k1_launches"] != 2:
        raise AssertionError(f"K1 launched {runs['cuda']['k1_launches']} times for 2 batches")
    return dict(model="yolov8n (val_parity_model.npz)", data="tests/fixtures/torch_val_synth", val_args=kw,
                card_run=runs["cuda"], cpu_run=runs["cpu"], reference=want, card_minus_reference=card_minus_ref,
                card_minus_cpu=card_minus_cpu, tolerance=VAL_FIXTURE_TOL, card=card, nvidia_smi=smi)


def val_set_640(root: Path, src: str = "torch_val_synth", nc: int = 80, copies: int = VAL_COPIES) -> Path:
    """The val phases' data: a fixture set's images and labels `copies`
    times under new names (labels' classes 0-2 of nc names)."""
    src = FIXTURES / src
    for sub in ("images", "labels"):
        (root / sub / "val").mkdir(parents=True)
    for c in range(copies):
        for png in sorted((src / "images" / "val").glob("*.png")):
            shutil.copy(png, root / "images" / "val" / f"copy{c}_{png.name}")
            shutil.copy(src / "labels" / "val" / f"{png.stem}.txt", root / "labels" / "val" / f"copy{c}_{png.stem}.txt")
    names = "".join(f"  {i}: class{i}\n" for i in range(nc))
    (root / "data.yaml").write_text("val: images/val\nnames:\n" + names)
    return root / "data.yaml"


def val_path(YOLO, nms_cuda, ops_nms, tmp: Path, card: str, smi: str, model_name: str = "yolov8s",
             src: str = "torch_val_synth"):
    """model_name val at 640 on 128 images of the fixture set src. Returns the
    phase's line and what `capture_k1` recorded of the first batch in the
    warm-up call (K1's rows and the gather around it)."""
    data = val_set_640(tmp / f"{src}_640", src)
    kw = dict(data=str(data), imgsz=VAL_IMGSZ, batch=VAL_BATCH, conf=CONF, iou=0.7, max_det=300)
    model = YOLO(f"{model_name}.yaml", device="cuda", seed=0)

    with capture_k1(ops_nms) as cap:  # warm-up call: cuDNN, allocator, and the rows
        model.val(**kw)
    boxes, scores = cap["rows"]
    if tuple(scores.shape) != (VAL_BATCH, 30000) or not cap["k1_kwargs"].get("presorted"):
        raise AssertionError(f"K1's val rows {tuple(scores.shape)} ({cap['k1_kwargs']}), "
                             f"want presorted ({VAL_BATCH}, 30000)")

    n_images = VAL_COPIES * 16
    nms_cuda.launches = 0
    t0 = time.perf_counter()
    metrics = model.val(**kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = nms_cuda.launches
    n_batches = n_images // VAL_BATCH
    if launches != n_batches:
        raise AssertionError(f"K1 launched {launches} times for {n_batches} val batches")
    confs = metrics.stats["conf"]
    kept = [len(c) for c in confs]
    if len(confs) != n_images or any(not 0 < len(c) <= 300 or not np.isfinite(c).all() or c.min() <= CONF
                                     for c in confs):
        raise AssertionError(f"val kept {kept} detections for {n_images} images, want 1-300 above conf")
    prof = profile_window(lambda: model.val(**kw), reps=1, warmup=0, ops=("aten::sort",))
    busy = prof["device_busy_ms_per_call"]
    sort = prof["ops"].get("aten::sort", {})
    info = dict(model=model_name, nc=80, imgsz=VAL_IMGSZ, images=n_images, batch=VAL_BATCH, conf=CONF, iou=0.7,
                max_det=300, k1_launches=launches, k1_rows=list(scores.shape),
                kept_per_image={"min": min(kept), "median": float(np.median(kept)), "max": max(kept)},
                val_seconds=wall, images_per_s=n_images / wall,
                ms_per_image={k: v * 1e3 / n_images for k, v in metrics.speed.items()},
                map50=float(metrics.box.map50), device_busy_ms=busy,
                device_idle_share=None if busy is None else max(0.0, 1 - busy / (wall * 1e3)),
                k1_profiled_ms_per_launch=prof["device_ms_by_category"].get("k1_greedy_nms", 0.0) / n_batches,
                topk_sort_ms_per_batch=sort.get("device_ms_per_call", 0.0) / n_batches,
                topk_sort_calls_per_batch=sort.get("calls_per_call", 0.0) / n_batches,
                sort_kernels_ms_per_batch=prof["device_ms_by_category"].get("sort", 0.0) / n_batches,
                val_profile=prof, card=card, nvidia_smi=smi)
    if hasattr(metrics, "seg"):
        info["mask_map50"] = float(metrics.seg.map50)
    return info, cap


def val_k1(nms_cuda, rows, card: str, smi: str, max_det: int = 300, iou: float = 0.7) -> dict:
    """K1 on a path's real rows: bit for bit against the plain version,
    timed, the bound recounted on them, and the candidates each row scans."""
    boxes, scores = rows
    mismatch, max_abs_err, sboxes, sscores, (keep, valid) = k1_compare(nms_cuda, boxes, scores, max_det, iou)
    if mismatch or max_abs_err:
        raise AssertionError(f"K1 on captured rows: {mismatch} entries differ from the plain version "
                             f"(max abs error {max_abs_err})")
    ms = cuda_ms(lambda: nms_cuda.greedy_nms(sboxes, sscores, max_det, iou, presorted=True), iters=50)
    plain_ms = cuda_ms(lambda: nms_cuda.greedy_nms_plain(sboxes, sscores, max_det, iou), iters=3, warmup=1)
    bound = k1_bound(sboxes.cpu().numpy(), sscores.cpu().numpy(), keep, valid, max_det, iou)
    reads = bound.pop("read_per_row")
    scanned = {"min": int(np.min(reads)), "median": float(np.median(reads)), "max": int(np.max(reads))}
    return dict(B=int(scores.shape[0]), K=int(scores.shape[1]), max_mismatch=mismatch, max_abs_err=max_abs_err,
                kept_per_row=valid.sum(1).tolist(), ms=ms, plain_ms=plain_ms, **bound,
                scanned_per_row=scanned, card=card, nvidia_smi=smi)


def captured_k1(ops_nms, nms_cuda, cap, card: str, smi: str) -> dict:
    """val_k1 on the captured rows, and the captured NMS outputs (the payload
    among them) against the plain path's; raises if any entry differs."""
    k = cap["k1_kwargs"]
    info = val_k1(nms_cuda, cap["rows"], card, smi, k["max_det"], k["iou_thres"])
    info["gather_mismatch_vs_plain"] = gather_mismatch(ops_nms, nms_cuda, cap)
    info["payload_width"] = int(cap["gather_out"]["extra"].shape[-1]) if "extra" in cap["gather_out"] else 0
    if info["gather_mismatch_vs_plain"]:
        raise AssertionError(f"{info['gather_mismatch_vs_plain']} NMS output entries differ from the plain path's")
    return info


def fixture_train_set(root: Path, n_images: int = 0, src: str = "torch_val_synth") -> Path:
    """A fixture set's images and labels (the first n_images of them, or
    all) under root/images/train, with a data YAML whose train and val are
    both that directory, the set's 3 class names, and the pose set's
    kpt_shape [5, 3]."""
    kpt = "kpt_shape: [5, 3]\n" if src.endswith("_pose") else ""
    src = FIXTURES / src
    pngs = sorted((src / "images" / "val").glob("*.png"))
    for sub in ("images", "labels"):
        (root / sub / "train").mkdir(parents=True)
    for png in pngs[:n_images or None]:
        shutil.copy(png, root / "images" / "train")
        shutil.copy(src / "labels" / "val" / f"{png.stem}.txt", root / "labels" / "train")
    names = "".join(f"  {i}: shape{i}\n" for i in range(3))
    (root / "data.yaml").write_text("train: images/train\nval: images/train\n" + kpt + "names:\n" + names)
    return root / "data.yaml"


def tree_leaves(tree, path=()):
    for k, v in tree.items():
        yield from tree_leaves(v, (*path, k)) if isinstance(v, dict) else [("/".join((*path, k)), np.asarray(v))]


def max_rel_tree_diff(got: dict, want: dict):
    """The largest max|got - want| / max|want| over the tensors of two flax
    trees, and the tensor where it is."""
    want = dict(tree_leaves(want))
    got = dict(tree_leaves(got))
    if got.keys() != want.keys():
        raise AssertionError(f"checkpoint trees differ in keys: {sorted(set(got) ^ set(want))[:5]}")
    return max((float(np.abs(got[k] - w).max() / max(np.abs(w).max(), 1e-12)), k) for k, w in want.items())


def train_one_step(YOLO, yaml_model_load, load_pickle, data: Path, project: Path, device: str,
                   task: str = "detect", val: bool = False):
    """One optimizer step of a task's reference-trained yolov8n through
    YOLO(...).train: 8 images, batch 8, nbs 8, no warmup, the epoch-end val
    when val. Returns the loss parts, the last.ckpt dict, the optimizer steps
    taken and the facade."""
    stem, model_yaml = (TASKS[task]["stem"], TASKS[task]["fixture_yaml"]) if task in TASKS else \
        ("val_parity", "yolov8n.yaml")
    ref = json.loads((FIXTURES / f"{stem}_ref.json").read_text())
    model = parity_yolov8n(YOLO, yaml_model_load, ref, device, stem, model_yaml)
    model.train(data=str(data), epochs=1, imgsz=160, batch=TRAIN_PARITY_IMAGES, nbs=TRAIN_PARITY_IMAGES,
                warmup_epochs=0.0, val=val, workers=4, max_gt=32, project=str(project))
    tr = model.trainer
    return tr.loss_history[0], load_pickle(tr.wdir / "last.ckpt"), tr.opt_steps, model


def one_step_diffs(card_run, cpu_run) -> dict:
    """The largest relative differences of two train_one_step runs; raises
    beyond TRAIN_PARITY_TOL."""
    (lc, cc, sc, _), (lh, ch, sh, _) = card_run, cpu_run
    if sc != sh or sc != 1:
        raise AssertionError(f"optimizer steps: card {sc}, CPU {sh}, want 1")
    diffs = {f"loss_{k}": abs(lc[k] - lh[k]) / abs(lh[k]) for k in lh}
    where = {}
    for key in ("params", "momentum_buffer", "ema", "batch_stats"):
        diffs[key], where[key] = max_rel_tree_diff(cc[key], ch[key])
    bad = {k: v for k, v in diffs.items() if not v <= TRAIN_PARITY_TOL["loss" if k.startswith("loss") else k]}
    if bad:
        raise AssertionError(f"card vs CPU after one step beyond {TRAIN_PARITY_TOL}: {bad} (at {where})")
    return {"loss_card": lc, "loss_cpu": lh, "max_rel_diff": diffs, "at": where, "tolerance": TRAIN_PARITY_TOL,
            "ema_updates": [cc["ema_updates"], ch["ema_updates"]]}


def train_parity_diffs(YOLO, yaml_model_load, load_pickle, root: Path) -> dict:
    """The one-step run on the card and on the CPU, and their largest
    relative differences; raises beyond TRAIN_PARITY_TOL."""
    data = fixture_train_set(root / "set", TRAIN_PARITY_IMAGES)
    return one_step_diffs(*(train_one_step(YOLO, yaml_model_load, load_pickle, data, root / d, d)
                            for d in ("cuda", "cpu")))


def train_parity(YOLO, yaml_model_load, load_pickle, tmp: Path, card: str, smi: str) -> dict:
    info = train_parity_diffs(YOLO, yaml_model_load, load_pickle, tmp / "train_parity")
    return dict(model="yolov8n (val_parity_model.npz)", images=TRAIN_PARITY_IMAGES, imgsz=160,
                batch=TRAIN_PARITY_IMAGES, nbs=TRAIN_PARITY_IMAGES, warmup_epochs=0.0, **info,
                cpu_threads=torch.get_num_threads(), card=card, nvidia_smi=smi)


def task_train_parity(YOLO, yaml_model_load, load_pickle, nms_cuda, ops_nms, task: str, tmp: Path, card: str,
                      smi: str) -> dict:
    """train_parity for segment, pose or obb, with the epoch-end val: one
    step of the task's reference-trained yolov8n on 8 of its fixture images
    on the card and on the CPU, held within TRAIN_PARITY_TOL. K1's launches
    (segment, pose: one a val) or the rotated NMS's calls (obb) are read
    around the card's run; segment's and pose's first K1 rows there are
    captured and held bit for bit to the plain version, timed, with the
    bound (captured_k1), and K1's device ms a launch read from a profile of
    one more val call of the trained model."""
    from ultralytics_pro_tpu_torch.engine import validator as eng_val

    spec = TASKS[task]
    root = tmp / f"{task}_train_parity"
    data = fixture_train_set(root / "set", TRAIN_PARITY_IMAGES, spec["set"])
    nms_cuda.launches = 0
    with capture_k1(ops_nms) as cap, capture_rotated(eng_val) as rot:
        card_run = train_one_step(YOLO, yaml_model_load, load_pickle, data, root / "cuda", "cuda", task, val=True)
    launches, rotated = nms_cuda.launches, rot["calls"]
    cpu_run = train_one_step(YOLO, yaml_model_load, load_pickle, data, root / "cpu", "cpu", task, val=True)
    info = one_step_diffs(card_run, cpu_run)
    want = (0, 1) if task == "obb" else (1, 0)  # one val batch of 8 images
    if (launches, rotated) != want:
        raise AssertionError(f"{task} train val: K1 launched {launches} times, the rotated NMS called {rotated} "
                             f"times; want {want}")
    fitness = [run[3].trainer.last_fitness for run in (card_run, cpu_run)]
    if any(f is None for f in fitness):
        raise AssertionError(f"{task} train val gave fitness {fitness}")
    info.update(model=f"{spec['fixture_yaml'][:-5]} ({spec['stem']}_model.npz)", images=TRAIN_PARITY_IMAGES,
                imgsz=160, batch=TRAIN_PARITY_IMAGES, nbs=TRAIN_PARITY_IMAGES, warmup_epochs=0.0,
                fitness_card_cpu=fitness, k1_launches=launches, rotated_nms_calls=rotated,
                cpu_threads=torch.get_num_threads(), card=card, nvidia_smi=smi)
    if task != "obb":
        tr = card_run[3].trainer
        vprof = profile_window(lambda: tr.val_fn(tr.model), reps=1, warmup=1)
        info["k1_profiled_ms_per_launch"] = vprof["device_ms_by_category"].get("k1_greedy_nms", 0.0)
        info["k1_on_val_rows"] = captured_k1(ops_nms, nms_cuda, cap, card, smi)
    return info


def results_csv(save_dir: Path):
    """results.csv's rows as dicts (fitness '' when val gave None)."""
    rows = (save_dir / "results.csv").read_text().splitlines()
    keys = rows[0].split(",")
    return [dict(zip(keys, r.split(","))) for r in rows[1:]]


def fitness_values(save_dir: Path, epochs: int):
    """Every epoch's fitness as a float; raises when an epoch's is missing
    (a val that failed, which the facade logs and trains past)."""
    fits = [r["metrics/fitness"] for r in results_csv(save_dir)]
    if len(fits) != epochs or any(f in ("", "None") for f in fits):
        raise AssertionError(f"epoch fitness {fits}: a val failed or an epoch is missing")
    return [float(f) for f in fits]


def train_overfit(YOLO, nms_cuda, tmp: Path, card: str, smi: str) -> dict:
    data = fixture_train_set(tmp / "overfit_set")
    epochs = 30
    model = YOLO("yolov8n.yaml", device="cuda", seed=0)
    nms_cuda.launches = 0
    t0 = time.perf_counter()
    model.train(data=str(data), epochs=epochs, imgsz=128, batch=8, nbs=8, workers=8, val=True, close_mosaic=0,
                max_gt=32, warmup_epochs=1.0, lr0=0.01, project=str(tmp / "overfit"))
    seconds = time.perf_counter() - t0
    tr = model.trainer
    hist = tr.loss_history
    total = [sum(e.values()) for e in hist]
    box = [e["box"] for e in hist]
    first, last = float(np.mean(total[:3])), float(np.mean(total[-3:]))
    fits = fitness_values(tr.save_dir, epochs)
    if not (len(hist) == epochs and np.isfinite(total).all() and last < 0.75 * first
            and np.mean(box[-3:]) < np.mean(box[:3])):
        raise AssertionError(f"no convergence: total first {first}, last {last}; box {box}")
    if nms_cuda.launches != 2 * epochs:
        raise AssertionError(f"K1 launched {nms_cuda.launches} times in {epochs} vals of 2 batches")
    m = model.val(data=str(data), imgsz=128, batch=8)
    return dict(model="yolov8n (nc 80 -> 3, seed 0)", epochs=epochs, imgsz=128, batch=8, nbs=8, images=16,
                train_seconds=seconds, opt_steps=tr.opt_steps, first3_mean_total=first, last3_mean_total=last,
                ratio=last / first, box_first3=float(np.mean(box[:3])), box_last3=float(np.mean(box[-3:])),
                total_per_epoch=total, fitness_per_epoch=fits, k1_launches=nms_cuda.launches,
                final_ema_map50=float(m.box.map50), final_ema_map50_95=float(m.box.map), card=card,
                nvidia_smi=smi)


def conv_flops_per_image(model, imgsz: int) -> float:
    """2 x multiply-adds of every Conv2d of one forward at imgsz (the head's
    convolutions included), from the maps a forward produces."""
    flops = []

    def hook(m, inp, out):
        k = m.weight.shape[1] * m.weight.shape[2] * m.weight.shape[3]  # (c_in / groups) * kh * kw
        flops.append(2.0 * out.numel() * k / out.shape[0])

    handles = [m.register_forward_hook(hook) for m in model.modules() if isinstance(m, torch.nn.Conv2d)]
    try:
        with torch.no_grad():
            model.eval()(torch.zeros(1, 3, imgsz, imgsz, device=next(model.parameters()).device))
    finally:
        for h in handles:
            h.remove()
    return sum(flops)


def detached(x, grad: bool = False):
    """A model's train-mode output (a list of maps, or a dict of them and
    tensors) detached; as new leaves that require grad with grad=True."""
    if isinstance(x, dict):
        return {k: detached(v, grad) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [detached(v, grad) for v in x]
    return x.detach().clone().requires_grad_(True) if grad and x.is_floating_point() else x.detach()


def train_run(YOLO, nms_cuda, tmp: Path, task: str = "detect") -> tuple:
    """Two epochs of the task's served model at full width (yolov8s,
    yolov8s-seg and yolov8s-pose at 640, yolov8s-obb at 1024), batch 16
    and the JAX defaults otherwise (nbs 64, warmup 3 epochs, val=True), on
    128 images of the task's fixture set (train = val; 80 class names for
    detect and segment, DOTA's 15 for obb, the set's 3 and [5, 3] keypoints
    for pose); the model is rebuilt at the set's nc (and pose's shape). K1's
    launches (or the rotated NMS's calls, obb) are counted over the run;
    raises unless there is one a val batch, on a non-finite loss or a None
    fitness. Returns the trainer, its data YAML and the run's numbers."""
    from ultralytics_pro_tpu_torch.engine import validator as eng_val

    served, src, nc, imgsz = {"detect": ("yolov8s", "torch_val_synth", 80, TRAIN_IMGSZ),
                              "segment": ("yolov8s-seg", "torch_val_synth_segment", 80, TRAIN_IMGSZ),
                              "pose": ("yolov8s-pose", "torch_val_synth_pose", 3, TRAIN_IMGSZ),
                              "obb": ("yolov8s-obb", "torch_val_synth_obb", 15, OBB_IMGSZ)}[task]
    data = val_set_640(tmp / f"train_{task}_set", src, nc=nc)
    kpt = "kpt_shape: [5, 3]\n" if task == "pose" else ""
    data.write_text(data.read_text().replace("val: images/val", "train: images/val\nval: images/val\n" + kpt))
    model = YOLO(f"{served}.yaml", device="cuda", seed=0)
    torch.cuda.reset_peak_memory_stats()
    nms_cuda.launches = 0
    t0 = time.perf_counter()
    with capture_rotated(eng_val) as rot:
        model.train(data=str(data), epochs=TRAIN_EPOCHS, imgsz=imgsz, batch=TRAIN_BATCH,
                    project=str(tmp / f"train_{task}"))
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    tr = model.trainer
    nb = VAL_COPIES * 16 // TRAIN_BATCH
    if not all(np.isfinite(v) for e in tr.loss_history for v in e.values()) or len(tr.loss_history) != TRAIN_EPOCHS:
        raise AssertionError(f"loss history {tr.loss_history}")
    counts = {"k1_launches": nms_cuda.launches, "rotated_nms_calls": rot["calls"]}
    want = {"k1_launches": 0 if task == "obb" else TRAIN_EPOCHS * nb,
            "rotated_nms_calls": TRAIN_EPOCHS * nb if task == "obb" else 0}
    if counts != want:
        raise AssertionError(f"{task} train: {counts} in {TRAIN_EPOCHS} vals of {nb} batches, want {want}")
    head = tr.model.model[-1]
    return tr, data, dict(model=served, nc=tr.model.nc, kpt_shape=getattr(head, "kpt_shape", None), imgsz=imgsz,
                          batch=TRAIN_BATCH, nbs=tr.nbs, accumulate=tr.accumulate, warmup_epochs=tr.warmup_epochs,
                          epochs=TRAIN_EPOCHS, images=VAL_COPIES * 16, micro_batches_per_epoch=nb,
                          opt_steps=tr.opt_steps, train_seconds=seconds,
                          epoch_train_seconds=tr.epoch_train_seconds,
                          train_images_per_s_epoch2=nb * TRAIN_BATCH / tr.epoch_train_seconds[-1],
                          wall_ms_per_micro_batch_epoch2=tr.epoch_train_seconds[-1] * 1e3 / nb,
                          max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
                          loss_history=tr.loss_history, fitness_per_epoch=fitness_values(tr.save_dir, TRAIN_EPOCHS),
                          **counts)


def det_host_batch(tr, data: Path, imgsz: int) -> dict:
    """The first batch of TRAIN_BATCH images of a detection train set, as the loader collates it."""
    from ultralytics_pro_tpu_torch.data import DataLoader, YOLODataset, check_det_dataset

    d = check_det_dataset(str(data))
    return next(iter(DataLoader(YOLODataset(d["train"], imgsz=imgsz, data=d, task=tr.model.task),
                                batch_size=TRAIN_BATCH, workers=8, max_gt=int(tr.args.get("max_gt", 128)))))


def micro_batch_measures(tr, host: dict, imgsz: int) -> dict:
    """On the trained model (its parameters change; nothing here is checked
    against the run): the device ms of a micro-batch's forward, loss and
    backward (CUDA events), one profiled micro-batch with its optimizer step
    as the loop runs it (idle share against the epoch's wall ms a
    micro-batch, device ms by category, launches), the criterion alone
    (assignment and loss, forward and backward to the head's outputs) in a
    profile, and the model's conv FLOPs a step against the f32 peak."""
    from ultralytics_pro_tpu_torch.utils import full_f32

    dev = tr.put_batch(host)
    lrs, mom = [tr.lr0] * 3, tr.momentum
    tr.model.train()
    ms_micro = cuda_ms(lambda: tr.step(dev, lrs, mom, False), iters=5)

    def loop_micro():  # as the loop runs one: host batch up, step, the loss parts pulled
        _, parts = tr.step(tr.put_batch(host), lrs, mom, True)
        return torch.stack(list(parts.values())).tolist()

    prof = profile_window(loop_micro, reps=3, top=25)
    with torch.no_grad(), full_f32():
        out = detached(tr.model_outputs(dev))

    def criterion():  # the criterion (assignment included) and its backward to the head's outputs
        with full_f32():
            total, _ = tr.criterion(detached(out, grad=True), dev, dev["img"].shape[2:])
            total.backward()

    lprof = profile_window(criterion, reps=3)  # device time: its many small launches pace CUDA events
    tr.model.eval()
    flops_fwd = conv_flops_per_image(tr.model, imgsz)
    step_flops = 3 * flops_fwd * TRAIN_BATCH
    bound_ms = step_flops / F32_FLOPS * 1e3
    busy = prof["device_busy_ms_per_call"]
    wall_micro_ms = tr.epoch_train_seconds[-1] * 1e3 / (VAL_COPIES * 16 // TRAIN_BATCH)
    return dict(device_ms_per_micro_batch=ms_micro,
                device_ms_per_optimizer_step=prof["device_ms_by_category"].get("optimizer", 0.0),
                device_ms_loss_and_tal_with_backward=lprof["device_busy_ms_per_call"],
                loss_and_tal_launches=lprof["kernel_launches_per_call"],
                loss_and_tal_by_category=lprof["device_ms_by_category"],
                conv_gflops_forward_per_image=flops_fwd / 1e9, step_tflops=step_flops / 1e12,
                step_f32_bound_ms=bound_ms, step_flop_share=bound_ms / ms_micro,
                device_idle_share_epoch2=None if busy is None else max(0.0, 1 - busy / wall_micro_ms),
                micro_batch_profile=prof)


def train_path(YOLO, nms_cuda, ops_nms, tmp: Path, card: str, smi: str) -> dict:
    """yolov8s train at 640 (train_run, micro_batch_measures). K1's rows of
    the epoch-end val are captured from one more val call on the trained
    model and held to the plain version (val_k1)."""
    tr, data, info = train_run(YOLO, nms_cuda, tmp)
    info.update(micro_batch_measures(tr, det_host_batch(tr, data, TRAIN_IMGSZ), TRAIN_IMGSZ))
    nb = info["micro_batches_per_epoch"]
    vprof = profile_window(lambda: tr.val_fn(tr.model), reps=1, warmup=0)
    with capture_k1(ops_nms) as cap:
        tr.val_fn(tr.model)
    info.update(k1_profiled_ms_per_launch=vprof["device_ms_by_category"].get("k1_greedy_nms", 0.0) / nb,
                k1_on_val_rows=val_k1(nms_cuda, cap["rows"], card, smi),
                val_device_busy_ms=vprof["device_busy_ms_per_call"], card=card, nvidia_smi=smi)
    return info


def task_train_path(YOLO, nms_cuda, task: str, tmp: Path, card: str, smi: str) -> dict:
    """Phases seg_train, pose_train, obb_train: train_run and
    micro_batch_measures for the task, and the device ms of one more
    epoch-end val of the trained model (K1's, or the rotated NMS's, among it)."""
    tr, data, info = train_run(YOLO, nms_cuda, tmp, task)
    imgsz = info["imgsz"]
    info.update(micro_batch_measures(tr, det_host_batch(tr, data, imgsz), imgsz))
    nb = info["micro_batches_per_epoch"]
    vprof = profile_window(lambda: tr.val_fn(tr.model), reps=1, warmup=0,
                           scope=ROTATED_NMS_SCOPE if task == "obb" else None)
    nms = category("", ROTATED_NMS_SCOPE) if task == "obb" else "k1_greedy_nms"
    info.update(val_device_busy_ms=vprof["device_busy_ms_per_call"],
                nms_profiled_ms_per_val_batch=vprof["device_ms_by_category"].get(nms, 0.0) / nb,
                card=card, nvidia_smi=smi)
    return info


def metric(m, attr: str) -> float:
    """A metric by dotted name: metric(m, "seg.map50")."""
    for part in attr.split("."):
        m = getattr(m, part)
    return float(m)


def task_fixture(YOLO, yaml_model_load, nms_cuda, task: str, tmp: Path, card: str, smi: str) -> dict:
    """The reference-trained fixture model of a task on its committed set, on
    the card and on the CPU; raises beyond TASK_FIXTURE_TOL (card vs CPU) or
    VAL_FIXTURE_TOL (card vs the reference), or when the card's val does not
    launch K1 or call the rotated NMS as often as the task's spec says."""
    from ultralytics_pro_tpu_torch.engine import validator as eng_val

    spec = TASKS[task]
    ref = json.loads((FIXTURES / f"{spec['stem']}_ref.json").read_text())
    data = shutil.copytree(FIXTURES / spec["set"], tmp / f"{task}_fixture_set") / "data.yaml"
    va = ref["val_args"]
    kw = dict(imgsz=va["imgsz"], batch=8, conf=va["conf"], iou=va["iou"], max_det=va["max_det"])
    runs = {}
    for device in ("cuda", "cpu"):
        model = parity_yolov8n(YOLO, yaml_model_load, ref, device, spec["stem"], spec["fixture_yaml"])
        nms_cuda.launches = 0
        t0 = time.perf_counter()
        with capture_rotated(eng_val) as rot:
            m = model.val(data=str(data), **kw)
        runs[device] = {**{a: metric(m, a) for a, _ in spec["maps"]}, "seconds": time.perf_counter() - t0,
                        "k1_launches": nms_cuda.launches, "rotated_nms_calls": rot["calls"]}
    want = {a: ref["results"][key] for a, key in spec["maps"]}
    card_minus_cpu = {a: runs["cuda"][a] - runs["cpu"][a] for a in want}
    card_minus_ref = {a: runs["cuda"][a] - want[a] for a in want}
    bad = {a: (card_minus_cpu[a], card_minus_ref[a]) for a in want
           if not (abs(card_minus_cpu[a]) <= TASK_FIXTURE_TOL and abs(card_minus_ref[a]) <= VAL_FIXTURE_TOL)}
    if bad:
        raise AssertionError(f"{task} fixture mAPs (card - CPU, card - reference) beyond "
                             f"({TASK_FIXTURE_TOL}, {VAL_FIXTURE_TOL}): {bad}")
    counts = (runs["cuda"]["k1_launches"], runs["cuda"]["rotated_nms_calls"])
    if counts != (spec["fixture_k1"], spec["fixture_rotated"]):
        raise AssertionError(f"{task}: K1 launched and the rotated NMS called {counts} times for 2 batches, "
                             f"want {(spec['fixture_k1'], spec['fixture_rotated'])}")
    return dict(model=f"{spec['fixture_yaml']} ({spec['stem']}_model.npz)", data=f"tests/fixtures/{spec['set']}",
                val_args=kw, card_run=runs["cuda"], cpu_run=runs["cpu"], reference=want,
                card_minus_cpu=card_minus_cpu, card_minus_reference=card_minus_ref,
                tolerance={"card_vs_cpu": TASK_FIXTURE_TOL, "card_vs_reference": VAL_FIXTURE_TOL},
                card=card, nvidia_smi=smi)


def check_task_results(task: str, results, imgs, model) -> list:
    """Each image's detections finite and in number 1-300, with masks (bool,
    the image's size) or keypoints (finite, kpt_shape); returns the
    detection counts."""
    dets = []
    for r, im in zip(results, imgs):
        n = len(r)
        if not 0 < n <= 300 or not np.isfinite(r.boxes.data).all():
            raise AssertionError(f"{task}: {n} detections, finite: {np.isfinite(r.boxes.data).all()}")
        if task == "segment":
            m = r.masks.data
            if m.dtype != bool or m.shape != (n, *im.shape[:2]):
                raise AssertionError(f"masks {m.dtype} {m.shape} for {n} boxes on {im.shape}")
        else:
            k = r.keypoints.data
            if k.shape != (n, *model.model.model[-1].kpt_shape) or not np.isfinite(k).all():
                raise AssertionError(f"keypoints {k.shape} for {n} boxes")
        dets.append(n)
    return dets


def task_predict(YOLO, nms_cuda, ops_nms, task: str, card: str, smi: str) -> dict:
    """yolov8s-seg or yolov8s-pose predict at 640 on the 4 seeded images."""
    from ultralytics_pro_tpu_torch.ops.boxes import scale_boxes
    from ultralytics_pro_tpu_torch.ops.masks import process_mask_native
    from ultralytics_pro_tpu_torch.utils import full_f32

    spec = TASKS[task]
    imgs = seeded_images()
    model = YOLO(f"{spec['served']}.yaml", device="cuda", seed=0)
    n_params = sum(p.numel() for p in model.model.parameters())
    model.predict(imgs[:1], conf=CONF)  # first call: cuDNN and allocator set-up
    torch.cuda.synchronize()

    nms_cuda.launches = 0
    results = model.predict(imgs, conf=CONF)
    torch.cuda.synchronize()
    launches = nms_cuda.launches
    if launches != len(imgs):
        raise AssertionError(f"K1 launched {launches} times for {len(imgs)} images")
    dets = check_task_results(task, results, imgs, model)

    per_image = []
    for _ in range(TASK_CALLS):
        t0 = time.perf_counter()
        model.predict(imgs, conf=CONF)
        per_image.append((time.perf_counter() - t0) * 1e3 / len(imgs))
    q = np.percentile(per_image, [0, 10, 50, 90, 100])
    prof = profile_window(lambda: model.predict(imgs, conf=CONF), TASK_PROFILED_CALLS)
    call_ms = q[2] * len(imgs)
    busy = prof["device_busy_ms_per_call"]

    pred = model.predictor
    batch = pred.preprocess(imgs)
    ms16 = cuda_ms(lambda: pred.run(batch.repeat(4, 1, 1, 1)), iters=5)
    with capture_k1(ops_nms) as cap:  # one batch of the 4 images: K1's rows and the payload's gather
        pred.run(batch)
    info = dict(model=spec["served"], parameters=n_params, nc=model.model.nc, imgsz=640,
                images=[list(sh) for sh in IMAGE_SHAPES], conf=CONF, k1_launches=launches, detections=dets,
                predict_calls=TASK_CALLS,
                predict_ms_per_image={"median": q[2], "p10": q[1], "p90": q[3], "min": q[0], "max": q[4]},
                predict_median_ms_per_call=call_ms,
                device_idle_share=None if busy is None else max(0.0, 1 - busy / call_ms),
                kernel_launches_per_image=prof["kernel_launches_per_call"] / len(imgs),
                k1_profiled_ms_per_launch=prof["device_ms_by_category"].get("k1_greedy_nms", 0.0) / len(imgs),
                memcpy_device_ms_per_image=prof["device_ms_by_category"].get("memcpy", 0.0) / len(imgs),
                predict_profile=prof, device_fn_batch16_ms=ms16, device_fn_batch16_images_per_s=16 * 1e3 / ms16,
                k1_on_batch_rows=captured_k1(ops_nms, nms_cuda, cap, card, smi), card=card, nvidia_smi=smi)
    if task == "pose":
        info["kpt_shape"] = list(model.model.model[-1].kpt_shape)
        return info
    # segment: device ms of the mask step of each image (its 300 detections)
    # against the forward's, both at batch 1 as predict runs them, from the
    # profiler (CUDA events around batch-1 calls measure the host's launch
    # rate); and the step's mask probabilities against the same step on the CPU
    fwd, masks, errs, edge = [], [], [], []
    for i, im in enumerate(imgs):
        x1 = batch[i:i + 1]
        out = pred.run(x1)
        n = int(out["valid"][0].sum())
        args = (out["protos"][0], out["extra"][0][:n],
                scale_boxes(tuple(x1.shape[1:3]), out["boxes"][0][:n], im.shape[:2]), im.shape[:2])

        def mask_step():
            with full_f32():
                return process_mask_native(*args) > 0.5

        masks.append(profile_window(mask_step, reps=3)["device_busy_ms_per_call"])
        with full_f32():
            prob = process_mask_native(*args).cpu()
        ref = process_mask_native(*(a.cpu() if torch.is_tensor(a) else a for a in args))
        errs.append(float((prob - ref).abs().max()))
        edge.append(float(((prob > 0.5) != (ref > 0.5)).float().mean()))
        xf = x1.flip(-1).permute(0, 3, 1, 2).float() / 255.0
        with torch.no_grad(), full_f32():
            fwd.append(profile_window(lambda: model.model(xf), reps=3)["device_busy_ms_per_call"])
    if max(errs) > MASK_TOL or max(edge) > MASK_EDGE_SHARE:
        raise AssertionError(f"mask step on the card vs the CPU: max abs error {errs}, pixels that flip {edge}")
    info.update(mask_step_device_ms_per_image=masks, forward_device_ms_per_image=fwd,
                mask_step_over_forward=float(np.sum(masks) / np.sum(fwd)),
                mask_step_card_vs_cpu={"max_abs_err": errs, "flipped_share": edge,
                                       "tolerance": [MASK_TOL, MASK_EDGE_SHARE]},
                mask_pixels_set_share=[float(r.masks.data.mean()) for r in results])
    return info


def check_obb_results(results) -> list:
    """Each image's oriented boxes finite and in number 1-300, with (n, 4, 2)
    corners; returns the counts."""
    dets = []
    for r in results:
        n = len(r.obb) if r.obb is not None else 0
        if not 0 < n <= 300 or not np.isfinite(r.obb.data).all() or r.obb.xyxyxyxy.shape != (n, 4, 2):
            raise AssertionError(f"obb: {n} rboxes, finite {np.isfinite(r.obb.data).all() if n else None}")
        dets.append(n)
    return dets


def obb_decoded(model, img_u8):
    """yolov8s-obb's decoded rows of a letterboxed uint8 batch, as the
    predictor's and validator's run split them: (rboxes (B, A, 5), scores (B, A, nc))."""
    from ultralytics_pro_tpu_torch.engine.predictor import rgb01
    from ultralytics_pro_tpu_torch.utils import full_f32

    nc = model.model.nc
    with torch.no_grad(), full_f32():
        y, _ = model.model(rgb01(img_u8))
    return torch.cat([y[..., :4], y[..., 4 + nc:5 + nc]], -1), y[..., 4:4 + nc]


def rotated_nms_alone(ops_nms, rboxes, scores, iou: float) -> dict:
    """The rotated NMS on one set of decoded rows, alone: device ms by CUDA
    events (the launches queued behind a sleep kernel), busy ms and launches
    from a profiled window, and peak memory above what was allocated before."""
    kw = dict(conf_thres=CONF, iou_thres=iou, max_det=300, max_nms=OBB_MAX_NMS)
    fn = lambda: ops_nms.non_max_suppression_rotated(rboxes, scores, **kw)  # noqa: E731
    ms = cuda_ms(fn, iters=3)
    prof = profile_window(fn, reps=3, scope=ROTATED_NMS_SCOPE)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    return {"B": rboxes.shape[0], "A": rboxes.shape[1], "K": min(OBB_MAX_NMS, rboxes.shape[1]),
            "kept": out["valid"].sum(1).tolist(), "cuda_event_ms": ms,
            "device_busy_ms": prof["device_busy_ms_per_call"], "launches": prof["kernel_launches_per_call"],
            "device_ms_by_category": prof["scope"] and prof["scope"].get("device_ms_by_category"),
            "peak_memory_bytes": peak, "top_kernels": prof["top_kernels"][:6]}


def obb_parity(YOLO, ops_nms, model, img_u8) -> dict:
    """One image's decoded outputs on the card and on the CPU (same weights):
    largest differences of xywh, scores and angle, within OBB_PARITY_TOL; and
    the rotated NMS on the CPU's outputs on both devices: the same
    candidates kept (rboxes, scores, cls and valid equal)."""
    cpu = YOLO(model.model.yaml, device="cpu")
    cpu.model.load_state_dict({k: v.cpu() for k, v in model.model.state_dict().items()})
    nc = model.model.nc
    rb_c, sc_c = obb_decoded(model, img_u8)
    rb_h, sc_h = obb_decoded(cpu, img_u8.cpu())
    diff = {"xywh_px": float((rb_c[..., :4].cpu() - rb_h[..., :4]).abs().max()),
            "scores": float((sc_c.cpu() - sc_h).abs().max()),
            "angle_rad": float((rb_c[..., 4].cpu() - rb_h[..., 4]).abs().max())}
    bad = {k: v for k, v in diff.items() if not v <= OBB_PARITY_TOL[k]}
    kw = dict(conf_thres=CONF, iou_thres=0.7, max_det=300, max_nms=OBB_MAX_NMS)
    on_card = ops_nms.non_max_suppression_rotated(rb_h.cuda(), sc_h.cuda(), **kw)
    on_cpu = ops_nms.non_max_suppression_rotated(rb_h, sc_h, **kw)
    differ = {k: int((on_card[k].cpu() != on_cpu[k]).sum()) for k in on_cpu}
    if bad or any(differ.values()):
        raise AssertionError(f"obb card vs CPU: decoded outputs beyond {OBB_PARITY_TOL}: {bad}; "
                             f"NMS entries that differ: {differ}")
    return {"nc": nc, "max_abs_diff": diff, "tolerance": OBB_PARITY_TOL, "nms_entries_that_differ": differ,
            "kept": int(on_cpu["valid"].sum())}


def obb_predict(YOLO, nms_cuda, ops_nms, card: str, smi: str) -> dict:
    """yolov8s-obb predict at 1024 on the 4 seeded images (phase obb)."""
    from ultralytics_pro_tpu_torch.engine import predictor as eng_pred

    imgs = seeded_images()
    kw = dict(imgsz=OBB_IMGSZ, conf=CONF)
    model = YOLO("yolov8s-obb.yaml", device="cuda", seed=0)
    n_params = sum(p.numel() for p in model.model.parameters())
    model.predict(imgs[:1], **kw)  # first call: cuDNN and allocator set-up
    torch.cuda.synchronize()

    nms_cuda.launches = 0
    with capture_rotated(eng_pred) as rot:
        results = model.predict(imgs, **kw)
    torch.cuda.synchronize()
    rb0, sc0 = rot["args"]
    if nms_cuda.launches or rot["calls"] != len(imgs) or rb0.shape[1] < OBB_MAX_NMS:
        raise AssertionError(f"obb predict: K1 launched {nms_cuda.launches} times, the rotated NMS called "
                             f"{rot['calls']} times on {tuple(rb0.shape)} rows, for {len(imgs)} images")
    dets = check_obb_results(results)

    per_image = []
    for _ in range(TASK_CALLS):
        t0 = time.perf_counter()
        model.predict(imgs, **kw)
        per_image.append((time.perf_counter() - t0) * 1e3 / len(imgs))
    q = np.percentile(per_image, [0, 10, 50, 90, 100])
    prof = profile_window(lambda: model.predict(imgs, **kw), TASK_PROFILED_CALLS, scope=ROTATED_NMS_SCOPE)
    call_ms = q[2] * len(imgs)
    busy = prof["device_busy_ms_per_call"]
    nms_ms = prof["scope"]["device_ms_per_call"]

    pred = model.predictor
    batch = pred.preprocess(imgs)
    ms16 = cuda_ms(lambda: pred.run(batch.repeat(4, 1, 1, 1)), iters=3)
    return dict(model="yolov8s-obb", parameters=n_params, nc=model.model.nc, imgsz=OBB_IMGSZ,
                anchors=int(rb0.shape[1]), max_nms=OBB_MAX_NMS, images=[list(sh) for sh in IMAGE_SHAPES], conf=CONF,
                k1_launches=nms_cuda.launches, rotated_nms_calls=rot["calls"], rboxes=dets,
                predict_calls=TASK_CALLS,
                predict_ms_per_image={"median": q[2], "p10": q[1], "p90": q[3], "min": q[0], "max": q[4]},
                predict_median_ms_per_call=call_ms,
                device_idle_share=None if busy is None else max(0.0, 1 - busy / call_ms),
                kernel_launches_per_image=prof["kernel_launches_per_call"] / len(imgs),
                rotated_nms_profiled_ms_per_call=None if nms_ms is None else nms_ms / len(imgs),
                rotated_nms_profiled_launches_per_call=prof["scope"]["launches_per_call"] / len(imgs),
                rotated_nms_share_of_busy=None if nms_ms is None or not busy else nms_ms / busy,
                rotated_nms_alone_one_image=rotated_nms_alone(ops_nms, rb0, sc0, pred.iou),
                predict_profile=prof, device_fn_batch16_ms=ms16, device_fn_batch16_images_per_s=16 * 1e3 / ms16,
                card_vs_cpu_one_image=obb_parity(YOLO, ops_nms, model, batch[:1]), card=card, nvidia_smi=smi)


def obb_val(YOLO, nms_cuda, ops_nms, tmp: Path, card: str, smi: str) -> dict:
    """yolov8s-obb val at 1024 on 128 images of the OBB set (phase obb_val)."""
    from ultralytics_pro_tpu_torch.engine import validator as eng_val

    data = val_set_640(tmp / "obb_1024", "torch_val_synth_obb", nc=15)
    kw = dict(data=str(data), imgsz=OBB_IMGSZ, batch=VAL_BATCH, conf=CONF, iou=0.7, max_det=300)
    model = YOLO("yolov8s-obb.yaml", device="cuda", seed=0)
    with capture_rotated(eng_val) as rot:  # warm-up call: cuDNN, allocator, and one batch's rows
        model.val(**kw)
    rb, sc = rot["args"]
    if tuple(rb.shape[:2]) != (VAL_BATCH, 21504):
        raise AssertionError(f"rotated NMS rows {tuple(rb.shape)}, want ({VAL_BATCH}, 21504, 5)")

    n_images, n_batches = VAL_COPIES * 16, VAL_COPIES * 16 // VAL_BATCH
    nms_cuda.launches = 0
    with capture_rotated(eng_val) as rot:
        t0 = time.perf_counter()
        metrics = model.val(**kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    confs = metrics.stats["conf"]
    kept = [len(c) for c in confs]
    if nms_cuda.launches or rot["calls"] != n_batches or len(confs) != n_images or any(
            not 0 < len(c) <= 300 or not np.isfinite(c).all() or c.min() <= CONF for c in confs):
        raise AssertionError(f"obb val: K1 launched {nms_cuda.launches} times, the rotated NMS called {rot['calls']} "
                             f"times for {n_batches} batches; kept {kept} for {n_images} images")
    prof = profile_window(lambda: model.val(**kw), reps=1, warmup=0, scope=ROTATED_NMS_SCOPE)
    busy = prof["device_busy_ms_per_call"]
    nms_ms = prof["scope"]["device_ms_per_call"]
    return dict(model="yolov8s-obb", nc=15, imgsz=OBB_IMGSZ, images=n_images, batch=VAL_BATCH, conf=CONF, iou=0.7,
                max_det=300, k1_launches=nms_cuda.launches, rotated_nms_calls=rot["calls"],
                kept_per_image={"min": min(kept), "median": float(np.median(kept)), "max": max(kept)},
                val_seconds=wall, images_per_s=n_images / wall,
                ms_per_image={k: v * 1e3 / n_images for k, v in metrics.speed.items()},
                map50=float(metrics.box.map50), device_busy_ms=busy,
                device_idle_share=None if busy is None else max(0.0, 1 - busy / (wall * 1e3)),
                kernel_launches=prof["kernel_launches_per_call"],
                rotated_nms_profiled_ms_per_batch=None if nms_ms is None else nms_ms / n_batches,
                rotated_nms_profiled_launches_per_batch=prof["scope"]["launches_per_call"] / n_batches,
                rotated_nms_share_of_busy=None if nms_ms is None or not busy else nms_ms / busy,
                rotated_nms_alone_one_batch=rotated_nms_alone(ops_nms, rb, sc, 0.7),
                val_profile=prof, card=card, nvidia_smi=smi)


@contextlib.contextmanager
def capture_k2(transformer):
    """Records the inputs of the first K2 call that MSDeformAttn makes inside
    the block (value, shapes, locs, attn, as clones); yields a dict that holds
    'args' once a call has been made."""
    cap, fused = {}, transformer.msda_sample_fused

    def k2(value, shapes, locs, attn):
        if "args" not in cap:
            cap["args"] = (value.clone(), list(shapes), locs.clone(), attn.clone())
        return fused(value, shapes, locs, attn)

    transformer.msda_sample_fused = k2
    try:
        yield cap
    finally:
        transformer.msda_sample_fused = fused


def rtdetr_val_parity(RTDETR, full_f32, model, data16: Path, kw: dict) -> dict:
    """rtdetr-l val of the first 16 images on the card and on the CPU (the
    same seeded weights): mAP50 and mAP50-95 within RTDETR_VAL_TOL; then that
    batch, as the loader gives it, through both models with aux. In the
    images whose 300 top-k query indices all agree, the same queries clear
    conf and their boxes agree within RTDETR_VAL_TOL px. Where an index
    differs (a near-tie: the CPU's encoder scores of the two anchors within
    PARITY_TOL), the decoder's self-attention sees another query set, so
    that image's queries are reported and not bounded: their largest box
    difference where the index agrees, and how many queries clear conf at a
    differing index."""
    from ultralytics_pro_tpu_torch.data import DataLoader, YOLODataset, check_det_dataset
    from ultralytics_pro_tpu_torch.engine.predictor import rgb01

    cpu_model = RTDETR("rtdetr-l.yaml", device="cpu", seed=0)
    for (k, a), b in zip(model.model.state_dict().items(), cpu_model.model.state_dict().values()):
        if not torch.equal(a.cpu(), b):
            raise AssertionError(f"seeded weights differ between devices at {k}")
    maps = {}
    for device, m in (("cuda", model), ("cpu", cpu_model)):
        t0 = time.perf_counter()
        r = m.val(data=str(data16), **kw)
        maps[device] = {"map50": float(r.box.map50), "map50_95": float(r.box.map),
                        "kept": sum(len(c) for c in r.stats["conf"]), "seconds": time.perf_counter() - t0}
    map_diff = max(abs(maps["cuda"][k] - maps["cpu"][k]) for k in ("map50", "map50_95"))

    d = check_det_dataset(str(data16))
    img = next(iter(DataLoader(YOLODataset(d["val"], imgsz=kw["imgsz"], data=d), batch_size=16, workers=8)))["img"]
    x = rgb01(torch.from_numpy(img))
    with torch.no_grad(), full_f32():
        y_gpu, aux_gpu = model.model(x.cuda())
        y_cpu, aux_cpu = cpu_model.model(x)
    y_gpu = y_gpu.cpu()
    same = aux_gpu["topk_index"].cpu() == aux_cpu["topk_index"]
    kept_gpu, kept_cpu = y_gpu[..., 4:].amax(-1) > kw["conf"], y_cpu[..., 4:].amax(-1) > kw["conf"]
    rows = same.all(1, keepdim=True).expand_as(same)  # images whose whole top-k row agrees
    kept_mismatch = int(((kept_gpu != kept_cpu) & rows).sum())
    h, w = x.shape[2:]
    scale = torch.tensor([w, h, w, h], dtype=torch.float32)
    err = ((y_gpu[..., :4] - y_cpu[..., :4]).abs() * scale).amax(-1)
    kept = kept_gpu | kept_cpu
    if not bool((rows & kept).any()):
        raise AssertionError(f"rtdetr-l val card vs CPU: no image keeps a query with its whole top-k row agreeing "
                             f"({int((~same).sum())} indices differ)")
    box_err = float(err[rows & kept].max())
    other = same & ~rows & kept
    box_err_other = float(err[other].max()) if bool(other.any()) else None
    conf_err = float((y_gpu[..., 4:] - y_cpu[..., 4:]).abs().amax(-1)[rows].max())
    best = aux_cpu["enc_scores_dense"].amax(-1)
    gaps = (best.gather(1, aux_gpu["topk_index"].cpu()) - best.gather(1, aux_cpu["topk_index"]))[~same]
    n_diff = int((~same).sum())
    gap = float(gaps.abs().max()) if n_diff else 0.0
    if kept_mismatch or not box_err <= RTDETR_VAL_TOL["boxes_px"] or not map_diff <= RTDETR_VAL_TOL["map"] \
            or not gap <= PARITY_TOL:
        raise AssertionError(f"rtdetr-l val card vs CPU, images whose top-k rows agree: {kept_mismatch} kept flags "
                             f"differ, boxes {box_err} px; "
                             f"mAPs {map_diff}, {n_diff} top-k indices differ (largest score gap {gap}); "
                             f"tolerances {RTDETR_VAL_TOL}, near-tie {PARITY_TOL}")
    return dict(images=16, card_val=maps["cuda"], cpu_val=maps["cpu"], max_abs_map_diff=map_diff,
                queries=int(same.numel()), kept_card=int(kept_gpu.sum()), kept_cpu=int(kept_cpu.sum()),
                images_whose_topk_rows_agree=int(same.all(1).sum()),
                kept_mismatch_in_those_images=kept_mismatch, max_abs_box_err_px_in_those_images=box_err,
                max_abs_score_err_in_those_images=conf_err,
                max_abs_box_err_px_where_index_agrees_in_other_images=box_err_other,
                kept_mismatch_where_index_agrees_in_other_images=int(((kept_gpu != kept_cpu) & same & ~rows).sum()),
                topk_index_mismatch=n_diff,
                kept_at_index_mismatch=int(((kept_gpu | kept_cpu) & ~same).sum()),
                max_abs_score_gap_at_mismatch=gap if n_diff else None, tolerance=RTDETR_VAL_TOL,
                near_tie_tolerance=PARITY_TOL, cpu_threads=torch.get_num_threads())


def rtdetr_val(RTDETR, msda_cuda, full_f32, tmp: Path, card: str, smi: str) -> dict:
    """rtdetr-l val at 640 on 128 images of the detect fixture set (batch 16,
    conf 0.001, seeded weights, 80 classes): images/s, K2's launches (6 a
    batch) read around the call, the idle share, the device ms a batch by
    kernel class and K2's ms a launch from one profiled call; K2 on one
    batch's captured inputs against its plain version (k2_measure); card
    against CPU on the first 16 images (rtdetr_val_parity)."""
    from ultralytics_pro_tpu_torch.nn.modules import transformer

    data = val_set_640(tmp / "rtdetr_val_set")
    kw = dict(imgsz=VAL_IMGSZ, batch=VAL_BATCH, conf=RTDETR_VAL_CONF)
    model = RTDETR("rtdetr-l.yaml", device="cuda", seed=0)
    with capture_k2(transformer) as cap:  # warm-up call: cuDNN, cuBLAS, allocator, and K2's first inputs
        model.val(data=str(data), **kw)
    n_images = VAL_COPIES * 16
    n_batches = n_images // VAL_BATCH
    msda_cuda.launches = 0
    t0 = time.perf_counter()
    metrics = model.val(data=str(data), **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = msda_cuda.launches
    if launches != 6 * n_batches:
        raise AssertionError(f"K2 launched {launches} times for {n_batches} val batches (6 decoder layers each)")
    confs = metrics.stats["conf"]
    kept = [len(c) for c in confs]
    if len(confs) != n_images or any(not 0 < len(c) <= 300 or not np.isfinite(c).all() or c.min() <= RTDETR_VAL_CONF
                                     for c in confs):
        raise AssertionError(f"rtdetr-l val kept {kept} queries for {n_images} images, want 1-300 above conf")
    prof = profile_window(lambda: model.val(data=str(data), **kw), reps=1, warmup=0)
    busy = prof["device_busy_ms_per_call"]
    k2_ms = prof["device_ms_by_category"].get("k2_msda_sample", 0.0)
    data16 = val_set_640(tmp / "rtdetr_val_16", copies=1)
    info = dict(model="rtdetr-l", nc=80, imgsz=VAL_IMGSZ, images=n_images, batch=VAL_BATCH, conf=RTDETR_VAL_CONF,
                k2_launches=launches, kept_per_image={"min": min(kept), "median": float(np.median(kept)),
                                                      "max": max(kept)},
                val_seconds=wall, images_per_s=n_images / wall,
                ms_per_image={k: v * 1e3 / n_images for k, v in metrics.speed.items()},
                map50=float(metrics.box.map50), device_busy_ms=busy,
                device_idle_share=None if busy is None else max(0.0, 1 - busy / (wall * 1e3)),
                device_ms_per_batch_by_category={k: v / n_batches for k, v in prof["device_ms_by_category"].items()},
                kernel_launches_per_batch=prof["kernel_launches_per_call"] / n_batches,
                k2_profiled_ms_per_launch=k2_ms / launches,
                k2_on_val_inputs=k2_measure(msda_cuda, "val_path", *cap["args"]),
                parity=rtdetr_val_parity(RTDETR, full_f32, model, data16, kw),
                val_profile=prof, card=card, nvidia_smi=smi)
    return info


def k2_grad_measure(msda_cuda, name: str, value, shapes, locs, attn, grad_out, cpu: bool = False) -> dict:
    """K2 forward and backward under autograd on these inputs (on the card)
    against the plain version's autograd on the card (and on the CPU when
    cpu): the forward within 1e-5, each gradient within K2_GRAD_TOL of its
    largest magnitude; the backward's time (its wrapper: grad_value's
    zero-fill and the kernel), the plain backward's, the bound, and
    index_add_ on the same corner rows as the yardstick of the scatter."""
    shapes = [tuple(int(v) for v in s) for s in shapes]
    b, q, nh = locs.shape[:3]
    v, hd = value.shape[1], value.shape[-1]
    leaves = [t.detach().clone().requires_grad_(True) for t in (value, locs, attn)]
    out = msda_cuda.msda_sample_fused(leaves[0], shapes, leaves[1], leaves[2])
    out.backward(grad_out)
    torch.cuda.synchronize()
    fwd_err = float((out.detach() - msda_cuda.msda_sample_fused_plain(value, shapes, locs, attn)).abs().max())
    refs = [msda_cuda.msda_sample_fused_backward_plain(value, shapes, locs, attn, grad_out)]
    if cpu:
        refs.append(msda_cuda.msda_sample_fused_backward_plain(value.cpu(), shapes, locs.cpu(), attn.cpu(),
                                                               grad_out.cpu()))
    grads = {}
    for gname, got, ref in zip(("value", "locs", "attn"), (t.grad for t in leaves), zip(*refs)):
        scale = float(ref[0].abs().max())
        err = max(float((got.to(r.device) - r).abs().max()) for r in ref)
        grads[gname] = {"max_abs_err": err, "largest": scale, "tolerance": K2_GRAD_TOL * scale}
        if not (bool(torch.isfinite(got).all()) and err <= K2_GRAD_TOL * scale):
            raise AssertionError(f"K2 backward {name}: grad {gname} max abs error {err} against the plain "
                                 f"version's autograd, tolerance {K2_GRAD_TOL} x {scale}")
    if not fwd_err <= 1e-5:
        raise AssertionError(f"K2 forward {name}: max abs error {fwd_err} against the plain version")
    ms = cuda_ms(lambda: msda_cuda._launch_backward(value, shapes, locs, attn, grad_out), iters=20)
    plain_ms = cuda_ms(lambda: msda_cuda.msda_sample_fused_backward_plain(value, shapes, locs, attn, grad_out),
                       iters=3)
    # bound: grad_out, locs, attn and the distinct value rows that corners
    # inside the maps touch read once; grad_value (zero-filled, then written),
    # grad_locs and grad_attn written once; 4*hd operations a corner (its dot
    # product and its scatter)
    idx, w = msda_cuda.msda_flatten_coords(shapes, locs, attn)  # (B, nh, Q, S)
    inside = w != 0
    b_idx = torch.arange(b, device=idx.device).view(b, 1, 1, 1)
    h_idx = torch.arange(nh, device=idx.device).view(1, nh, 1, 1)
    flat = (b_idx * v + idx.long()) * nh + h_idx  # rows of value viewed as (B*V*nh, hd)
    rows = int(torch.unique(flat[inside]).numel())
    nbytes = (grad_out.numel() + 2 * locs.numel() + 2 * attn.numel() + value.numel()) * 4 + rows * hd * 4
    ops = 4 * hd * int(inside.sum())
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_FLOPS * 1e3
    # the yardstick: one PyTorch call for the scatter part alone, grad_value
    # from the corner rows and their weighted grad_out rows (made beforehand,
    # not timed); no dot products, no grad_locs or grad_attn. The port never calls it.
    g = grad_out.view(b, q, nh, hd).transpose(1, 2)  # (B, nh, Q, hd)
    src = (w[..., None] * g[:, :, :, None, :]).reshape(-1, hd)
    flat_rows = flat.reshape(-1)

    def library():
        return torch.zeros((b * v * nh, hd), device=value.device).index_add_(0, flat_rows, src)

    lib_err = float((library().view_as(value) - leaves[0].grad).abs().max())
    lib_ms = cuda_ms(library, iters=10)
    return {"size": name, "B": b, "Q": q, "nh": nh, "hd": hd, "V": v, "S": idx.shape[-1],
            "corners_outside": int((~inside).sum()), "forward_max_abs_err": fwd_err, "grads": grads,
            "max_abs_err": max(x["max_abs_err"] for x in grads.values()),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes > t_ops else "operations", "bytes": nbytes,
            "grad_value_bytes": value.numel() * 4, "distinct_value_rows": rows, "ops": ops,
            "library_ms": lib_ms, "library_max_abs_err": lib_err,
            "library_covers": "index_add_ of the corner rows' weighted grad_out into a zeroed grad_value "
                              "(the scatter part alone)"}


def k2_grad_check(msda_cuda, name: str, b: int, q: int, nh: int, hd: int, shapes, seed: int, cpu: bool,
                  lo: float = -0.1, hi: float = 1.1) -> dict:
    rng = np.random.default_rng(seed)
    value, locs, attn = k2_inputs(rng, b, q, nh, hd, list(shapes), lo=lo, hi=hi)
    grad_out = torch.from_numpy(rng.normal(size=(b, q, nh * hd)).astype(np.float32)).cuda()
    return {**k2_grad_measure(msda_cuda, name, value, shapes, locs, attn, grad_out, cpu=cpu), "locations": [lo, hi]}


@contextlib.contextmanager
def timed_matching(detr_loss):
    """Within the block, every HungarianMatcher.solve call's host seconds (the
    costs' copy and the assignments, after the device has finished the
    step's forward) and its real ground truths."""
    rec, solve = {"seconds": [], "matched": []}, detr_loss.HungarianMatcher.solve

    def timed(cost, mask_gt):
        if cost.is_cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        rows = solve(cost, mask_gt)
        rec["seconds"].append(time.perf_counter() - t0)
        rec["matched"].append(int((mask_gt > 0).sum()))
        return rows

    detr_loss.HungarianMatcher.solve = staticmethod(timed)
    try:
        yield rec
    finally:
        detr_loss.HungarianMatcher.solve = staticmethod(solve)


@contextlib.contextmanager
def replayed_decisions(head, detr_loss, record: dict | None = None):
    """The RT-DETR step's discrete decisions: the decoder's top-k query
    selection (`head._topk`) and the matcher's assignment
    (`HungarianMatcher.solve`). Yields {"own": every call's own decision (on
    the host), "against_record": ...}. With a record (another run's "own"),
    every call still takes its own decision, counts where it differs from
    the recorded one and how far apart the two are on this run's own numbers
    (the top-k scores of the two queries; the recorded assignment's cost
    less this run's own, >= 0), and returns the recorded one: both runs
    then go on from the same decisions."""
    topk, solve = head._topk, detr_loss.HungarianMatcher.solve
    mine = {"topk": [], "rows": []}  # this run's own decisions
    seen = {"topk_differing": 0, "topk_score_gaps": [], "rows_differing": 0, "rows_matched": 0, "cost_gaps": []}

    def picked(scores, k):
        vals, idx = topk(scores, k)
        if record is None:
            mine["topk"].append(idx.cpu())
            return vals, idx
        want = record["topk"][len(mine["topk"])].to(idx.device)
        mine["topk"].append(idx.cpu())
        differ = idx != want
        if bool(differ.any()):
            seen["topk_differing"] += int(differ.sum())
            seen["topk_score_gaps"].append(float((scores.gather(-1, idx) - scores.gather(-1, want))[differ].abs().max()))
        return scores.gather(-1, want), want

    def assigned(cost, mask_gt):
        rows = solve(cost, mask_gt)
        if record is None:
            mine["rows"].append(rows.cpu())
            return rows
        want = record["rows"][len(mine["rows"])].to(rows.device)
        mine["rows"].append(rows.cpu())
        c, r, w, m = cost.cpu().numpy(), rows.cpu().numpy(), want.cpu().numpy(), mask_gt.cpu().numpy() > 0
        for li, bi in np.ndindex(*r.shape[:2]):
            g = np.flatnonzero(m[bi])
            seen["rows_matched"] += len(g)
            d = int((r[li, bi, g] != w[li, bi, g]).sum())
            if d:
                seen["rows_differing"] += d
                seen["cost_gaps"].append(float(c[li, bi, w[li, bi, g], g].sum() - c[li, bi, r[li, bi, g], g].sum()))
        return want

    head._topk, detr_loss.HungarianMatcher.solve = picked, staticmethod(assigned)
    try:
        yield {"own": mine, "against_record": seen}
    finally:
        head._topk, detr_loss.HungarianMatcher.solve = topk, staticmethod(solve)


def rtdetr_step_diffs(a, b) -> dict:
    """Differences of two rtdetr_one_step runs, a against b: each loss part
    relative; params, EMA and BN statistics as the largest |a - b| against
    the tree's largest magnitude (a random-init tree holds tensors near 0),
    with the tensor where it is; the momentum buffers (after one step, the
    clipped gradient) as the whole tree's relative L2 distance
    ("momentum_buffer") and the largest leaf's ("momentum_leaf"), over the
    leaves whose norm in b is at least MOMENTUM_LEAF_FLOOR of the largest
    leaf's. The leaves below it have a gradient that is 0 but for rounding:
    attention's key biases (softmax ignores a shift of its logits) and five
    norm biases whose shift the layers after them cancel."""
    (la, ca), (lb, cb) = a, b
    out = {f"loss_{k}": (abs(la[k] - lb[k]) / abs(lb[k]), k) for k in lb}
    for key in ("params", "ema", "batch_stats"):
        got, want = dict(tree_leaves(ca[key])), dict(tree_leaves(cb[key]))
        top = max(float(np.abs(w).max()) for w in want.values())
        out[key] = max((float(np.abs(got[k] - w).max()) / top, k) for k, w in want.items())
    got, want = dict(tree_leaves(ca["momentum_buffer"])), dict(tree_leaves(cb["momentum_buffer"]))
    norm = {k: float(np.linalg.norm(w)) for k, w in want.items()}
    dist = {k: float(np.linalg.norm(got[k] - w)) for k, w in want.items()}
    out["momentum_buffer"] = (float(np.sqrt(sum(d * d for d in dist.values()) / sum(n * n for n in norm.values()))),
                              "tree")
    top = max(norm.values())
    out["momentum_leaf"] = max((dist[k] / norm[k], k) for k in want if norm[k] >= MOMENTUM_LEAF_FLOOR * top)
    return out


def rtdetr_one_step(RTDETR, load_pickle, head, detr_loss, cfg: dict, data: Path, project: Path, device: str,
                    record: dict | None = None, dtype: torch.dtype = torch.float32):
    """One optimizer step of seeded rtdetr-l (cfg) through RTDETR(...).train
    at RTDETR_PARITY_IMGSZ on TRAIN_PARITY_IMAGES images, batch = nbs = 8,
    no warmup, the JAX defaults otherwise (max_gt 32 here; num_dn 100: 3
    denoising groups), the model in dtype, with record's discrete decisions
    replayed (replayed_decisions). Returns ((loss parts, last.ckpt), this
    run's decisions)."""
    model = RTDETR(copy.deepcopy(cfg), device=device, seed=0)
    model.model.to(dtype)
    with replayed_decisions(head, detr_loss, record) as decided:
        model.train(data=str(data), epochs=1, imgsz=RTDETR_PARITY_IMGSZ, batch=TRAIN_PARITY_IMAGES,
                    nbs=TRAIN_PARITY_IMAGES, warmup_epochs=0.0, workers=4, max_gt=32, project=str(project))
    tr = model.trainer
    if tr.opt_steps != 1:
        raise AssertionError(f"rtdetr-l one step on {device}: {tr.opt_steps} optimizer steps, want 1")
    return (tr.loss_history[0], load_pickle(tr.wdir / "last.ckpt")), decided


def rtdetr_train_parity(RTDETR, yaml_model_load, load_pickle, detr_loss, tmp: Path, card: str, smi: str) -> dict:
    """rtdetr_one_step of seeded rtdetr-l at nc 3 on 8 fixture images at 160
    px, on the CPU and on the card, from the same seeded weights and the
    same denoising noise (each trainer's generator seeded from seed 0), the
    card replaying the CPU run's top-k selection and matching (its own
    decisions that differ are reported with their gaps). The card's step is
    held to the CPU's within RTDETR_TRAIN_PARITY_TOL (rtdetr_step_diffs)."""
    from ultralytics_pro_tpu_torch.nn.modules import head

    data = fixture_train_set(tmp / "rtdetr_train_parity_set", TRAIN_PARITY_IMAGES)
    cfg = {**yaml_model_load("rtdetr-l.yaml"), "nc": 3}
    cpu, cpu_decided = rtdetr_one_step(RTDETR, load_pickle, head, detr_loss, cfg, data,
                                       tmp / "rtdetr_train_parity_cpu", "cpu")
    card_run, card_decided = rtdetr_one_step(RTDETR, load_pickle, head, detr_loss, cfg, data,
                                             tmp / "rtdetr_train_parity_card", "cuda", record=cpu_decided["own"])
    diffs = rtdetr_step_diffs(card_run, cpu)
    bad = {k: v for k, v in diffs.items() if not v[0] <= RTDETR_TRAIN_PARITY_TOL["loss" if k.startswith("loss") else k]}
    if bad:
        raise AssertionError(f"rtdetr-l card vs CPU after one step beyond {RTDETR_TRAIN_PARITY_TOL}: {bad}; "
                             f"all: {diffs}")
    return dict(model="rtdetr-l (seeded, nc 3)", images=TRAIN_PARITY_IMAGES, imgsz=RTDETR_PARITY_IMGSZ,
                batch=TRAIN_PARITY_IMAGES, nbs=TRAIN_PARITY_IMAGES, warmup_epochs=0.0, max_gt=32,
                loss_card=card_run[0], loss_cpu=cpu[0], card_vs_cpu=diffs, tolerance=RTDETR_TRAIN_PARITY_TOL,
                card_decisions_against_cpu=card_decided["against_record"],
                ema_updates=[card_run[1]["ema_updates"], cpu[1]["ema_updates"]],
                cpu_threads=torch.get_num_threads(), card=card, nvidia_smi=smi)


@contextlib.contextmanager
def capture_k2_grad(transformer):
    """Records the inputs of the first K2 call that MSDeformAttn makes inside
    the block, detached, and the gradient its output receives in the
    backward; yields a dict that holds 'args' and 'grad_out' once a step has
    run."""
    cap, fused = {}, transformer.msda_sample_fused

    def k2(value, shapes, locs, attn):
        out = fused(value, shapes, locs, attn)
        if "args" not in cap and out.requires_grad:
            cap["args"] = (value.detach().clone(), list(shapes), locs.detach().clone(), attn.detach().clone())
            out.register_hook(lambda g: cap.setdefault("grad_out", g.detach().clone()))
        return out

    transformer.msda_sample_fused = k2
    try:
        yield cap
    finally:
        transformer.msda_sample_fused = fused


def rtdetr_train(RTDETR, msda_cuda, detr_loss, tmp: Path, card: str, smi: str) -> dict:
    """rtdetr-l at 640 (80 classes), batch 16, the JAX defaults otherwise
    (nbs 64, warmup 3 epochs, max_gt 128, num_dn 100), 2 epochs on the
    detect fixture images 8 times over (128, train = val), no epoch-end val
    (the JAX RT-DETR trainer runs none). K2's forward and backward launches
    are read around the run (6 + 6 a micro-batch); the matcher's host ms a
    step; then micro_batch_measures (device ms, idle share, the criterion's
    device ms and launches) with K2's forward and backward ms a launch from
    its profile, and K2 on one micro-batch's captured inputs and gradient:
    forward (k2_measure) and backward (k2_grad_measure) against the plain
    version, timed, with their bounds."""
    from ultralytics_pro_tpu_torch.nn.modules import transformer

    data = val_set_640(tmp / "rtdetr_train_set")
    data.write_text(data.read_text().replace("val: images/val", "train: images/val\nval: images/val\n"))
    model = RTDETR("rtdetr-l.yaml", device="cuda", seed=0)
    torch.cuda.reset_peak_memory_stats()
    msda_cuda.launches = msda_cuda.backward_launches = 0
    t0 = time.perf_counter()
    with timed_matching(detr_loss) as rec:
        model.train(data=str(data), epochs=TRAIN_EPOCHS, imgsz=TRAIN_IMGSZ, batch=TRAIN_BATCH,
                    project=str(tmp / "rtdetr_train"))
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {"forward": msda_cuda.launches, "backward": msda_cuda.backward_launches}
    tr = model.trainer
    nb = VAL_COPIES * 16 // TRAIN_BATCH
    ndl = len(tr.model.model[-1].decoder.layers)
    if launches != {"forward": ndl * TRAIN_EPOCHS * nb, "backward": ndl * TRAIN_EPOCHS * nb}:
        raise AssertionError(f"K2 launches {launches} in {TRAIN_EPOCHS} epochs of {nb} micro-batches, want "
                             f"{ndl} forward and {ndl} backward a micro-batch")
    if not all(np.isfinite(v) for e in tr.loss_history for v in e.values()) or len(tr.loss_history) != TRAIN_EPOCHS:
        raise AssertionError(f"loss history {tr.loss_history}")
    solve_ms = [x * 1e3 for x in rec["seconds"]]
    info = dict(model="rtdetr-l", nc=tr.model.nc, imgsz=TRAIN_IMGSZ, batch=TRAIN_BATCH, nbs=tr.nbs,
                accumulate=tr.accumulate, warmup_epochs=tr.warmup_epochs, epochs=TRAIN_EPOCHS,
                images=nb * TRAIN_BATCH, micro_batches_per_epoch=nb, opt_steps=tr.opt_steps,
                max_gt=int(tr.args["max_gt"]), num_dn=int(tr.args.get("num_dn", 100)),
                train_seconds=seconds, epoch_train_seconds=tr.epoch_train_seconds,
                train_images_per_s_epoch2=nb * TRAIN_BATCH / tr.epoch_train_seconds[-1],
                wall_ms_per_micro_batch_epoch2=tr.epoch_train_seconds[-1] * 1e3 / nb,
                max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
                loss_history=tr.loss_history, k2_launches=launches,
                k2_launches_per_micro_batch={k: v / (TRAIN_EPOCHS * nb) for k, v in launches.items()},
                matcher_host_ms_per_step={"median": float(np.median(solve_ms)), "max": max(solve_ms),
                                          "calls": len(solve_ms)},
                matched_gts_per_step=float(np.mean(rec["matched"])))
    host = det_host_batch(tr, data, TRAIN_IMGSZ)
    info.update(micro_batch_measures(tr, host, TRAIN_IMGSZ))
    by_cat = info["micro_batch_profile"]["device_ms_by_category"]
    info.update(k2_profiled_ms_per_launch=by_cat.get("k2_msda_sample", 0.0) / ndl,
                k2_backward_profiled_ms_per_launch=by_cat.get("k2_msda_backward", 0.0) / ndl)
    with capture_k2_grad(transformer) as cap:
        tr.model.train()
        tr.step(tr.put_batch(host), [0.0] * 3, tr.momentum, False)
        tr.optimizer.zero_grad(set_to_none=True)
        tr.model.eval()
    value, shapes, locs, attn = cap["args"]
    if tuple(locs.shape[:2]) != (TRAIN_BATCH, RTDETR_TRAIN_Q):
        raise AssertionError(f"K2 on the train path took locs {tuple(locs.shape)}, want ({TRAIN_BATCH}, "
                             f"{RTDETR_TRAIN_Q}, ...)")
    info.update(k2_on_train_inputs=k2_measure(msda_cuda, "train_path", value, shapes, locs, attn),
                k2_backward_on_train_inputs=k2_grad_measure(msda_cuda, "train_path", value, shapes, locs, attn,
                                                            cap["grad_out"]),
                card=card, nvidia_smi=smi)
    return info


def cls_set(root: Path, copies: int, train_per_class=None) -> Path:
    """A classify set under root from the fixture's PNGs: val/ holds its 16
    val images `copies` times; train/ holds the same when train_per_class is
    None, else the first train_per_class[c] val images of class c (images
    the fixture model was not trained on, so the step's gradient is not
    near zero)."""
    src = FIXTURES / CLS_SET
    for c, cls_dir in enumerate(sorted(p for p in (src / "val").iterdir() if p.is_dir())):
        for split in ("val", "train"):
            (root / split / cls_dir.name).mkdir(parents=True)
        for k in range(copies):
            for png in sorted(cls_dir.glob("*.png")):
                shutil.copy(png, root / "val" / cls_dir.name / f"copy{k}_{png.name}")
                if train_per_class is None:
                    shutil.copy(png, root / "train" / cls_dir.name / f"copy{k}_{png.name}")
        if train_per_class is not None:
            for png in sorted(cls_dir.glob("*.png"))[:train_per_class[c]]:
                shutil.copy(png, root / "train" / cls_dir.name)
    return root


def cls_fixture_model(YOLO, yaml_model_load, device: str):
    """The JAX-trained yolov8n-cls of val_parity_cls_model.npz (nc 3)."""
    y = yaml_model_load("yolov8n-cls.yaml")
    y["nc"] = 3
    model = YOLO(y, device=device)
    with np.load(FIXTURES / "val_parity_cls_model.npz") as fx:
        model.load_state_dict({k[4:]: fx[k] for k in fx.files if k.startswith("sd::")})
    return model


def cls_predict(YOLO, card: str, smi: str) -> dict:
    """yolov8s-cls (nc 1000) predict at 224 on the 4 seeded images: warm
    latency an image over CLS_CALLS calls, the idle share from one profiled
    window, the device function's images/s at batch 16; the card's
    probabilities on its own resized batch against the CPU's forward of the
    same batch within CLS_TOL, and how far the two devices' resizes differ."""
    imgs = seeded_images()
    model = YOLO("yolov8s-cls.yaml", device="cuda", seed=0)
    kw = dict(imgsz=CLS_IMGSZ)
    model.predict(imgs[:1], **kw)  # first call: cuDNN and allocator set-up
    results = model.predict(imgs, **kw)
    for r in results:
        p = r.probs.data
        if p.shape != (1000,) or not np.isfinite(p).all() or abs(float(p.sum()) - 1) > 1e-4:
            raise AssertionError(f"probabilities {p.shape}, finite {np.isfinite(p).all()}, sum {p.sum()}")
    per_image = []
    for _ in range(CLS_CALLS):
        t0 = time.perf_counter()
        model.predict(imgs, **kw)
        per_image.append((time.perf_counter() - t0) * 1e3 / len(imgs))
    q = np.percentile(per_image, [0, 10, 50, 90, 100])
    prof = profile_window(lambda: model.predict(imgs, **kw), CLS_PROFILED_CALLS)
    call_ms = q[2] * len(imgs)
    busy = prof["device_busy_ms_per_call"]
    pred = model.predictor
    batch = pred.preprocess(imgs)
    ms16 = cuda_ms(lambda: pred.run(batch.repeat(4, 1, 1, 1)), iters=10)

    cpu_model = YOLO("yolov8s-cls.yaml", device="cpu", seed=0)
    for (k, a), b in zip(model.model.state_dict().items(), cpu_model.model.state_dict().values()):
        if not torch.equal(a.cpu(), b):
            raise AssertionError(f"seeded weights differ between devices at {k}")
    cpu_pred = type(pred)(cpu_model.model, pred.args)
    resize_diff = int((cpu_pred.preprocess(imgs).int() - batch.cpu().int()).abs().max())
    with torch.no_grad():
        p_gpu, p_cpu = pred.run(batch).cpu(), cpu_pred.run(batch.cpu())
    err = float((p_gpu - p_cpu).abs().max())
    top1_same = bool((p_gpu.argmax(-1) == p_cpu.argmax(-1)).all())
    if not err <= CLS_TOL:
        raise AssertionError(f"yolov8s-cls card vs CPU probabilities differ by {err} (tolerance {CLS_TOL})")
    return dict(model="yolov8s-cls", nc=1000, imgsz=CLS_IMGSZ, images=[list(s) for s in IMAGE_SHAPES],
                parameters=sum(p.numel() for p in model.model.parameters()), predict_calls=CLS_CALLS,
                predict_ms_per_image={"median": q[2], "p10": q[1], "p90": q[3], "min": q[0], "max": q[4]},
                predict_median_ms_per_call=call_ms,
                device_idle_share=None if busy is None else max(0.0, 1 - busy / call_ms),
                kernel_launches_per_image=prof["kernel_launches_per_call"] / len(imgs), predict_profile=prof,
                device_fn_batch16_ms=ms16, device_fn_batch16_images_per_s=16 * 1e3 / ms16,
                max_abs_prob_err_card_vs_cpu=err, top1_same=top1_same, tolerance=CLS_TOL,
                resize_max_grey_level_diff_card_vs_cpu=resize_diff, card=card, nvidia_smi=smi)


def cls_fixture(YOLO, yaml_model_load, card: str, smi: str) -> dict:
    """The fixture yolov8n-cls on its 16 val images at 64 px, batch 16, on
    the card and on the CPU: top1 and top5 equal to each other and to the
    JAX validator's (val_parity_cls_ref.json)."""
    ref = json.loads((FIXTURES / "val_parity_cls_ref.json").read_text())
    runs = {}
    for device in ("cuda", "cpu"):
        t0 = time.perf_counter()
        m = cls_fixture_model(YOLO, yaml_model_load, device).val(data=str(FIXTURES / CLS_SET), **ref["val_args"])
        runs[device] = {"top1": m.top1, "top5": m.top5, "seconds": time.perf_counter() - t0}
    want = ref["results"]
    if any(runs[d][k] != want[k] for d in runs for k in ("top1", "top5")):
        raise AssertionError(f"classify fixture: card {runs['cuda']}, CPU {runs['cpu']}, JAX reference {want}")
    return dict(model="yolov8n-cls (val_parity_cls_model.npz)", data=f"tests/fixtures/{CLS_SET}",
                val_args=ref["val_args"], card_run=runs["cuda"], cpu_run=runs["cpu"], reference=want,
                card=card, nvidia_smi=smi)


def cls_val(YOLO, tmp: Path, card: str, smi: str) -> dict:
    """yolov8s-cls (nc 1000, seeded) val at 224 on the fixture's val images 8
    times over (128 images, batch 16): images/s of a warm call, the idle
    share and the device ms by kernel class from one profiled call."""
    root = cls_set(tmp / "cls_val_set", VAL_COPIES)
    kw = dict(data=str(root), imgsz=CLS_IMGSZ, batch=VAL_BATCH)
    model = YOLO("yolov8s-cls.yaml", device="cuda", seed=0)
    model.val(**kw)  # warm-up
    n_images = VAL_COPIES * 16
    t0 = time.perf_counter()
    m = model.val(**kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if len(np.concatenate(m._correct)) != n_images:
        raise AssertionError(f"classify val scored {len(np.concatenate(m._correct))} images, want {n_images}")
    prof = profile_window(lambda: model.val(**kw), reps=1, warmup=0)
    busy = prof["device_busy_ms_per_call"]
    return dict(model="yolov8s-cls", nc=1000, imgsz=CLS_IMGSZ, images=n_images, batch=VAL_BATCH,
                val_seconds=wall, images_per_s=n_images / wall,
                ms_per_image={k: v * 1e3 / n_images for k, v in m.speed.items()}, top1=m.top1, top5=m.top5,
                device_busy_ms=busy, device_idle_share=None if busy is None else max(0.0, 1 - busy / (wall * 1e3)),
                val_profile=prof, card=card, nvidia_smi=smi)


def cls_train_parity(YOLO, yaml_model_load, load_pickle, tmp: Path, card: str, smi: str) -> dict:
    """One optimizer step of the fixture yolov8n-cls on 8 of its val images
    (3, 3 and 2 of the classes) at 64 px, batch 8, nbs 8, no warmup, with the
    epoch-end val on the fixture's val images, on the card and on the CPU;
    within TRAIN_PARITY_TOL, the same fitness."""
    root = cls_set(tmp / "cls_train_parity_set", 1, train_per_class=(3, 3, 2))
    runs = []
    for device in ("cuda", "cpu"):
        model = cls_fixture_model(YOLO, yaml_model_load, device)
        model.train(data=str(root), epochs=1, imgsz=64, batch=TRAIN_PARITY_IMAGES, nbs=TRAIN_PARITY_IMAGES,
                    warmup_epochs=0.0, workers=4, project=str(tmp / f"cls_train_parity_{device}"))
        tr = model.trainer
        runs.append((tr.loss_history[0], load_pickle(tr.wdir / "last.ckpt"), tr.opt_steps, model))
    info = one_step_diffs(*runs)
    fitness = [run[3].trainer.last_fitness for run in runs]
    if fitness[0] is None or fitness[0] != fitness[1]:
        raise AssertionError(f"classify train val gave fitness {fitness} (card, CPU)")
    info.update(model="yolov8n-cls (val_parity_cls_model.npz)", images=TRAIN_PARITY_IMAGES, imgsz=64,
                batch=TRAIN_PARITY_IMAGES, nbs=TRAIN_PARITY_IMAGES, warmup_epochs=0.0, fitness_card_cpu=fitness,
                cpu_threads=torch.get_num_threads(), card=card, nvidia_smi=smi)
    return info


def cls_train(YOLO, tmp: Path, card: str, smi: str) -> dict:
    """yolov8s-cls at 224, rebuilt at the set's nc 3, batch 16 and the JAX
    defaults otherwise (nbs 64, warmup 3 epochs, val), 2 epochs on 128
    images (train = val): images/s in epoch 2, the micro-batch's device ms,
    idle share, the criterion's ms and launches and the FLOP share
    (micro_batch_measures)."""
    from ultralytics_pro_tpu_torch.data import ClassificationDataset, DataLoader, collate_classify

    root = cls_set(tmp / "cls_train_set", VAL_COPIES)
    model = YOLO("yolov8s-cls.yaml", device="cuda", seed=0)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model.train(data=str(root), epochs=TRAIN_EPOCHS, imgsz=CLS_IMGSZ, batch=TRAIN_BATCH,
                project=str(tmp / "cls_train"))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    tr = model.trainer
    nb = VAL_COPIES * 16 // TRAIN_BATCH
    if not all(np.isfinite(v) for e in tr.loss_history for v in e.values()) or len(tr.loss_history) != TRAIN_EPOCHS:
        raise AssertionError(f"loss history {tr.loss_history}")
    host = next(iter(DataLoader(ClassificationDataset(root / "train", imgsz=CLS_IMGSZ), batch_size=TRAIN_BATCH,
                                workers=8, collate_fn=collate_classify)))
    info = dict(model="yolov8s-cls", nc=tr.model.nc, imgsz=CLS_IMGSZ, batch=TRAIN_BATCH, nbs=tr.nbs,
                accumulate=tr.accumulate, warmup_epochs=tr.warmup_epochs, epochs=TRAIN_EPOCHS, images=nb * TRAIN_BATCH,
                micro_batches_per_epoch=nb, opt_steps=tr.opt_steps, train_seconds=seconds,
                epoch_train_seconds=tr.epoch_train_seconds,
                train_images_per_s_epoch2=nb * TRAIN_BATCH / tr.epoch_train_seconds[-1],
                wall_ms_per_micro_batch_epoch2=tr.epoch_train_seconds[-1] * 1e3 / nb,
                max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9, loss_history=tr.loss_history,
                fitness_per_epoch=fitness_values(tr.save_dir, TRAIN_EPOCHS))
    info.update(micro_batch_measures(tr, host, CLS_IMGSZ), card=card, nvidia_smi=smi)
    return info


def tf32_seen(model, call) -> dict:
    """torch's TF32 flags (cudnn, cuda matmul) as found, inside model's forward
    during call(), and after it."""
    flags = lambda: [torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32]  # noqa: E731
    found, inside = flags(), []
    handle = model.model.register_forward_pre_hook(lambda *_: inside.append(flags()))
    try:
        call()
    finally:
        handle.remove()
    after = flags()
    if not inside or any(any(f) for f in inside) or after != found:
        raise AssertionError(f"TF32 flags as found {found}, inside predict {inside}, after {after}")
    return {"as_found": found, "inside_predict": inside[0], "after_predict": after}


def main() -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA card",
              file=sys.stderr)
        return 2

    from ultralytics_pro_tpu_torch import RTDETR, YOLO
    from ultralytics_pro_tpu_torch.engine.trainer import load_pickle
    from ultralytics_pro_tpu_torch.kernels import build, msda_cuda, nms_cuda
    from ultralytics_pro_tpu_torch.nn.modules.head import decode_single_label
    from ultralytics_pro_tpu_torch.nn.tasks import yaml_model_load
    from ultralytics_pro_tpu_torch.ops import nms as ops_nms
    from ultralytics_pro_tpu_torch.utils import detr_loss, full_f32

    t_all = time.perf_counter()
    t = time.perf_counter()
    path = build.build()
    ptxas = [ln.strip() for ln in build.build_info["ptxas"].splitlines()
             if "registers" in ln or "Compiling entry" in ln or "spill" in ln]
    emit("build", library=path.name, built=build.build_info["built"],
         nvcc_seconds=build.build_info["seconds"], ptxas=ptxas, seconds=time.perf_counter() - t)

    t = time.perf_counter()
    card = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    img = seeded_images()[0]
    tiny_yolo, tiny_detr = YOLO("yolov8n.yaml", device="cuda"), RTDETR("rtdetr-l.yaml", device="cuda")
    emit("env", card=card, nvidia_smi=smi, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda, python=sys.version.split()[0],
         tf32={"flags": ["cudnn.allow_tf32", "cuda.matmul.allow_tf32"],
               "yolov8n_predict": tf32_seen(tiny_yolo, lambda: tiny_yolo.predict([img], imgsz=64)),
               "rtdetr_l_predict": tf32_seen(tiny_detr, lambda: tiny_detr.predict([img], imgsz=64))},
         seconds=time.perf_counter() - t)
    del tiny_yolo, tiny_detr

    t = time.perf_counter()
    k1 = [k1_check(nms_cuda, "predict", 16, 8400, 300, 0.7, seed=1),
          k1_check(nms_cuda, "val", 2, 30000, 300, 0.7, seed=2)]
    emit("k1", checks=k1, card=card, nvidia_smi=smi, seconds=time.perf_counter() - t)

    t = time.perf_counter()
    model, batch, info = main_path(YOLO, nms_cuda, decode_single_label, full_f32, card, smi)
    launches = info["k1_launches"]
    # device time per launch on the main path, from its profiled window
    k1_path_ms = info["predict_profile"]["device_ms_by_category"].get("k1_greedy_nms", 0.0) / launches
    emit("main", **info, seconds=time.perf_counter() - t)
    t = time.perf_counter()
    info = parity(YOLO, nms_cuda, ops_nms, decode_single_label, full_f32, model, batch)
    emit("parity", **info, seconds=time.perf_counter() - t)
    del model

    t = time.perf_counter()
    k2 = [k2_check(msda_cuda, "predict", 1, 300, 8, 32, RTDETR_LEVELS, seed=3),
          k2_check(msda_cuda, "batch16", 16, 300, 8, 32, RTDETR_LEVELS, seed=4),
          k2_check(msda_cuda, "edge_hd8_q37_outside", 2, 37, 4, 8, ((12, 16), (6, 8), (3, 4)), seed=5,
                   lo=-0.6, hi=1.6)]
    emit("k2", checks=k2, card=card, nvidia_smi=smi, seconds=time.perf_counter() - t)
    t = time.perf_counter()
    k2g = [k2_grad_check(msda_cuda, "train", TRAIN_BATCH, RTDETR_TRAIN_Q, 8, 32, RTDETR_LEVELS, seed=6, cpu=False),
           k2_grad_check(msda_cuda, "edge_hd8_q37_outside", 2, 37, 4, 8, ((12, 16), (6, 8), (3, 4)), seed=7,
                         cpu=True, lo=-0.6, hi=1.6)]
    emit("k2_grad", checks=k2g, tolerance=K2_GRAD_TOL, card=card, nvidia_smi=smi, seconds=time.perf_counter() - t)

    t = time.perf_counter()
    model, batch, info = rtdetr_path(RTDETR, msda_cuda, nms_cuda, card, smi)
    k2_launches = info["k2_launches"]
    k2_path_ms = info["predict_profile"]["device_ms_by_category"].get("k2_msda_sample", 0.0) / k2_launches
    emit("rtdetr", **info, seconds=time.perf_counter() - t)
    t = time.perf_counter()
    info = rtdetr_parity(RTDETR, full_f32, model, batch)
    emit("rtdetr_parity", **info, seconds=time.perf_counter() - t)
    del model
    with tempfile.TemporaryDirectory() as tmp:
        t = time.perf_counter()
        rt_val = rtdetr_val(RTDETR, msda_cuda, full_f32, Path(tmp), card, smi)
        emit("rtdetr_val", **rt_val, seconds=time.perf_counter() - t)
        t = time.perf_counter()
        info = rtdetr_train_parity(RTDETR, yaml_model_load, load_pickle, detr_loss, Path(tmp), card, smi)
        emit("rtdetr_train_parity", **info, seconds=time.perf_counter() - t)
        t = time.perf_counter()
        rt_train = rtdetr_train(RTDETR, msda_cuda, detr_loss, Path(tmp), card, smi)
        emit("rtdetr_train", **rt_train, seconds=time.perf_counter() - t)

    with tempfile.TemporaryDirectory() as tmp:
        t = time.perf_counter()
        info = val_fixture(YOLO, yaml_model_load, nms_cuda, Path(tmp), card, smi)
        emit("val_fixture", **info, seconds=time.perf_counter() - t)
        t = time.perf_counter()
        val, cap = val_path(YOLO, nms_cuda, ops_nms, Path(tmp), card, smi)
        emit("val", **val, seconds=time.perf_counter() - t)
    t = time.perf_counter()
    vk1 = captured_k1(ops_nms, nms_cuda, cap, card, smi)
    emit("val_k1", **vk1, seconds=time.perf_counter() - t)

    with tempfile.TemporaryDirectory() as tmp:
        for task, phase in (("segment", "seg_fixture"), ("pose", "pose_fixture"), ("obb", "obb_fixture")):
            t = time.perf_counter()
            info = task_fixture(YOLO, yaml_model_load, nms_cuda, task, Path(tmp), card, smi)
            emit(phase, **info, seconds=time.perf_counter() - t)
    task_runs = {}
    for task, phase in (("segment", "seg"), ("pose", "pose")):
        t = time.perf_counter()
        task_runs[task] = task_predict(YOLO, nms_cuda, ops_nms, task, card, smi)
        emit(phase, **task_runs[task], seconds=time.perf_counter() - t)
    with tempfile.TemporaryDirectory() as tmp:
        t = time.perf_counter()
        seg_val, cap = val_path(YOLO, nms_cuda, ops_nms, Path(tmp), card, smi, "yolov8s-seg", "torch_val_synth_segment")
        seg_val["k1_on_batch_rows"] = captured_k1(ops_nms, nms_cuda, cap, card, smi)
        emit("seg_val", **seg_val, seconds=time.perf_counter() - t)
    t = time.perf_counter()
    info = obb_predict(YOLO, nms_cuda, ops_nms, card, smi)
    emit("obb", **info, seconds=time.perf_counter() - t)
    with tempfile.TemporaryDirectory() as tmp:
        t = time.perf_counter()
        info = obb_val(YOLO, nms_cuda, ops_nms, Path(tmp), card, smi)
        emit("obb_val", **info, seconds=time.perf_counter() - t)

    with tempfile.TemporaryDirectory() as tmp:
        t = time.perf_counter()
        info = train_parity(YOLO, yaml_model_load, load_pickle, Path(tmp), card, smi)
        emit("train_parity", **info, seconds=time.perf_counter() - t)
        t = time.perf_counter()
        info = train_overfit(YOLO, nms_cuda, Path(tmp), card, smi)
        emit("train_overfit", **info, seconds=time.perf_counter() - t)
        t = time.perf_counter()
        train = train_path(YOLO, nms_cuda, ops_nms, Path(tmp), card, smi)
        emit("train", **train, seconds=time.perf_counter() - t)

    task_train = {}
    with tempfile.TemporaryDirectory() as tmp:
        for task, short in (("segment", "seg"), ("pose", "pose"), ("obb", "obb")):
            t = time.perf_counter()
            task_train[f"{short}_parity"] = info = task_train_parity(YOLO, yaml_model_load, load_pickle, nms_cuda,
                                                                     ops_nms, task, Path(tmp), card, smi)
            emit(f"{short}_train_parity", **info, seconds=time.perf_counter() - t)
        for task, short in (("segment", "seg"), ("pose", "pose"), ("obb", "obb")):
            t = time.perf_counter()
            task_train[short] = info = task_train_path(YOLO, nms_cuda, task, Path(tmp), card, smi)
            emit(f"{short}_train", **info, seconds=time.perf_counter() - t)

    t = time.perf_counter()
    emit("cls", **cls_predict(YOLO, card, smi), seconds=time.perf_counter() - t)
    t = time.perf_counter()
    emit("cls_fixture", **cls_fixture(YOLO, yaml_model_load, card, smi), seconds=time.perf_counter() - t)
    with tempfile.TemporaryDirectory() as tmp:
        for phase, fn in (("cls_val", lambda: cls_val(YOLO, Path(tmp), card, smi)),
                          ("cls_train_parity", lambda: cls_train_parity(YOLO, yaml_model_load, load_pickle, Path(tmp),
                                                                        card, smi)),
                          ("cls_train", lambda: cls_train(YOLO, Path(tmp), card, smi))):
            t = time.perf_counter()
            emit(phase, **fn(), seconds=time.perf_counter() - t)

    pred, val_size = k1
    tk1 = train["k1_on_val_rows"]
    task_k1 = {"seg_predict": (task_runs["segment"], task_runs["segment"]["k1_on_batch_rows"]),
               "pose_predict": (task_runs["pose"], task_runs["pose"]["k1_on_batch_rows"]),
               "seg_val": (seg_val, seg_val["k1_on_batch_rows"]),
               "seg_train": (task_train["seg_parity"], task_train["seg_parity"]["k1_on_val_rows"]),
               "pose_train": (task_train["pose_parity"], task_train["pose_parity"]["k1_on_val_rows"])}
    captured = (vk1, tk1, *(rows for _, rows in task_k1.values()))
    kernels = [{
        "name": "greedy_nms", "route": "cuda",
        "source": "ultralytics_pro_tpu_torch/csrc/greedy_nms.cu",
        "replaces": "ultralytics_pro_tpu/kernels/nms_pallas.py:79",
        "tpu_kernel": "ultralytics_pro_tpu/kernels/nms_pallas.py:pallas_greedy_nms",
        "launches": launches,
        "max_mismatch": max(c["max_mismatch"] for c in (*k1, *captured)),
        "max_abs_err": max(c["max_abs_err"] for c in (*k1, *captured)),
        "gather_mismatch_vs_plain": sum(c.get("gather_mismatch_vs_plain", 0) for c in captured),
        "ms": pred["ms"], "plain_ms": pred["plain_ms"],
        "bound_ms": pred["bound_ms"], "bound_by": pred["bound_by"],
        "library_ms": None,  # no single PyTorch call computes greedy NMS (no torchvision)
        "main_path_profiled_ms": k1_path_ms,
        "argmax_form_ops": pred["argmax_form_ops"],
        "unsorted_ms": pred["unsorted_ms"], "val_ms": val_size["ms"], "val_plain_ms": val_size["plain_ms"],
        "val_bound_ms": val_size["bound_ms"], "val_argmax_form_ops": val_size["argmax_form_ops"],
        "val_path_launches": val["k1_launches"], "val_path_profiled_ms": val["k1_profiled_ms_per_launch"],
        "val_real_rows_ms": vk1["ms"], "val_real_rows_plain_ms": vk1["plain_ms"],
        "val_real_rows_bound_ms": vk1["bound_ms"], "val_real_rows_bound_by": vk1["bound_by"],
        "val_real_rows_scanned": vk1["scanned_per_row"],
        "train_path_launches": train["k1_launches"], "train_path_profiled_ms": train["k1_profiled_ms_per_launch"],
        "train_path_rows_ms": tk1["ms"], "train_path_rows_plain_ms": tk1["plain_ms"],
        "train_path_rows_bound_ms": tk1["bound_ms"], "train_path_rows_bound_by": tk1["bound_by"],
        "train_path_rows_scanned": tk1["scanned_per_row"],
        **{f"{name}_{key}": rows[key] for name, (_, rows) in task_k1.items()
           for key in ("B", "K", "payload_width", "ms", "plain_ms", "bound_ms", "bound_by", "scanned_per_row")},
        **{f"{name}_path_launches": run["k1_launches"] for name, (run, _) in task_k1.items()},
        **{f"{name}_path_profiled_ms": run["k1_profiled_ms_per_launch"] for name, (run, _) in task_k1.items()},
        **{f"{short}_train_full_width_launches": task_train[short]["k1_launches"] for short in ("seg", "pose")},
        **{f"{short}_train_full_width_profiled_ms": task_train[short]["nms_profiled_ms_per_val_batch"]
           for short in ("seg", "pose")},
    }, {
        "name": "msda_sample_fused", "route": "cuda",
        "source": "ultralytics_pro_tpu_torch/csrc/msda_sample.cu",
        "replaces": "ultralytics_pro_tpu/kernels/msda_pallas.py:52",
        "tpu_kernel": "ultralytics_pro_tpu/kernels/msda_pallas.py:msda_sample_pallas (with msda_flatten_coords:83)",
        "launches": k2_launches, "max_abs_err": max(c["max_abs_err"] for c in (*k2, rt_val["k2_on_val_inputs"])),
        "ms": k2[0]["ms"], "plain_ms": k2[0]["plain_ms"], "bound_ms": k2[0]["bound_ms"],
        "bound_by": k2[0]["bound_by"], "library_ms": k2[0]["library_ms"],  # F.embedding_bag, gather part
        "main_path_profiled_ms": k2_path_ms,
        "batch16_ms": k2[1]["ms"], "batch16_plain_ms": k2[1]["plain_ms"],
        "batch16_bound_ms": k2[1]["bound_ms"], "batch16_library_ms": k2[1]["library_ms"],
        "val_path_launches": rt_val["k2_launches"], "val_path_profiled_ms": rt_val["k2_profiled_ms_per_launch"],
        "val_path_max_abs_err": rt_val["k2_on_val_inputs"]["max_abs_err"],
        **{f"val_path_{key}": rt_val["k2_on_val_inputs"][key]
           for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        "train_path_launches": rt_train["k2_launches"]["forward"],
        "train_path_profiled_ms": rt_train["k2_profiled_ms_per_launch"],
        "train_path_max_abs_err": rt_train["k2_on_train_inputs"]["max_abs_err"],
        **{f"train_path_{key}": rt_train["k2_on_train_inputs"][key]
           for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
    }, {
        "name": "msda_sample_fused_backward", "route": "cuda",
        "source": "ultralytics_pro_tpu_torch/csrc/msda_sample.cu",
        "replaces": "ultralytics_pro_tpu/kernels/msda_pallas.py:52",
        "tpu_kernel": "the gradient of ultralytics_pro_tpu/kernels/msda_pallas.py:msda_sample_pallas (the JAX "
                      "package has no backward kernel: it differentiates its XLA gather)",
        "launches": rt_train["k2_launches"]["backward"],
        "max_abs_err": max(c["max_abs_err"] for c in (*k2g, rt_train["k2_backward_on_train_inputs"])),
        **{key: rt_train["k2_backward_on_train_inputs"][key]
           for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "library_covers")},
        "main_path_profiled_ms": rt_train["k2_backward_profiled_ms_per_launch"],
        "synthetic_train_shape_ms": k2g[0]["ms"], "synthetic_train_shape_plain_ms": k2g[0]["plain_ms"],
        "synthetic_train_shape_bound_ms": k2g[0]["bound_ms"], "synthetic_train_shape_library_ms": k2g[0]["library_ms"],
    }]
    emit("total", seconds=time.perf_counter() - t_all)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
