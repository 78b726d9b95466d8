"""Where a train step's time goes on one CUDA card.

    python3 tools/torch_train_profile.py [--model yolov8s] [--imgsz 640] [--batch 16] [--reps 3]
    python3 tools/torch_train_profile.py --model yolov8s-seg    # or yolov8s-pose
    python3 tools/torch_train_profile.py --model yolov8s-obb --imgsz 1024
    python3 tools/torch_train_profile.py --layout channels_last  # the images' layout

Builds YOLO("<model>.yaml", device="cuda") with seeded random weights (the
YAML's classes) and its task's trainer with the JAX package's default
arguments, and makes one seeded batch of uint8 images with 8 objects an
image: boxes, and segment's masks (each box filled on the mask grid),
pose's keypoints (the head's shape, some invisible) or obb's rotated
boxes. Traces,
with torch.profiler over `--reps` warm repetitions, a micro-batch as the
training loop runs it (the host batch copied up, forward, loss, backward,
the loss parts pulled to the host) without and with the optimizer step
(clip, 3-group SGD, EMA), in full f32 with TF32 off as the trainer runs
it, and the criterion alone (TAL and the loss, forward and backward to
the head's outputs: the task's criterion); `--layout channels_last` feeds
the images in channels-last strides instead of the trainer's contiguous
NCHW. Prints one JSON line per workload: wall ms, device busy ms, idle share,
kernel launches, device ms by category (chip_smoke.category: convolution,
batchnorm, optimizer, sort, memcpy, other elementwise and reduce) and the
`--top` kernels. The profiler adds host time, so wall ms and idle share read high
here; chip_smoke.py's phase `train` sets busy time against unprofiled wall
time.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import detached, nvidia_smi, profile_window  # noqa: E402


def seeded_batch(batch: int, imgsz: int, task: str = "detect", kpt_shape=(17, 3), max_gt: int = 128,
                 boxes: int = 8, nc: int = 80) -> dict:
    """A collated host batch: uint8 BGR images, boxes of 2-40% of the image
    (obb: turned by an angle in [-pi/4, 3pi/4)), and the task's masks or
    keypoints."""
    rng = np.random.default_rng(0)
    cls = np.zeros((batch, max_gt), np.float32)
    mask = np.zeros((batch, max_gt), bool)
    cls[:, :boxes] = rng.integers(0, nc, (batch, boxes))
    wh = rng.uniform(0.02, 0.4, (batch, boxes, 2))
    xywh = np.concatenate([rng.uniform(wh / 2, 1 - wh / 2), wh], -1)
    mask[:, :boxes] = True
    out = {"img": rng.integers(0, 256, (batch, imgsz, imgsz, 3), dtype=np.uint8), "cls": cls, "mask_gt": mask}
    width = 5 if task == "obb" else 4
    out["bboxes"] = np.zeros((batch, max_gt, width), np.float32)
    out["bboxes"][:, :boxes, :4] = xywh
    if task == "obb":
        out["bboxes"][:, :boxes, 4] = rng.uniform(-np.pi / 4, 3 * np.pi / 4, (batch, boxes))
    if task == "segment":
        m = imgsz // 4
        out["masks"] = np.zeros((batch, max_gt, m, m), np.float32)
        for i in range(batch):
            for j, (x, y, w, h) in enumerate(xywh[i] * m):
                out["masks"][i, j, int(y - h / 2):int(y + h / 2) + 1, int(x - w / 2):int(x + w / 2) + 1] = 1.0
    if task == "pose":
        k, nd = kpt_shape
        kp = np.zeros((batch, max_gt, k, nd), np.float32)
        offsets = rng.uniform(-0.5, 0.5, (batch, boxes, k, 2)) * xywh[:, :, None, 2:]
        kp[:, :boxes, :, :2] = xywh[:, :, None, :2] + offsets
        if nd == 3:
            kp[:, :boxes, :, 2] = rng.integers(0, 3, (batch, boxes, k))
        out["keypoints"] = kp
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="yolov8s")
    ap.add_argument("--imgsz", type=int, default=640)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--top", type=int, default=40, help="kernels listed per workload")
    ap.add_argument("--layout", choices=("contiguous", "channels_last"), default="contiguous",
                    help="the images' memory layout (the trainer's is contiguous)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    from ultralytics_pro_tpu_torch import YOLO
    from ultralytics_pro_tpu_torch.cfg import DEFAULT_CFG_DICT
    from ultralytics_pro_tpu_torch.models import task_map
    from ultralytics_pro_tpu_torch.utils import full_f32

    smi = nvidia_smi()
    model = YOLO(f"{args.model}.yaml", device="cuda", seed=0)
    head = model.model.model[-1]
    host = seeded_batch(args.batch, args.imgsz, model.task, getattr(head, "kpt_shape", (17, 3)), nc=model.model.nc)
    with tempfile.TemporaryDirectory() as tmp:
        tr = task_map[model.task]["trainer"](model.model.train(), {**DEFAULT_CFG_DICT, "batch": args.batch,
                                                                   "imgsz": args.imgsz, "project": tmp})
        lrs, mom = [tr.lr0] * 3, tr.momentum
        if args.layout == "channels_last":
            put = tr.put_batch
            tr.put_batch = lambda b: {**(d := put(b)), "img": d["img"].contiguous(memory_format=torch.channels_last)}
        dev = tr.put_batch(host)
        with torch.no_grad(), full_f32():
            out = detached(tr.model(dev["img"]))

        def loss_and_tal():  # the criterion (TAL included) and its backward to the head's outputs, nothing else
            with full_f32():
                total, _ = tr.criterion(detached(out, grad=True), dev, dev["img"].shape[2:])
                total.backward()
            return total

        def micro(do_step):
            _, parts = tr.step(tr.put_batch(host), lrs, mom, do_step)
            return torch.stack(list(parts.values())).tolist()

        for name, fn in (("micro_batch", lambda: micro(False)),
                         ("micro_batch_with_optimizer_step", lambda: micro(True)),
                         ("loss_and_tal_with_backward", loss_and_tal)):
            print(json.dumps({"model": args.model, "imgsz": args.imgsz, "batch": args.batch, "workload": name,
                              "layout": args.layout, "card": smi, **profile_window(fn, args.reps, top=args.top)}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
