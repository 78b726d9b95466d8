"""Where the port's predict time goes on one CUDA card.

    python3 tools/torch_predict_profile.py [--model yolov8s|yolov8s-seg|yolov8s-pose|yolov8s-obb|rtdetr-l|
                                                    yolov7|yolov7-anchor|yolov4-csp|yolor-csp|rtmdet-s]
                                           [--imgsz 640] [--reps 5]

(yolov8s-obb at its DOTAv1 size: --model yolov8s-obb --imgsz 1024)

Runs YOLO("<model>.yaml", device="cuda") or RTDETR("rtdetr-l.yaml",
device="cuda") (seeded random weights, in the predictors' full f32 with TF32
off) on chip_smoke.py's workload (its images, its `conf` for the YOLO models
and the default 0.25 for rtdetr-l, as its phases `main`, `seg`, `pose` and
`rtdetr` run them): `predict` on the 4 seeded images one at a time, and the
device function `predictor.run` at batch 1, 4 (the 4 images) and 16; for
yolov8s-seg also the postprocess of the 4 images' batch-1 outputs (the mask step on the card and
the copy of the masks to the host). Each is traced with torch.profiler over
`--reps` warm repetitions. Prints one JSON line per workload: wall ms per
call, device busy ms (sum of kernel times on the one stream), idle share and
kernel launches, device ms by category (chip_smoke.category: convolution,
matmul, batchnorm, layernorm, K1, K2, the rotated NMS's kernels, sort,
memcpy, other; for yolov8s-obb also the rotated NMS's ms and launches as
'scope') and the top
kernels by device time. The profiler adds host time, so wall ms and idle
share read high here; chip_smoke.py's phases `main` and `rtdetr` set the busy
time against unprofiled wall times.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import CONF, ROTATED_NMS_SCOPE, nvidia_smi, profile_window, seeded_images  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=("yolov8s", "yolov8s-seg", "yolov8s-pose", "yolov8s-obb", "rtdetr-l",
                                        "yolov7", "yolov7-anchor", "yolov4-csp", "yolor-csp", "rtmdet-s"),
                    default="yolov8s")
    ap.add_argument("--imgsz", type=int, default=640)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    from ultralytics_pro_tpu_torch import RTDETR, YOLO

    smi = nvidia_smi()
    imgs = seeded_images()
    if args.model == "rtdetr-l":
        model, kw = RTDETR("rtdetr-l.yaml", device="cuda", seed=0), {"imgsz": args.imgsz}
    else:
        model, kw = YOLO(f"{args.model}.yaml", device="cuda", seed=0), {"conf": CONF, "imgsz": args.imgsz}
    model.predict(imgs, **kw)
    pred = model.predictor
    batch = pred.preprocess(imgs)
    batch16 = batch.repeat(4, 1, 1, 1)
    batch1 = batch16[:1].contiguous()
    workloads = [("predict_4_images", lambda: model.predict(imgs, **kw)),
                 ("device_fn_batch1", lambda: pred.run(batch1)),
                 ("device_fn_batch4", lambda: pred.run(batch)),
                 ("device_fn_batch16", lambda: pred.run(batch16))]
    if args.model == "yolov8s-seg":
        outs = [pred.run(batch[i:i + 1]) for i in range(len(imgs))]
        shape = tuple(batch.shape[1:3])
        workloads.append(("postprocess_4_images", lambda: [pred.postprocess(o, shape, [im], ["x"])
                                                           for o, im in zip(outs, imgs)]))
    for name, fn in workloads:
        prof = profile_window(fn, args.reps, scope=ROTATED_NMS_SCOPE if args.model.endswith("obb") else None)
        print(json.dumps({"model": args.model, "imgsz": args.imgsz, "workload": name, "card": smi, **prof}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
