"""Where an augmented sample's host time goes, on the machine it runs on (no card needed).

    python3 tools/torch_aug_host_profile.py [--imgsz 640] [--samples 16] [--task detect]

Builds the train set of `chip_smoke.py`'s `aug_train` phase (the 16 detect
fixture PNGs 8 times over, or a task's fixture set with `--task segment`,
`pose`, `obb`) as `YOLODataset(augment=True)` with the default gains, and
reads `--samples` samples on one thread under cProfile: the cumulative ms
a sample of the PNG reader (`data/image_io.imread`, its unfilter loop in
Python), the load's bilinear resize (`imgproc.resize_linear`), the warp
(`imgproc.warp_affine`, `warp_perspective`), the HSV conversions, the
letterbox, and each transform's call (`Compose` the whole pipeline,
Mosaic's with its three extra reads: the parts nest), and the share of the
sample each takes (cProfile's own cost included). Then one pass of the
train loader (8 threads, batch 16) with Mosaic on and off: host ms a batch.
Prints one JSON line. The PNG reader holds the GIL in its unfilter loop;
the numpy parts release it for their array work, so the two scale
differently with threads.
"""

from __future__ import annotations

import argparse
import cProfile
import json
import pstats
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

FUNCS = {  # (module file, function) -> part
    ("image_io.py", "imread"): "png_read",
    ("imgproc.py", "resize_linear"): "load_resize",
    ("imgproc.py", "warp_affine"): "warp",
    ("imgproc.py", "warp_perspective"): "warp",
    ("imgproc.py", "bgr2hsv"): "hsv_convert",
    ("imgproc.py", "hsv2bgr"): "hsv_convert",
    ("augment.py", "letterbox_labels"): "letterbox",
}


def transform_lines() -> dict:
    """(first line of each transform's __call__ in data/augment.py) -> class name."""
    import inspect

    from ultralytics_pro_tpu_torch.data import augment

    return {cls.__call__.__code__.co_firstlineno: name for name, cls in inspect.getmembers(augment, inspect.isclass)
            if cls.__module__ == augment.__name__ and "__call__" in vars(cls)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--imgsz", type=int, default=640)
    ap.add_argument("--samples", type=int, default=16)
    ap.add_argument("--task", default="detect", choices=("detect", "segment", "pose", "obb"))
    a = ap.parse_args()

    import chip_smoke
    from ultralytics_pro_tpu_torch.cfg import DEFAULT_CFG_DICT, HYP_KEYS
    from ultralytics_pro_tpu_torch.data import YOLODataset, check_det_dataset

    src = {"detect": "torch_val_synth", "segment": "torch_val_synth_segment", "pose": "torch_val_synth_pose",
           "obb": "torch_val_synth_obb"}[a.task]
    hyp = {k: DEFAULT_CFG_DICT[k] for k in HYP_KEYS}
    with tempfile.TemporaryDirectory() as tmp:
        data = chip_smoke.val_set_640(Path(tmp) / "set", src, nc=3)
        data.write_text(data.read_text().replace("val: images/val", "train: images/val\nval: images/val\n"
                                                 + ("kpt_shape: [5, 3]\n" if a.task == "pose" else "")))
        d = check_det_dataset(str(data))
        ds = YOLODataset(d["train"], imgsz=a.imgsz, augment=True, hyp=hyp, data=d, task=a.task)
        ds[0]  # imports and first calls out of the profile
        prof = cProfile.Profile()
        t0 = time.perf_counter()
        prof.enable()
        for i in range(a.samples):
            ds[i % len(ds)]
        prof.disable()
        sample_s = (time.perf_counter() - t0) / a.samples
        lines = transform_lines()
        parts = {}
        for (file, line, func), (_, _, _, cum, _) in pstats.Stats(prof).stats.items():
            name = Path(file).name
            part = FUNCS.get((name, func))
            if name == "augment.py" and func == "__call__" and line in lines:
                part = lines[line]
            if part:
                parts[part] = parts.get(part, 0.0) + cum / a.samples
        loader = {}
        for closed in (False, True):
            fresh = YOLODataset(d["train"], imgsz=a.imgsz, augment=True, hyp=hyp, data=d, task=a.task)
            loader["without_mosaic" if closed else "with_mosaic"] = chip_smoke.loader_ms_per_batch(
                fresh, 16, close_mosaic=closed)
    print(json.dumps({"tool": "torch_aug_host_profile", "task": a.task, "imgsz": a.imgsz, "samples": a.samples,
                      "one_thread_ms_per_sample": sample_s * 1e3,
                      "ms_per_sample_by_part": {k: v * 1e3 for k, v in sorted(parts.items())},
                      "share_by_part": {k: v / sample_s for k, v in sorted(parts.items())},
                      "loader_host_ms_per_batch_8_threads": loader}), flush=True)


if __name__ == "__main__":
    main()
