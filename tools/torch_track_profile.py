"""The `track` phase of chip_smoke.py alone, on one CUDA card.

    python3 tools/torch_track_profile.py

Builds the kernels (csrc/, nvcc), then runs chip_smoke.track_phase: the
panned fixture sequence tracked on the card and on the CPU (ids equal,
boxes within chip_smoke.TRACK_TOL), seeded yolov8s tracking 640 x 640
frames with every detection reaching the association and most living on
as tracks (ms a frame by part, the idle share, K1 once a frame and on its
rows), and predict_files of 128 PNGs (images/s, the loader's host ms a
batch and `imread`'s ms a file, also on the fixture PNGs as cv2 wrote
them, K1 once a batch and on its rows; the trained fixture model against
its per-image predict). Prints the
card's nvidia-smi line, one JSON line with the phase's fields and its
seconds, and exits non-zero if a check fails or there is no card.
"""

from __future__ import annotations

import json
import sys
import tempfile
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_track_profile: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke
    from ultralytics_pro_tpu_torch import YOLO
    from ultralytics_pro_tpu_torch.kernels import build, nms_cuda
    from ultralytics_pro_tpu_torch.nn.tasks import yaml_model_load
    from ultralytics_pro_tpu_torch.ops import nms as ops_nms

    build.build()
    card, smi = torch.cuda.get_device_name(0), chip_smoke.nvidia_smi()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        out = chip_smoke.track_phase(YOLO, yaml_model_load, nms_cuda, ops_nms, Path(tmp), card, smi)
    print(smi, flush=True)
    print(json.dumps({"phase": "track", **out, "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
