"""The CSP zoo phases of chip_smoke.py alone, on one CUDA card: RTMDet,
YOLOv7 (IDetect, the implicit anchor head, ISegment, IPose, IOBB),
YOLOv4-CSP and YOLOR-CSP; or, with --zoo att_maf_hyper, the yolov8-att,
MAF-YOLOv2 and Hyper-YOLO phases; or, with --zoo yolo11_bb, those of the
fourteen 11/ YAMLs (YOLO11 on whole backbones, Bi_FPN, the slim neck).

    python3 tools/torch_csp_zoo_phases.py [--phases csp_zoo_predict csp_zoo_train_parity ...]
    python3 tools/torch_csp_zoo_phases.py --zoo att_maf_hyper [--phases att_maf_hyper_predict ...]
    python3 tools/torch_csp_zoo_phases.py --zoo yolo11_bb [--phases yolo11_bb_predict ...]

Builds the kernels (csrc/, nvcc), then runs the named phases of
chip_smoke.csp_phases (all five by default, in its order) as chip_smoke.main
runs them: `csp_zoo_predict` (each of chip_smoke.CSP_PREDICT at 640 px, K1
once an image and bit for bit on the batch's rows, card against CPU),
`csp_zoo_obb_predict` (yolov7-obb at 1024 px through the rotated NMS, no
K1), `csp_zoo_val` (chip_smoke.CSP_VAL on the fixture's 16 images, card
against CPU), `csp_zoo_train_parity` (one step on card and CPU at 160 px)
and `csp_zoo_train` (yolov7, two epochs at 640 px on 64 images); with --zoo
att_maf_hyper those of chip_smoke.amh_phases: `att_maf_hyper_predict` (the
nine models, maf-yolov2s-mafobb at 1024), `att_maf_hyper_val`,
`att_maf_hyper_train_parity` and `att_maf_hyper_train` (yolov8s-att); with
--zoo yolo11_bb those of chip_smoke.bb_phases: `yolo11_bb_predict` (the
fourteen at scale s, 640 px), `yolo11_bb_val` (yolo11s-convnext, -swin,
-efficientformerv2), `yolo11_bb_train_parity` (swin, efficientformerv2,
ghostnetv2, lsknet at 160 px) and `yolo11_bb_train` (yolo11s-swin). Prints
one JSON line a phase and the card's nvidia-smi line, and exits non-zero if
a check fails or there is no card.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402

TABLES = {"csp": "csp_phases", "att_maf_hyper": "amh_phases", "yolo11_bb": "bb_phases"}  # --zoo -> chip_smoke's table


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--zoo", choices=tuple(TABLES), default="csp",
                    help="the table: chip_smoke.csp_phases, amh_phases or bb_phases")
    ap.add_argument("--phases", nargs="+", help="names of the table's phases (all by default)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_csp_zoo_phases: needs a CUDA card", file=sys.stderr)
        return 2
    from ultralytics_pro_tpu_torch import YOLO
    from ultralytics_pro_tpu_torch.engine.trainer import load_pickle
    from ultralytics_pro_tpu_torch.kernels import build, nms_cuda
    from ultralytics_pro_tpu_torch.ops import nms as ops_nms
    from ultralytics_pro_tpu_torch.utils import full_f32

    build.build()
    card, smi = torch.cuda.get_device_name(0), cs.nvidia_smi()
    runs = getattr(cs, TABLES[args.zoo])(YOLO, nms_cuda, ops_nms, full_f32, load_pickle, card, smi)
    names = args.phases or list(runs)
    if set(names) - set(runs):
        ap.error(f"unknown phases {sorted(set(names) - set(runs))}; the phases are {list(runs)}")
    t_all = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        for name in names:
            t0 = time.perf_counter()
            cs.emit(name, **runs[name](Path(tmp)), seconds=time.perf_counter() - t0)
    print(json.dumps({"phase": "total", "seconds": time.perf_counter() - t_all}), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
