"""How far one zoo model's train step moves on the card, and under which
convolution algorithms.

    python3 tools/torch_zoo_step_precision.py gelan-c-dseg yolo11n   # on a machine with a CUDA card

Runs chip_smoke.py's zoo_one_step (the seeded model at nc 3, 8 fixture
images of its task's set at 160 px, one optimizer step through
YOLO(...).train) for each named model: on the CPU in float32, and in
float64, the reference; on the card in
float64, and in float32 with cuDNN as the trainer finds it, with cuDNN's
benchmark mode, with cuDNN's deterministic mode, and with cuDNN off (torch's
own CUDA convolutions). The default float32 step runs inside torch.profiler,
which lists the cuDNN FFT and Winograd kernels it launched. Prints one JSON
line per run and reference with chip_smoke.rtdetr_step_diffs (loss parts
relative; params, EMA and BN statistics against the tree's largest
magnitude; the momentum buffers, the step's gradient, as the tree's and the
worst leaf's relative L2 distance), which zoo_train_parity holds to
ZOO_TRAIN_PARITY_TOL, the card's step against the CPU's in the model's
ZOO_TRAIN_PARITY_DTYPE.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import tempfile
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import ZOO_TRAIN_PARITY_TOL, nvidia_smi, rtdetr_step_diffs, zoo_one_step  # noqa: E402


@contextlib.contextmanager
def conv_kernels(seen: dict):
    """torch.profiler over the block; seen gets the launches of each cuDNN
    FFT or Winograd kernel."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        yield
    for ev in prof.key_averages():
        if any(w in ev.key.lower() for w in ("fft", "winograd")):
            seen[ev.key[:100]] = int(ev.count)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("models", nargs="+")
    ap.add_argument("--threads", type=int, default=8)
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    from ultralytics_pro_tpu_torch import YOLO
    from ultralytics_pro_tpu_torch.engine.trainer import load_pickle

    f32, f64 = torch.float32, torch.float64
    cudnn = torch.backends.cudnn
    card_runs = {"card_f32_cudnn_benchmark": lambda: cudnn.flags(enabled=True, benchmark=True),
                 "card_f32_cudnn_deterministic": lambda: cudnn.flags(enabled=True, deterministic=True),
                 "card_f32_cudnn_off": lambda: cudnn.flags(enabled=False)}
    smi = nvidia_smi()
    with tempfile.TemporaryDirectory() as tmp:
        for name in args.models:
            out, fft = {}, {}
            for run, device, dtype in (("cpu_f32", "cpu", f32), ("cpu_f64", "cpu", f64), ("card_f64", "cuda", f64)):
                out[run], _ = zoo_one_step(YOLO, load_pickle, Path(tmp) / run, name, device, dtype)
            with conv_kernels(fft):
                out["card_f32"], _ = zoo_one_step(YOLO, load_pickle, Path(tmp) / "card_f32", name, "cuda")
            for run, flags in card_runs.items():
                with flags():
                    out[run], _ = zoo_one_step(YOLO, load_pickle, Path(tmp) / run, name, "cuda")
            for run in out:
                for against in ("cpu_f64", "cpu_f32"):
                    if run != against and not (run == "cpu_f64" and against == "cpu_f32"):
                        print(json.dumps({"model": name, "run": run, "against": against,
                                          **rtdetr_step_diffs(out[run], out[against])}), flush=True)
            print(json.dumps({"model": name, "card_f32_fft_or_winograd_kernels": fft,
                              "tolerance": ZOO_TRAIN_PARITY_TOL, "nvidia_smi": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
