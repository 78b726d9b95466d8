"""How far one rtdetr-l train step moves under rounding, and why.

    python3 tools/torch_rtdetr_step_precision.py            # the CPU runs
    python3 tools/torch_rtdetr_step_precision.py --card     # and the card's f32 step

Runs chip_smoke.py's rtdetr_one_step (seeded rtdetr-l at nc 3, 8 fixture
images at 160 px, one optimizer step through RTDETR(...).train) several
times on the CPU: in float64, the reference; in float32 as the trainer runs
it; in float32 with the images in channels-last strides, the layout the
trainer passed before it made them contiguous; and in float64 with the
images multiplied by (1 + eps * N(0, 1)) for eps 1e-7, 1e-9 and 1e-11, which
shows how far the step itself moves when its input moves by about one f32
rounding; then in float32 with one of K2's gradients (value, locs, attn)
multiplied by 0.9, the size of fault the parity check should see. With
--card, also the card's float32 step, in the trainer's contiguous layout
and in channels-last. Every run replays the
first run's top-k selection and matching (chip_smoke.replayed_decisions), so
only rounding differs. Prints one JSON line per run with
chip_smoke.rtdetr_step_diffs against the float64 step (loss parts relative;
params, EMA and BN statistics against the tree's largest magnitude; the
momentum buffers, the step's clipped gradient, as the tree's and the worst
leaf's relative L2 distance; the faulted runs against the float32 step),
and, with --card, the card's steps against the float64 step and against the
CPU's float32 step, which chip_smoke.py's rtdetr_train_parity holds to
RTDETR_TRAIN_PARITY_TOL. The CPU runs take about 10 s each at 8 threads.
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

from chip_smoke import (TRAIN_PARITY_IMAGES, fixture_train_set, nvidia_smi,  # noqa: E402
                        rtdetr_one_step, rtdetr_step_diffs)


@contextlib.contextmanager
def images_as(trainer_cls, dtype: torch.dtype, eps: float = 0.0, layout: torch.memory_format | None = None):
    """The trainer's device images in dtype, times (1 + eps * N(0, 1)) from a
    seeded generator, in the given memory layout (None: the trainer's)."""
    put = trainer_cls.put_batch

    def images(self, batch):
        out = put(self, batch)
        fmt = layout or (torch.channels_last if out["img"].is_contiguous(memory_format=torch.channels_last)
                         else torch.contiguous_format)
        img = out["img"].to(dtype)
        if eps:
            g = torch.Generator(device="cpu").manual_seed(1)
            img = img * (1 + eps * torch.randn(img.shape, generator=g, dtype=torch.float64).to(img))
        out["img"] = img.contiguous(memory_format=fmt)
        return out

    trainer_cls.put_batch = images
    try:
        yield
    finally:
        trainer_cls.put_batch = put


@contextlib.contextmanager
def k2_gradient_scaled(part: str, by: float):
    """K2's plain version with one of its gradients (value, locs or attn)
    multiplied by `by`: a fault of the size the parity check should see."""
    from ultralytics_pro_tpu_torch.kernels import msda_cuda
    from ultralytics_pro_tpu_torch.nn.modules import transformer

    scale = {"value": 1.0, "locs": 1.0, "attn": 1.0, part: by}

    class Scaled(torch.autograd.Function):
        @staticmethod
        def forward(ctx, value, locs, attn, shapes):
            ctx.shapes = shapes
            ctx.save_for_backward(value, locs, attn)
            return msda_cuda.msda_sample_fused_plain(value, shapes, locs, attn)

        @staticmethod
        def backward(ctx, grad_out):
            grads = msda_cuda.msda_sample_fused_backward_plain(*ctx.saved_tensors[:1], ctx.shapes,
                                                               *ctx.saved_tensors[1:], grad_out)
            return (*(g * scale[k] for g, k in zip(grads, ("value", "locs", "attn"))), None)

    fused = transformer.msda_sample_fused
    transformer.msda_sample_fused = lambda value, shapes, locs, attn: Scaled.apply(value, locs, attn, shapes)
    try:
        yield
    finally:
        transformer.msda_sample_fused = fused


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--card", action="store_true", help="also run the float32 step on the CUDA card")
    ap.add_argument("--threads", type=int, default=8)
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    from ultralytics_pro_tpu_torch import RTDETR
    from ultralytics_pro_tpu_torch.engine.trainer import load_pickle
    from ultralytics_pro_tpu_torch.models.rtdetr import RTDETRTrainer
    from ultralytics_pro_tpu_torch.nn.modules import head
    from ultralytics_pro_tpu_torch.nn.tasks import yaml_model_load
    from ultralytics_pro_tpu_torch.utils import detr_loss

    f32, f64, nhwc = torch.float32, torch.float64, torch.channels_last
    runs = [("cpu_f32", "cpu", f32, 0.0, None), ("cpu_f64", "cpu", f64, 0.0, None),
            ("cpu_f32_channels_last", "cpu", f32, 0.0, nhwc)]
    runs += [(f"cpu_f64_input_noise_{e:g}", "cpu", f64, e, None) for e in (1e-7, 1e-9, 1e-11)]
    runs += [("card_f32", "cuda", f32, 0.0, None), ("card_f32_channels_last", "cuda", f32, 0.0, nhwc)] if args.card else []
    cfg = {**yaml_model_load("rtdetr-l.yaml"), "nc": 3}
    out, record = {}, None
    with tempfile.TemporaryDirectory() as tmp:
        data = fixture_train_set(Path(tmp) / "set", TRAIN_PARITY_IMAGES)
        for name, device, dtype, eps, cl in runs:
            with images_as(RTDETRTrainer, dtype, eps, cl):
                out[name], decided = rtdetr_one_step(RTDETR, load_pickle, head, detr_loss, cfg, data,
                                                     Path(tmp) / name, device, record=record, dtype=dtype)
            record = record or decided["own"]
        for part in ("value", "locs", "attn"):  # the check's reach: one K2 gradient 10% off
            with k2_gradient_scaled(part, 0.9):
                out[f"cpu_f32_k2_grad_{part}_x0.9"], _ = rtdetr_one_step(
                    RTDETR, load_pickle, head, detr_loss, cfg, data, Path(tmp) / part, "cpu", record=record)
    for name in out:
        if name != "cpu_f64" and not name.startswith("card") and "k2_grad" not in name:
            print(json.dumps({"run": name, "against": "cpu_f64", **rtdetr_step_diffs(out[name], out["cpu_f64"])}))
        elif "k2_grad" in name:
            print(json.dumps({"run": name, "against": "cpu_f32", **rtdetr_step_diffs(out[name], out["cpu_f32"])}))
    if args.card:
        smi = nvidia_smi()
        for name in ("card_f32", "card_f32_channels_last"):
            for against in ("cpu_f64", "cpu_f32"):
                print(json.dumps({"run": name, "against": against,
                                  **rtdetr_step_diffs(out[name], out[against]), "nvidia_smi": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
