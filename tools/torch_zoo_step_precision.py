"""How far one zoo model's train step moves on the card, and under which
convolution algorithms; with --layers, how far its float64 train-mode
forward moves layer by layer, and how much of that the images' float32
division makes.

    python3 tools/torch_zoo_step_precision.py gelan-c-dseg yolo11n   # on a machine with a CUDA card
    python3 tools/torch_zoo_step_precision.py --layers yolor-csp yolov7

Runs chip_smoke.py's zoo_one_step (the seeded model at nc 3, 8 fixture
images of its task's set at 160 px, one optimizer step through
YOLO(...).train) for each named model, with the images made on the host in
the step's dtype (host_images), so that every run steps from the same
inputs: on the CPU in float32, and in
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

With --layers it first counts the grey levels 0-255 whose
`x.float() / 255.0` differs between the card and the CPU (the card divides
a tensor by a scalar through its reciprocal). Then, for each named detect
model (built once on the CPU and copied to the card, both in float64), it
takes the first batch of 8 images of the detect fixture set at 160 px as
the trainer loads it and runs one train-mode forward and v8DetectionLoss on
both devices, with the images made two ways: as the trainer makes them on
its device (float32 division, then float64) and in float64 from the uint8
batch. One JSON line per model and way: each layer's largest difference
relative to the CPU output's largest magnitude, the head maps', and both
devices' loss parts.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402


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


def layer_images(host_img: np.ndarray, device: str, way: str) -> torch.Tensor:
    """The batch's images on device in float64, made `way`: 'trainer' (its
    float32 division on the device) or 'float64' (from the uint8 values)."""
    from ultralytics_pro_tpu_torch.engine.trainer import device_images

    if way == "trainer":
        return device_images(host_img, torch.device(device)).double()
    x = torch.from_numpy(host_img).to(device).flip(-1)
    return x.permute(0, 3, 1, 2).double().contiguous() / 255.0


def forward(net, x, batch):
    """Each layer's train-mode output but the head's, the head's maps and the loss parts."""
    from ultralytics_pro_tpu_torch.utils.loss import v8DetectionLoss

    acts = {}
    hooks = [layer.register_forward_hook(lambda mod, i, o, k=layer.i: acts.__setitem__(k, o.detach().cpu()))
             for layer in net.model[:-1]]
    try:
        with torch.no_grad():
            feats = net(x)
    finally:
        for h in hooks:
            h.remove()
    crit = v8DetectionLoss(nc=net.nc, reg_max=16, strides=net.stride.tolist(),
                           hyp={"box": 7.5, "cls": 0.5, "dfl": 1.5})
    _, parts = crit(feats, batch, tuple(x.shape[2:]))
    return acts, [f.cpu() for f in feats], {k: float(v) for k, v in parts.items()}


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max() / b.abs().max())


def layers(models) -> None:
    """The --layers report (module docstring)."""
    from ultralytics_pro_tpu_torch import YOLO
    from ultralytics_pro_tpu_torch.data import DataLoader, YOLODataset, check_det_dataset

    grey = torch.arange(256, dtype=torch.uint8)
    differ = int((grey.float() / 255.0 != (grey.cuda().float() / 255.0).cpu()).sum())
    print(json.dumps({"grey_levels_whose_division_by_255_differs_card_vs_cpu": differ, "of": 256}), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        data = Path(tmp) / "set" / "data.yaml"
        cs.fixture_train_set(data.parent, cs.TRAIN_PARITY_IMAGES, "torch_val_synth")
        d = check_det_dataset(str(data))
        host = next(iter(DataLoader(YOLODataset(d["train"], imgsz=160, data=d, task="detect"),
                                    batch_size=cs.TRAIN_PARITY_IMAGES, workers=0, max_gt=32)))
    for name in models:
        cpu = cs.zoo_yolo(YOLO, name, "cpu", 160, nc=3)  # an MHSA model bound at the batch's 160 px
        card = cs.moved(cpu, "cuda")
        nets = {"cpu": cpu.model.double().train(), "cuda": card.model.double().train()}
        for way in ("trainer", "float64"):
            out = {}
            for dev, net in nets.items():
                batch = {k: torch.from_numpy(np.asarray(host[k])).to(dev) for k in ("cls", "bboxes", "mask_gt")}
                out[dev] = forward(net, layer_images(host["img"], dev, way), batch)
            (a_cpu, f_cpu, p_cpu), (a_card, f_card, p_card) = out["cpu"], out["cuda"]
            print(json.dumps({"model": name, "images": way,
                              "layers_rel_diff": {k: rel(a_card[k], a_cpu[k]) for k in sorted(a_cpu)},
                              "head_maps_rel_diff": [rel(g, c) for g, c in zip(f_card, f_cpu)],
                              "loss_cpu": p_cpu, "loss_card": p_card}), flush=True)
    print(cs.nvidia_smi(), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("models", nargs="+")
    ap.add_argument("--threads", type=int, default=8)
    ap.add_argument("--layers", action="store_true", help="the float64 forward layer by layer (module docstring)")
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    if args.layers:
        layers(args.models)
        return 0
    from ultralytics_pro_tpu_torch import YOLO
    from ultralytics_pro_tpu_torch.engine.trainer import load_pickle

    f32, f64 = torch.float32, torch.float64
    cudnn = torch.backends.cudnn
    card_runs = {"card_f32_cudnn_benchmark": lambda: cudnn.flags(enabled=True, benchmark=True),
                 "card_f32_cudnn_deterministic": lambda: cudnn.flags(enabled=True, deterministic=True),
                 "card_f32_cudnn_off": lambda: cudnn.flags(enabled=False)}
    smi = cs.nvidia_smi()
    with tempfile.TemporaryDirectory() as tmp:
        for name in args.models:
            out, fft = {}, {}
            for run, device, dtype in (("cpu_f32", "cpu", f32), ("cpu_f64", "cpu", f64), ("card_f64", "cuda", f64)):
                out[run], _ = cs.zoo_one_step(YOLO, load_pickle, Path(tmp) / run, name, device, dtype,
                                              host_images=True)
            with conv_kernels(fft):
                out["card_f32"], _ = cs.zoo_one_step(YOLO, load_pickle, Path(tmp) / "card_f32", name, "cuda",
                                                     host_images=True)
            for run, flags in card_runs.items():
                with flags():
                    out[run], _ = cs.zoo_one_step(YOLO, load_pickle, Path(tmp) / run, name, "cuda",
                                                  host_images=True)
            for run in out:
                for against in ("cpu_f64", "cpu_f32"):
                    if run != against and not (run == "cpu_f64" and against == "cpu_f32"):
                        print(json.dumps({"model": name, "run": run, "against": against,
                                          **cs.rtdetr_step_diffs(out[run], out[against])}), flush=True)
            print(json.dumps({"model": name, "card_f32_fft_or_winograd_kernels": fft,
                              "tolerance": cs.ZOO_TRAIN_PARITY_TOL, "nvidia_smi": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
