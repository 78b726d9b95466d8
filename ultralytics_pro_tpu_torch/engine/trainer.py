"""Trainer: the training loop on one device, for detect, segment, pose, obb and classify
(RT-DETR's trainer, `models/rtdetr.py:RTDETRTrainer`, subclasses it).

Counterpart of `ultralytics_pro_tpu/engine/trainer.py` (`param_group:35`,
`EarlyStopping:52`, `BaseTrainer:73` with `lr_lambda:135`, the step of
`build_train_step:146`, `train:241`, `save_checkpoint:433`,
`resume_from:500`, `save_pickle:508`, `load_pickle:517`,
`DetectionTrainer:522`, `SegmentationTrainer:620`, `_ClassifyCriterion:632`,
`ClassificationTrainer:645`, `PoseTrainer:659` and `OBBTrainer:676`), with
the JAX step's semantics kept exactly (the task trainers differ only in
their criterion, and classify's batch holds only the images and classes):

- a micro-batch's forward, loss and backward add its gradients to the
  parameters' `.grad`; the optimizer applies only on the micro-batches where
  `do_step` is true, every `accumulate` of them (warmup ramps it);
- the optimizer step clips the accumulated gradients at global norm 10.0
  (`scale = min(1, 10 / (norm + 1e-6))`), then runs Nesterov SGD over three
  groups, conv, linear and attention weights (decayed, by `weight_decay *
  batch * accumulate / nbs`), norm weights and biases (`param_group`): `torch.optim.SGD` with
  `foreach=True`, whose update `m = mu*m + g + wd*p; p -= lr*(g + wd*p + mu*m)`
  is the JAX step's;
- the EMA covers the parameters only and ticks on optimizer steps, with
  decay `0.9999 * (1 - exp(-updates / 2000))` computed in f32 as there. BN
  running statistics are not averaged: the epoch-end val and the saved `ema`
  use the EMA parameters with the live statistics.

The whole step runs under `utils.full_f32` (TF32 off, flags restored).

`multi_scale=True` (`_multi_scale:389-402`): each micro-batch ni takes a
size from the 7-rung ladder of multiples of 32 over [0.5, 1.5] x imgsz,
`random.Random(ni).choice`, and its uint8 images are resized on the model's
device where the size differs (`F.interpolate` bilinear with antialias, as
`jax.image.resize`'s bilinear; truncated to uint8 as `astype(jnp.uint8)`);
labels are normalised and stay. `remat=True` (`:156-176`): every layer before
the head runs under `torch.utils.checkpoint` (non-reentrant), its
activations recomputed in the backward, BatchNorm's running statistics
updated once (`nn/modules/conv.py:recomputing`). Images of 3 channels are
flipped BGR to RGB; other channel counts keep their band order (`:161`).

Checkpoints are the JAX package's pickle: numpy trees in flax layout
(`params`, `batch_stats`, `ema`, `momentum_buffer`) beside `ema_updates`,
`epoch`, `best_fitness`, `fitness`, `train_args`, `model_yaml`, `date` and
the git fields, through `utils/weights.py`, so either package resumes or
loads the other's. Left for later, each raising NotImplementedError:
`ckpt_format="orbax"` and more than one device (data parallel). The
wandb/MLflow integration callbacks are not ported.
"""

from __future__ import annotations

import math
import pickle
import random
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ultralytics_pro_tpu_torch.nn.modules.head import AnchorDetect, Detect
from ultralytics_pro_tpu_torch.utils import LOGGER, full_f32
from ultralytics_pro_tpu_torch.utils.callbacks import CallbackMixin, csv_logger_callbacks
from ultralytics_pro_tpu_torch.utils.files import get_latest_run, increment_path
from ultralytics_pro_tpu_torch.utils.git import GIT
from ultralytics_pro_tpu_torch.utils.weights import jax_to_torch_state_dict, torch_state_dict_to_jax

MULTI_SCALE_FACTORS = (0.5, 0.667, 0.833, 1.0, 1.167, 1.333, 1.5)


def param_group(module: nn.Module, leaf: str) -> int:
    """The JAX trainer's group of the flax leaf a parameter is carried to,
    by that leaf's name: `bias` 2 (attention's `in_proj_bias` among them),
    `scale` 1 (BatchNorm, LayerNorm and GroupNorm weights, and
    FocusedLinearAttention's bare `scale`), anything else 0 (decayed:
    kernels, embeddings, and bare params such as ShuffleAttention's `cbias`
    and `sbias`, whose names only end in "bias")."""
    if leaf in ("bias", "in_proj_bias"):
        return 2
    if leaf == "scale" or leaf == "weight" and isinstance(module, (nn.BatchNorm2d, nn.LayerNorm, nn.GroupNorm)):
        return 1
    return 0


class EarlyStopping:
    """Stop after `patience` epochs without a fitness improvement."""

    def __init__(self, patience: int = 100):
        self.best_fitness = 0.0
        self.best_epoch = 0
        self.patience = patience or float("inf")

    def __call__(self, epoch: int, fitness: Optional[float]) -> bool:
        if fitness is None:
            return False
        if fitness >= self.best_fitness:
            self.best_epoch = epoch
            self.best_fitness = fitness
        stop = (epoch - self.best_epoch) >= self.patience
        if stop:
            LOGGER.info(f"EarlyStopping: no improvement in last {self.patience} epochs.")
        return stop


class BaseTrainer(CallbackMixin):
    """Task-agnostic training loop; subclasses provide the criterion.

    model: the port's DetectionModel (or a task's), on the device it trains on."""

    def __init__(self, model: nn.Module, args: Dict):
        if str(args.get("ckpt_format", "pickle")) != "pickle":
            raise NotImplementedError(f"ckpt_format={args['ckpt_format']!r} is not implemented in "
                                      "ultralytics_pro_tpu_torch yet (ROADMAP.md queue 1, the orbax "
                                      "format); the pickle format is")
        self.model = model
        model.remat = bool(args.get("remat", False))
        self.device = next(model.parameters()).device
        cap = args.get("device")
        if isinstance(cap, int) and not isinstance(cap, bool) and cap > 1:
            raise NotImplementedError(f"train(device={cap}) asks for {cap} devices; data-parallel training "
                                      "is not implemented in ultralytics_pro_tpu_torch yet (ROADMAP.md "
                                      "queue 1 item 7); pass device=1 or None")
        want = None if cap is None or isinstance(cap, int) else torch.device(cap)
        if want is not None and (want.type != self.device.type or want.index not in (None, self.device.index)):
            raise ValueError(f"train(device={cap!r}): the model lives on {self.device}; choose the "
                             "device when the model is built (YOLO(..., device=...))")
        self.args = args
        self.epochs = int(args.get("epochs", 100))
        self.batch_size = int(args.get("batch", 16))
        self.imgsz = int(args.get("imgsz", 640))
        self.save_dir = Path(args.get("save_dir") or increment_path(
            Path(args.get("project") or "runs/detect") / (args.get("name") or "train")))
        self.wdir = self.save_dir / "weights"

        self.lr0 = float(args.get("lr0", 0.01))
        self.lrf = float(args.get("lrf", 0.01))
        self.momentum = float(args.get("momentum", 0.937))
        self.weight_decay = float(args.get("weight_decay", 0.0005))
        self.warmup_epochs = float(args.get("warmup_epochs", 3.0))
        self.warmup_momentum = float(args.get("warmup_momentum", 0.8))
        self.warmup_bias_lr = float(args.get("warmup_bias_lr", 0.1))
        self.cos_lr = bool(args.get("cos_lr", False))
        self.nbs = int(args.get("nbs", 64))
        self.multi_scale = bool(args.get("multi_scale", False))
        self.close_mosaic = int(args.get("close_mosaic", 10))
        self.ema_decay = 0.9999
        self.max_grad_norm = 10.0
        self.accumulate = max(round(self.nbs / self.batch_size), 1)
        self.weight_decay *= self.batch_size * self.accumulate / self.nbs  # decay scaled by effective batch

        self.stopper = EarlyStopping(patience=int(args.get("patience", 100)))
        self.init_callbacks()
        for event, cb in csv_logger_callbacks(self.save_dir).items():
            self.add_callback(event, cb)
        self.best_fitness = 0.0
        self.start_epoch = 0
        self.criterion = self.build_criterion()

        # trainable parameters in state_dict order (DFL's frozen bins are not)
        owners = {n: m for n, m in model.named_modules()}
        named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
        self.param_names = [n for n, _ in named]
        self.params = [p for _, p in named]
        groups: List[List[nn.Parameter]] = [[], [], []]
        for n, p in named:
            owner, _, leaf = n.rpartition(".")
            groups[param_group(owners[owner], leaf)].append(p)
        self.optimizer = torch.optim.SGD(
            [{"params": groups[0], "weight_decay": self.weight_decay},
             {"params": groups[1], "weight_decay": 0.0},
             {"params": groups[2], "weight_decay": 0.0}],
            lr=self.lr0, momentum=self.momentum, nesterov=True, foreach=True)
        self.ema = [p.detach().clone() for p in self.params]
        self.ema_updates = 0

    def lr_lambda(self, epoch: int) -> float:
        """Linear or cosine decay factor."""
        x = epoch / self.epochs
        if self.cos_lr:
            return ((1 - math.cos(x * math.pi)) / 2) * (self.lrf - 1) + 1
        return (1 - x) * (1.0 - self.lrf) + self.lrf

    def build_criterion(self):
        raise NotImplementedError

    # -- the step -------------------------------------------------------------
    def multi_scale_size(self, ni: int) -> int:
        """Micro-batch ni's image size under multi_scale."""
        ladder = sorted({max(32, round(self.imgsz * f / 32) * 32) for f in MULTI_SCALE_FACTORS})
        return random.Random(ni).choice(ladder)

    def put_batch(self, batch: Dict) -> Dict[str, torch.Tensor]:
        """Host batch -> tensors on the model's device; img as (B, C, H, W)
        floats in [0, 1], RGB where C is 3 (the JAX loss_fn's flip and
        scale), resized to the batch's `imgsz` where multi_scale set one;
        segment's masks and pose's keypoints where the batch has them."""
        out = {"img": device_images(batch["img"], self.device, batch.get("imgsz"))}
        for k in ("cls", "bboxes", "mask_gt", "masks", "keypoints"):
            if k in batch:
                out[k] = torch.from_numpy(np.asarray(batch[k])).to(self.device)
        return out

    def model_outputs(self, batch: Dict[str, torch.Tensor]):
        """The model's train-mode outputs for a device batch, as the criterion takes them."""
        return self.model(batch["img"])

    def step(self, batch: Dict[str, torch.Tensor], lr_by_group, momentum: float, do_step: bool):
        """One micro-batch: forward, loss and backward (gradients add up in
        `.grad`), then the optimizer step when do_step. Returns the loss
        total and parts, detached, on the device."""
        with full_f32():
            total, parts = self.criterion(self.model_outputs(batch), batch, batch["img"].shape[2:])
            total.backward()
            if do_step:
                self.optimizer_step(lr_by_group, momentum)
        return total.detach(), {k: v.detach() for k, v in parts.items()}

    def optimizer_step(self, lr_by_group, momentum: float) -> None:
        """Clip, 3-group Nesterov SGD, zero the gradients, tick the EMA."""
        torch.nn.utils.clip_grad_norm_(self.params, self.max_grad_norm, foreach=True)
        for group, lr in zip(self.optimizer.param_groups, lr_by_group):
            group["lr"], group["momentum"] = lr, momentum
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        self.ema_updates += 1
        u = np.float32(self.ema_updates)
        d = float(np.float32(self.ema_decay) * (np.float32(1) - np.exp(-u / np.float32(2000.0))))
        with torch.no_grad():
            torch._foreach_mul_(self.ema, d)
            torch._foreach_add_(self.ema, self.params, alpha=1 - d)

    def swap_ema(self) -> None:
        """Exchange the live parameters and the EMA (val, and the end of training)."""
        for i, p in enumerate(self.params):
            p.data, self.ema[i] = self.ema[i], p.data

    # -- main loop ------------------------------------------------------------
    def train(self, train_loader, val_fn=None):
        """train_loader yields collated host batches; val_fn(model with the
        EMA parameters, in eval mode) -> fitness float or None."""
        self.val_fn = val_fn
        self.wdir.mkdir(parents=True, exist_ok=True)
        if self.args.get("resume"):
            resume = self.args["resume"]
            path = resume if isinstance(resume, str) else (
                str(self.wdir / "last.ckpt") if (self.wdir / "last.ckpt").exists()
                else get_latest_run(str(self.save_dir.parent)))
            if path:
                ckpt = self.load_state(path)
                self.start_epoch = ckpt["epoch"] + 1
                self.best_fitness = ckpt.get("best_fitness") or 0.0
                LOGGER.info(f"resuming from {path} at epoch {self.start_epoch + 1}")
        nb = len(train_loader)
        # warmup iterations: a floor of 100, none at all when warmup_epochs is 0
        nw = max(round(self.warmup_epochs * nb), 100) if self.warmup_epochs > 0 else -1
        last_opt_step = -1

        LOGGER.info(f"Starting training for {self.epochs} epochs on {self.device}...")
        self.run_callbacks("on_train_start")
        t0 = time.time()
        self.opt_steps = 0  # optimizer steps applied
        self.loss_history = []  # per-epoch mean loss dicts
        self.epoch_train_seconds = []  # host seconds of each epoch's micro-batch loop
        for epoch in range(self.start_epoch, self.epochs):
            self._epoch = epoch
            self.model.train()
            self.run_callbacks("on_train_epoch_start")
            if epoch == self.epochs - self.close_mosaic:
                LOGGER.info("Closing dataloader mosaic")
                train_loader.reset()

            lf = self.lr_lambda(epoch)
            losses_sum: Dict[str, float] = {}
            t_epoch = time.perf_counter()
            for i, batch in enumerate(train_loader):
                ni = i + nb * epoch
                if ni <= nw:  # warmup: lr, momentum and accumulate ramp
                    xi = [0, nw]
                    accumulate = max(1, round(np.interp(ni, xi, [1, self.nbs / self.batch_size])))
                    lr_by_group = [
                        float(np.interp(ni, xi, [0.0, self.lr0 * lf])),
                        float(np.interp(ni, xi, [0.0, self.lr0 * lf])),
                        float(np.interp(ni, xi, [self.warmup_bias_lr, self.lr0 * lf])),
                    ]
                    momentum = float(np.interp(ni, xi, [self.warmup_momentum, self.momentum]))
                else:
                    accumulate = self.accumulate
                    lr_by_group = [self.lr0 * lf] * 3
                    momentum = self.momentum
                do_step = ni - last_opt_step >= accumulate
                if do_step:
                    last_opt_step = ni
                    self.opt_steps += 1
                if self.multi_scale:
                    batch = {**batch, "imgsz": self.multi_scale_size(ni)}
                dev = self.put_batch(batch)
                _, parts = self.step(dev, lr_by_group, momentum, do_step)
                for k, v in zip(parts, torch.stack(list(parts.values())).tolist()):
                    losses_sum[k] = losses_sum.get(k, 0.0) + v
            self.epoch_train_seconds.append(time.perf_counter() - t_epoch)

            self.epoch_losses = {k: v / nb for k, v in losses_sum.items()}
            self.loss_history.append(dict(self.epoch_losses))

            # NaN recovery: reload the last good checkpoint, up to 3 attempts
            if any(not np.isfinite(v) for v in self.epoch_losses.values()):
                self._nan_attempts = getattr(self, "_nan_attempts", 0) + 1
                ckpt_path = self.wdir / "last.ckpt"
                if self._nan_attempts > 3 or not ckpt_path.exists():
                    raise FloatingPointError(
                        f"non-finite loss {self.epoch_losses} (attempt {self._nan_attempts}); aborting")
                LOGGER.info(f"non-finite loss; restoring {ckpt_path} (attempt {self._nan_attempts}/3)")
                self.load_state(ckpt_path)
                continue

            # val with the EMA parameters and the live BN statistics
            self.model.eval()
            self.swap_ema()
            try:
                fitness = val_fn(self.model) if val_fn is not None else None
            finally:
                self.swap_ema()
            self.last_fitness = fitness
            self.run_callbacks("on_fit_epoch_end")

            self.save_checkpoint(epoch, fitness)
            if self.stopper(epoch, fitness):
                break
            if self.args.get("time") and (time.time() - t0) / 3600 > float(self.args["time"]):
                LOGGER.info(f"time limit {self.args['time']}h reached; stopping")
                break
            LOGGER.info(f"epoch {epoch + 1}: " + " ".join(f"{k}={v:.4f}" for k, v in self.epoch_losses.items())
                        + (f" fitness={fitness:.4f}" if fitness is not None else ""))

        self.run_callbacks("on_train_end")
        LOGGER.info(f"training complete in {(time.time() - t0) / 3600:.3f} hours; results in {self.save_dir}")
        self.swap_ema()  # leave the EMA parameters on the model
        self.model.eval()
        return self.model

    # -- checkpoints ----------------------------------------------------------
    def _tree(self, tensors) -> dict:
        """Tensors aligned with self.params -> a flax `params` tree of numpy arrays."""
        return torch_state_dict_to_jax(dict(zip(self.param_names, tensors)))["params"]

    def save_checkpoint(self, epoch: int, fitness: Optional[float]) -> None:
        """last.ckpt, best.ckpt when fitness is the best so far, and
        epochN.ckpt every save_period epochs: the JAX package's dict."""
        trees = torch_state_dict_to_jax(self.model.state_dict())
        moms = [self.optimizer.state[p].get("momentum_buffer") for p in self.params]
        ckpt = {
            "epoch": epoch,
            "best_fitness": self.best_fitness,
            "fitness": fitness,
            "params": trees["params"],
            "batch_stats": trees["batch_stats"],
            "ema": self._tree(self.ema),
            "ema_updates": int(self.ema_updates),
            "momentum_buffer": self._tree([torch.zeros_like(p) if m is None else m
                                           for p, m in zip(self.params, moms)]),
            "train_args": {k: v for k, v in self.args.items()
                           if isinstance(v, (int, float, str, bool, type(None)))},
            "model_yaml": dict(self.model.yaml),
            "date": time.strftime("%Y-%m-%d %H:%M:%S"),
        }
        ckpt.update(GIT(Path(__file__).parent).as_dict())  # the package's git state
        save_pickle(self.wdir / "last.ckpt", ckpt)
        if fitness is not None and fitness >= self.best_fitness:
            self.best_fitness = fitness
            save_pickle(self.wdir / "best.ckpt", ckpt)
        sp = int(self.args.get("save_period") or -1)
        if sp > 0 and (epoch + 1) % sp == 0:
            save_pickle(self.wdir / f"epoch{epoch + 1}.ckpt", ckpt)

    def load_state(self, path) -> dict:
        """Parameters, BN statistics, momentum, EMA and its count from a
        checkpoint of either package; gradients cleared. Returns the checkpoint."""
        ckpt = load_pickle(path)
        sd = jax_to_torch_state_dict({"params": ckpt["params"], "batch_stats": ckpt["batch_stats"]})
        self.model.load_state_dict({k: v.to(self.device) for k, v in sd.items()})
        self.optimizer.zero_grad(set_to_none=True)
        for name, tree in (("momentum_buffer", ckpt.get("momentum_buffer")), ("ema", ckpt.get("ema"))):
            if not tree:
                continue
            sd = jax_to_torch_state_dict({"params": tree})
            values = [sd[n].to(self.device) for n in self.param_names]
            if name == "ema":
                self.ema = values
            else:
                for p, m in zip(self.params, values):
                    self.optimizer.state[p]["momentum_buffer"] = m
        if not ckpt.get("ema"):
            self.ema = [p.detach().clone() for p in self.params]
        self.ema_updates = int(ckpt.get("ema_updates", 0))
        return ckpt

    def resume_from(self, ckpt_path) -> dict:
        """Parameters and BN statistics of a checkpoint onto the model, and
        the epoch to start from."""
        ckpt = load_pickle(ckpt_path)
        sd = jax_to_torch_state_dict({"params": ckpt["params"], "batch_stats": ckpt["batch_stats"]})
        self.model.load_state_dict({k: v.to(self.device) for k, v in sd.items()})
        self.start_epoch = ckpt["epoch"] + 1
        self.best_fitness = ckpt.get("best_fitness", 0.0)
        return ckpt


def save_pickle(path, obj) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(obj, f)


def resize_u8(x: torch.Tensor, size: int) -> torch.Tensor:
    """(B, H, W, C) uint8 -> (B, size, size, C) uint8 on its device: bilinear
    with antialias (`jax.image.resize(method="bilinear")`'s triangle filter),
    truncated as `astype(jnp.uint8)` truncates."""
    y = F.interpolate(x.permute(0, 3, 1, 2).float(), size=(size, size), mode="bilinear", align_corners=False,
                      antialias=True)
    return y.to(torch.uint8).permute(0, 2, 3, 1)


def device_images(img: np.ndarray, device: torch.device, size: Optional[int] = None) -> torch.Tensor:
    """A uint8 NHWC batch -> (B, C, H, W) floats in [0, 1] on device, first
    resized on the device to size x size where a size other than its height
    is given (multi_scale's `resize_u8`, on the uint8 values as the JAX
    trainer resizes them), flipped BGR to RGB where C is 3 (the JAX loss_fn's
    flip and scale; other band counts keep their order), contiguous. A permuted view would
    carry channels-last strides into the model: on the CPU, PyTorch's
    channels-last train-mode BatchNorm folds the normalisation into
    x * (g / s) + (b - m * g / s) and loses digits when a channel's mean is
    large against its spread (tools/torch_rtdetr_step_precision.py); on a
    card, channels-last is the faster layout for training
    (tools/torch_train_profile.py --layout), left for later (ROADMAP.md)."""
    x = torch.from_numpy(img).to(device)
    if size is not None and size != x.shape[1]:
        x = resize_u8(x, size)
    if x.shape[-1] == 3:
        x = x.flip(-1)
    return x.permute(0, 3, 1, 2).float().contiguous() / 255.0


def load_pickle(path):
    """A checkpoint written by either package. Unpickling runs code the file
    names: load only checkpoints that you or these packages wrote."""
    with open(path, "rb") as f:
        return pickle.load(f)


class DetectionTrainer(BaseTrainer):
    """Detect-task trainer: v8DetectionLoss with the box, cls and dfl gains,
    E2EDetectLoss for an end-to-end (v10Detect) head, or v5AnchorLoss for an
    AnchorDetect head, as the JAX trainer chooses (`:529-553`). The anchor
    criterion's box gain is 0.05 unless `box` differs from the v8 default
    7.5, and its `obj` gain is the `obj` argument, 1.0 when not given (no
    default config key holds it, in either package)."""

    loss_name = "v8DetectionLoss"

    def gains(self) -> Dict[str, float]:
        return {"box": self.args.get("box", 7.5), "cls": self.args.get("cls", 0.5), "dfl": self.args.get("dfl", 1.5)}

    def build_criterion(self):
        from ultralytics_pro_tpu_torch.utils import loss

        head = self.model.model[-1]
        if isinstance(head, AnchorDetect):
            box = self.args.get("box", 7.5)
            return loss.v5AnchorLoss(self.model.nc, head.anchor_list, self.model.stride.tolist(),
                                     hyp={"box": 0.05 if box == 7.5 else box, "cls": self.args.get("cls", 0.5),
                                          "obj": self.args.get("obj", 1.0)})
        if not isinstance(head, Detect):
            raise NotImplementedError(f"the detect trainer trains a Detect or AnchorDetect head, not a "
                                      f"{type(head).__name__}; an RT-DETR model trains through RTDETR(...).train")
        name = "E2EDetectLoss" if head.end2end else self.loss_name
        return getattr(loss, name)(nc=self.model.nc, reg_max=head.reg_max, strides=self.model.stride.tolist(),
                                   hyp=self.gains(), **self.criterion_kwargs(head))

    def criterion_kwargs(self, head) -> Dict:
        return {}


class SegmentationTrainer(DetectionTrainer):
    """Segment-task trainer: v8SegmentationLoss (the mask part takes the box gain)."""

    loss_name = "v8SegmentationLoss"

    def criterion_kwargs(self, head) -> Dict:
        return {"overlap_mask": self.args.get("overlap_mask", True)}


class PoseTrainer(DetectionTrainer):
    """Pose-task trainer: v8PoseLoss at the Pose head's kpt_shape, with the
    pose and kobj gains besides detect's."""

    loss_name = "v8PoseLoss"

    def gains(self) -> Dict[str, float]:
        return {**super().gains(), "pose": self.args.get("pose", 12.0), "kobj": self.args.get("kobj", 1.0)}

    def criterion_kwargs(self, head) -> Dict:
        return {"kpt_shape": head.kpt_shape}


class OBBTrainer(DetectionTrainer):
    """OBB-task trainer: v8OBBLoss (the rotated assigner, probiou)."""

    loss_name = "v8OBBLoss"


class _ClassifyCriterion:
    """Cross-entropy of (B, nc) logits against batch['cls']: the mean NLL of
    the log-softmax, times B, with the part 'cls' (the mean)."""

    def __call__(self, preds: torch.Tensor, batch: Dict[str, torch.Tensor], imgsz_hw):
        nll = -preds.log_softmax(-1).gather(-1, batch["cls"].long()[:, None]).mean()
        return nll * preds.shape[0], {"cls": nll}


class ClassificationTrainer(BaseTrainer):
    """Classify-task trainer: _ClassifyCriterion; batches of images and classes."""

    def build_criterion(self):
        return _ClassifyCriterion()

    def put_batch(self, batch: Dict) -> Dict[str, torch.Tensor]:
        return {"img": device_images(batch["img"], self.device, batch.get("imgsz")),
                "cls": torch.from_numpy(np.asarray(batch["cls"])).to(self.device)}
