"""Callback events of the trainer, and the results.csv logger.

Copy of `ultralytics_pro_tpu/utils/callbacks.py` (`EVENTS:14`,
`get_default_callbacks:31`, `CallbackMixin:35`, `csv_logger_callbacks:73`),
which imports nothing of JAX but sits in a package that imports PyYAML. The
third-party integrations (`integration_callbacks:269`: wandb, MLflow and the
others) are not ported yet (ROADMAP.md queue 1).
"""

from __future__ import annotations

from collections import defaultdict
from pathlib import Path
from typing import Callable, Dict, List

EVENTS = [
    # trainer
    "on_pretrain_routine_start", "on_pretrain_routine_end",
    "on_train_start", "on_train_epoch_start", "on_train_batch_start",
    "optimizer_step", "on_before_zero_grad", "on_train_batch_end",
    "on_train_epoch_end", "on_fit_epoch_end", "on_model_save",
    "on_train_end", "on_params_update", "teardown",
    # validator
    "on_val_start", "on_val_batch_start", "on_val_batch_end", "on_val_end",
    # predictor
    "on_predict_start", "on_predict_batch_start", "on_predict_batch_end",
    "on_predict_postprocess_end", "on_predict_end",
    # exporter
    "on_export_start", "on_export_end",
]


def get_default_callbacks() -> Dict[str, List[Callable]]:
    return defaultdict(list, {e: [] for e in EVENTS})


class CallbackMixin:
    """Event registry and dispatch."""

    def init_callbacks(self):
        self.callbacks: Dict[str, List[Callable]] = get_default_callbacks()

    def add_callback(self, event: str, callback: Callable):
        if event not in self.callbacks:
            raise ValueError(f"unknown callback event '{event}'; valid: {EVENTS}")
        self.callbacks[event].append(callback)

    def run_callbacks(self, event: str):
        for cb in self.callbacks.get(event, []):
            cb(self)


def csv_logger_callbacks(save_dir):
    """results.csv: one row per epoch, the mean losses and the fitness."""
    path = Path(save_dir) / "results.csv"

    def on_fit_epoch_end(trainer):
        losses = getattr(trainer, "epoch_losses", {})
        fitness = getattr(trainer, "last_fitness", None)
        keys = ["epoch", *[f"train/{k}" for k in sorted(losses)], "metrics/fitness"]
        vals = [getattr(trainer, "_epoch", 0), *[losses[k] for k in sorted(losses)],
                fitness if fitness is not None else ""]
        header = not path.exists()
        with open(path, "a", encoding="utf-8") as f:
            if header:
                f.write(",".join(keys) + "\n")
            f.write(",".join(str(v) for v in vals) + "\n")

    return {"on_fit_epoch_end": on_fit_epoch_end}
