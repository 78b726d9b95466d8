"""Runtime utilities of the port: logging, simple classes, timing, devices,
precision.

Own copies of the few names of `ultralytics_pro_tpu/utils/__init__.py` that
the port uses (`LOGGER`, `SimpleClass`, `Profile`); that module imports
PyYAML, which the port does not need.
"""

from __future__ import annotations

import contextlib
import logging
import os
import sys
import time
from pathlib import Path

import torch

PKG_ROOT = Path(__file__).resolve().parents[1]


def set_logging(name: str = "ultralytics_pro_tpu_torch", verbose: bool = True) -> logging.Logger:
    level = logging.INFO if verbose else logging.ERROR
    logger = logging.getLogger(name)
    logger.setLevel(level)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter("%(message)s"))
        logger.addHandler(handler)
    logger.propagate = False
    return logger


LOGGER = set_logging(verbose=str(os.getenv("UPT_VERBOSE", "true")).lower() == "true")


class SimpleClass:
    """Base class giving a readable repr of public attributes."""

    def __str__(self):
        attrs = [f"{k}: {v.__class__.__name__}" for k, v in vars(self).items()
                 if not k.startswith("_")]
        return f"{self.__class__.__name__}({', '.join(attrs)})"

    __repr__ = __str__


class Profile:
    """Context-manager timer: `dt` is the last block's seconds, `t` their sum
    over every use. With a CUDA `device` it synchronises that device on entry
    and exit, so the time covers the queued device work."""

    def __init__(self, device=None):
        self.t = 0.0
        self.dt = 0.0
        self.cuda = device is not None and torch.device(device).type == "cuda"

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def __enter__(self):
        self._sync()
        self._start = time.perf_counter()
        return self

    def __exit__(self, *a):
        self._sync()
        self.dt = time.perf_counter() - self._start
        self.t += self.dt


def select_device(device="cuda") -> torch.device:
    """The torch.device to run on. 'cuda' raises when no card is present:
    the CPU is used only when the caller asks for it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={str(device)!r} requested but torch.cuda.is_available() is "
                           "False; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}; use 'cuda', 'cuda:N' or 'cpu'")
    return dev


@contextlib.contextmanager
def full_f32():
    """Convolutions and matmuls in full f32, TF32 off: the precision the JAX
    package is held to. The predictors' device functions run under it. It
    restores `torch.backends.cudnn.allow_tf32` and
    `torch.backends.cuda.matmul.allow_tf32` on exit, so a call leaves torch's
    global state as it found it."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
