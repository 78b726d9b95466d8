"""Model facade: `YOLO("yolov8s.yaml", device="cuda").predict(images)`.

Counterpart of `ultralytics_pro_tpu/engine/model.py` (`Model:27`, `_new:44`,
`predict:77`, `YOLO:341`). The model lives on `device`, which defaults to the
card and raises when there is none; pass device="cpu" for the CPU. Weights
are initialised from a `torch.Generator` seeded with `seed`.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Union

import torch

from ultralytics_pro_tpu_torch.cfg import DEFAULT_CFG_DICT
from ultralytics_pro_tpu_torch.nn.tasks import guess_model_task, model_class_for, yaml_model_load
from ultralytics_pro_tpu_torch.utils import select_device


class Model:
    """Unified YOLO-style model facade (predict only in this port)."""

    def __init__(self, model: Union[str, Path, dict] = "yolov8n.yaml", task: Optional[str] = None,
                 device="cuda", seed: int = 0, verbose: bool = False):
        self.device = select_device(device)
        self.predictor = None
        self._new(model, task, seed, verbose)

    def _new(self, cfg, task: Optional[str], seed: int, verbose: bool = False):
        d = cfg if isinstance(cfg, dict) else yaml_model_load(cfg)
        self.task = task or guess_model_task(d)
        cls = model_class_for(self.task)
        gen = torch.Generator().manual_seed(seed)
        self.model = cls(d, verbose=verbose, generator=gen).to(self.device).eval()

    def predict(self, source=None, stream: bool = False, **kwargs):
        args = {**DEFAULT_CFG_DICT, **kwargs}
        args["conf"] = args.get("conf") or 0.25
        from ultralytics_pro_tpu_torch.models import predictor_for  # models/ imports this module

        predictor_cls = predictor_for(self.model, self.task)
        if self.predictor is None or self.predictor.args != args:
            self.predictor = predictor_cls(self.model, args)
        return self.predictor(source, stream=stream)

    def __call__(self, source=None, stream: bool = False, **kwargs):
        return self.predict(source, stream, **kwargs)


class YOLO(Model):
    """YOLO entry point."""
