"""Model facade: `YOLO("yolov8s.yaml", device="cuda").predict(images)` and `.val(data=...)`.

Counterpart of `ultralytics_pro_tpu/engine/model.py` (`Model:27`, `_new:44`,
`predict:77`, `val:138` for detect, `YOLO:341`). The model lives on `device`,
which defaults to the card and raises when there is none; pass device="cpu"
for the CPU. Weights are initialised from a `torch.Generator` seeded with
`seed`, or loaded from a torch-reference state dict (`load_state_dict`).
"""

from __future__ import annotations

from pathlib import Path
from typing import Mapping, Optional, Union

import torch

from ultralytics_pro_tpu_torch.cfg import DEFAULT_CFG_DICT
from ultralytics_pro_tpu_torch.nn.tasks import guess_model_task, model_class_for, yaml_model_load
from ultralytics_pro_tpu_torch.utils import select_device


class Model:
    """Unified YOLO-style model facade (predict, and val for detect, in this port)."""

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

    def load_state_dict(self, state_dict: Mapping, strict: bool = True):
        """Load weights under the torch reference's names (`model.0.conv.weight`,
        ...), as numpy arrays or tensors, onto the model's device."""
        return self.model.load_state_dict({k: torch.as_tensor(v) for k, v in state_dict.items()},
                                          strict=strict)

    def val(self, data=None, **kwargs):
        """Evaluate on a detection dataset's `split` (default val); returns DetMetrics."""
        from ultralytics_pro_tpu_torch.data import DataLoader, YOLODataset, check_det_dataset
        from ultralytics_pro_tpu_torch.models import task_map  # models/ imports this module

        args = {**DEFAULT_CFG_DICT, **kwargs}
        if (data or args.get("data")) is None:
            raise ValueError("val needs data=<dataset yaml or dict>; the port bundles no datasets")
        d = check_det_dataset(data or args.get("data"))
        ch = int(d.get("channels", 3) or 3)
        if ch != 3:
            raise NotImplementedError(f"val on a dataset with channels={ch} (which rebuilds the "
                                      "model's stem) is not implemented in ultralytics_pro_tpu_torch yet")
        self.model.names = d["names"]
        imgsz, batch = int(args["imgsz"]), int(args["batch"])
        dataset = YOLODataset(d[args["split"]], imgsz=imgsz, augment=False, data=d, task=self.task,
                              rect=bool(args["rect"]), single_cls=bool(args["single_cls"]))
        loader = DataLoader(dataset, batch_size=batch, workers=int(args["workers"]),
                            max_gt=int(args["max_gt"]))
        validator = task_map[self.task]["validator"](args)
        return validator(self.model, loader, names=d["names"])

    def __call__(self, source=None, stream: bool = False, **kwargs):
        return self.predict(source, stream, **kwargs)


class YOLO(Model):
    """YOLO entry point."""
