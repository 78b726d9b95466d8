"""Model facade: `YOLO("yolov8s.yaml", device="cuda").predict(images)`, `.val(data=...)`
and `.train(data=...)`.

Counterpart of `ultralytics_pro_tpu/engine/model.py` (`Model:27`, `_new:44`,
`_load:52`, `_merged_args:72`, `predict:77`, `val:138`, `train:172`,
`_train_classify:247`, `_quick_val:286`, `YOLO:341`) for detect, segment,
pose, obb and classify. The model
lives on `device`, which defaults to the card and raises when there is none;
pass device="cpu" for the CPU. Training runs on that device. Weights are
initialised from a `torch.Generator` seeded with `seed`, loaded from a
torch-reference state dict (`load_state_dict`), or read from a checkpoint of
either package (`YOLO("best.ckpt")`: its EMA parameters where it has them,
and its BN statistics). As in the JAX facade, the checkpoint's `train_args`
(less `save_dir`) become `overrides`, the defaults of every later predict,
val and train under the caller's arguments: a model trained at imgsz=96
predicts and validates at 96, and `val()` without `data` takes the training
set's YAML. `plots` is left out of them too: the port draws no plots, and a
JAX checkpoint carries that package's default, True.

Classify takes a folder-per-class dataset (`check_cls_dataset`): val reads
its val folder, train rebuilds the model at its nc, trains at the merged
`imgsz` (the JAX facade's too: 640 unless given) and validates each epoch
with fitness (top1 + top5) / 2.

Beside them: `track` (`:299`; BoT-SORT or ByteTrack over predict's
one-frame calls, conf 0.1 unless given, `tracker=` a bundled name or a
YAML path, `persist` to keep the tracker between calls), `embed` (`:114`;
each image resized to imgsz x imgsz by `data/imgproc.py:resize_linear`, the
copy of cv2's INTER_LINEAR, then the model's embed mode), `predict_files`
(`:345`; batches of files, `BasePredictor.predict_files`), `names`
(`:321`), `info` (`:324`) and `save` (`:327`, the pickle both packages
read). Sources may be image files, folders, globs and lists of paths
(`data/loaders.py`).

A model with an MHSA layer, or EfficientFormerV2's attention, holds
parameters sized by its map (`rel_h` and `rel_w`, `attention_biases`; its
`model.imgsz`, 640 unless the model was built otherwise). The JAX facade
initialises a model's variables at its first call's imgsz, and a later call
at another size fails on their shape. So here a model that is still as
built (never run or loaded, and its parameters and buffers still the
seed's: a digest taken at build time says so) is rebuilt, from its seed, at
the first predict, val, train or embed call's imgsz (`_bind_size`). Weights
written to `model.model` directly (its `load_state_dict`, an in-place
write) are never swapped for the seed's: that first call at another size
raises ValueError, as the JAX facade raises ScopeParamShapeError on
variables written at one size and called at another. Later calls at
another size raise too (`MHSA.forward`, `SizeBound.check`), as the JAX package's do; TTA's
shrunk passes and rect val's batch shapes are such sizes. A checkpoint's
model is bound to its `train_args` imgsz.

A detection dataset's `channels` (`:155-160`, `:183-190`): 1 is read as
grey repeated to 3 channels, so the model stays; any count but the
model's rebuilds it with that many input channels (seeded weights, as
the JAX facade re-initialises it) before val or train. `train(augment=True)`
hands the dataset the `HYP_KEYS` gains (`:213-218`).
"""

from __future__ import annotations

import copy
import hashlib
from pathlib import Path
from typing import Mapping, Optional, Union

import torch

from ultralytics_pro_tpu_torch.cfg import DEFAULT_CFG_DICT, HYP_KEYS
from ultralytics_pro_tpu_torch.nn.tasks import guess_model_task, model_class_for, size_bound, yaml_model_load
from ultralytics_pro_tpu_torch.utils import LOGGER, full_f32, select_device


class Model:
    """Unified YOLO-style model facade: predict, val and train for detect,
    segment, pose, obb and classify."""

    def __init__(self, model: Union[str, Path, dict] = "yolov8n.yaml", task: Optional[str] = None,
                 device="cuda", seed: int = 0, verbose: bool = False):
        self.device = select_device(device)
        self.seed = seed
        self.predictor = None
        self.trainer = None
        self.ckpt = None
        self.overrides = {}
        self._fresh = False  # as built from a YAML: not yet run, loaded or trained (`_bind_size`)
        self._seed_digest = None  # `_digest()` of a model with size-bound layers as built
        if str(model).endswith((".ckpt", ".pkl")):
            self._load(str(model), task)
        else:
            self._new(model, task, verbose)

    def _build(self, cfg: dict, nc: Optional[int] = None, verbose: bool = False, ch: int = 3,
               imgsz: Optional[int] = None):
        gen = torch.Generator().manual_seed(self.seed)
        if imgsz is None:
            imgsz = getattr(getattr(self, "model", None), "imgsz", None) or 640
        return model_class_for(self.task)(cfg, ch=ch, nc=nc, verbose=verbose, generator=gen,
                                          imgsz=imgsz).to(self.device).eval()

    def _digest(self) -> bytes:
        """A digest of the model's parameters and buffers, names and bytes."""
        h = hashlib.blake2b(digest_size=16)
        for k, t in self.model.state_dict().items():
            h.update(k.encode())
            h.update(t.detach().cpu().reshape(-1).view(torch.uint8).numpy().tobytes())
        return h.digest()

    def _bind_size(self, imgsz: int) -> None:
        """Rebuild a model that is still as built at imgsz where its
        size-bound layers (`nn/tasks.py:size_bound`) are bound to another
        size; the model is no longer as built. Raises instead where its
        weights were written since it was built."""
        if self._fresh and self.model.imgsz not in (None, imgsz):
            if self._digest() != self._seed_digest:
                params = ", ".join(dict.fromkeys(f"{type(m).__name__}'s {' and '.join(m.size_params)}"
                                                 for m in size_bound(self.model)))
                raise ValueError(f"the model's weights were written since it was built, and its size-bound "
                                 f"parameters ({params}) are sized for imgsz={self.model.imgsz}, not {imgsz}: call "
                                 f"it at imgsz={self.model.imgsz} (the JAX facade raises ScopeParamShapeError here)")
            self.model = self._build(copy.deepcopy(self.model.yaml), nc=self.model.nc, ch=self.model.ch, imgsz=imgsz)
        self._fresh = False

    def _restem(self, d: dict, nc: Optional[int] = None) -> bool:
        """Rebuild the model at the dataset's channel count (1 counts as 3)
        where it differs from the model's; returns whether it did."""
        ch = int(d.get("channels", 3) or 3)
        ch = 3 if ch == 1 else ch
        if ch == getattr(self.model, "ch", 3):
            return False
        self.model = self._build(copy.deepcopy(self.model.yaml), nc=nc, ch=ch)
        return True

    def _new(self, cfg, task: Optional[str], verbose: bool = False):
        d = cfg if isinstance(cfg, dict) else yaml_model_load(cfg)
        self.task = task or guess_model_task(d)
        self.model = self._build(d, verbose=verbose)
        self._fresh = True
        if self.model.imgsz is not None:
            self._seed_digest = self._digest()

    def _load(self, weights: str, task: Optional[str] = None):
        """A checkpoint of either package: the model from its `model_yaml`, its
        EMA parameters (its parameters if it has none) and BN statistics."""
        from ultralytics_pro_tpu_torch.engine.trainer import load_pickle
        from ultralytics_pro_tpu_torch.utils.weights import jax_to_torch_state_dict

        ckpt = load_pickle(weights)
        d = ckpt.get("model_yaml")
        if d is None:
            raise ValueError(f"checkpoint {weights} carries no model yaml")
        self.ckpt = ckpt
        self.task = task or guess_model_task(d)
        self.model = self._build(d, imgsz=int((ckpt.get("train_args") or {}).get("imgsz") or 640))
        self.load_state_dict(jax_to_torch_state_dict({"params": ckpt.get("ema") or ckpt["params"],
                                                      "batch_stats": ckpt["batch_stats"]}))
        self.overrides = dict(ckpt.get("train_args") or {})
        for key in ("save_dir", "plots"):
            self.overrides.pop(key, None)

    def _merged_args(self, **kwargs) -> dict:
        """The defaults, then the checkpoint's overrides, then the caller's arguments."""
        args = {**DEFAULT_CFG_DICT, **self.overrides, **kwargs}
        args.pop("mode", None)
        self._bind_size(int(args["imgsz"]))
        return args

    def predict(self, source=None, stream: bool = False, **kwargs):
        return self._predictor(**kwargs)(source, stream=stream)

    def load_state_dict(self, state_dict: Mapping, strict: bool = True):
        """Load weights under the torch reference's names (`model.0.conv.weight`,
        ...), as numpy arrays or tensors, onto the model's device."""
        self._fresh = False
        return self.model.load_state_dict({k: torch.as_tensor(v) for k, v in state_dict.items()},
                                          strict=strict)

    def _dataset(self, data, args) -> dict:
        """The dataset dict of `data` (or the merged args' `data`): a classify
        folder or YAML for a classify model, else a detection YAML or dict."""
        from ultralytics_pro_tpu_torch.data import check_cls_dataset, check_det_dataset

        if (data or args.get("data")) is None:
            raise ValueError("val and train need data=<dataset yaml or dict>; the port bundles no datasets")
        if self.task == "classify":
            return check_cls_dataset(data or args.get("data"))
        return check_det_dataset(data or args.get("data"))

    def val(self, data=None, **kwargs):
        """Evaluate on a dataset's `split` (default val; a classify set's val
        folder); returns the task's metrics (DetMetrics, SegmentMetrics,
        PoseMetrics, OBBMetrics or ClassifyMetrics). `rect` batches by aspect
        ratio as the JAX facade's val does; `cache` ("ram" or "disk") caches
        the resized images, which the JAX facade's val leaves out (its
        dataset has the cache, and its train takes it), with the same mAPs."""
        from ultralytics_pro_tpu_torch.data import DataLoader, YOLODataset
        from ultralytics_pro_tpu_torch.models import task_map  # models/ imports this module

        args = self._merged_args(**kwargs)
        d = self._dataset(data, args)
        if self.task == "classify":
            return Model._classify_val(self.model, d, args)
        self._restem(d, nc=d["nc"])
        self.model.names = d["names"]
        imgsz, batch = int(args["imgsz"]), int(args["batch"])
        dataset = YOLODataset(d[args["split"]], imgsz=imgsz, augment=False, data=d, task=self.task,
                              rect=bool(args["rect"]), single_cls=bool(args["single_cls"]),
                              cache=args.get("cache") or None, batch_size=batch)
        loader = DataLoader(dataset, batch_size=batch, workers=int(args["workers"]),
                            max_gt=int(args["max_gt"]))
        validator = task_map[self.task]["validator"](args)
        return validator(self.model, loader, names=d["names"])

    def train(self, data=None, **kwargs):
        """Train on a dataset's train split on the model's device, validating
        the EMA parameters on its val split after every epoch (val=True); the
        EMA parameters are left on the model. The model is rebuilt at the
        dataset's nc, and a pose model at its kpt_shape where the head's
        differs. `data` is kept in the checkpoints' `train_args` (the JAX
        trainer leaves it out), so `YOLO(ckpt).val()` finds it. Returns None,
        as the JAX facade does: results are on `self.trainer` and in its
        save_dir (results.csv, weights/last.ckpt and best.ckpt)."""
        from ultralytics_pro_tpu_torch.data import DataLoader, YOLODataset
        from ultralytics_pro_tpu_torch.models import task_map  # models/ imports this module

        args = self._merged_args(**kwargs)
        if data is not None:
            args["data"] = data
        d = self._dataset(data, args)
        if self.task == "classify":
            return self._train_classify(d, args)
        self._restem(d, nc=d["nc"])  # whatever nc is, as the JAX facade re-stems
        rebuild = d["nc"] != self.model.nc
        y = copy.deepcopy(self.model.yaml)
        if self.task == "pose" and d.get("kpt_shape") and \
                tuple(self.model.model[-1].kpt_shape) != tuple(d["kpt_shape"]):
            for row in y.get("head", []):  # the Pose row takes the dataset's shape, so checkpoints carry it
                if row[2] == "Pose":
                    row[3] = [row[3][0], list(d["kpt_shape"])]
            rebuild = True
        if rebuild:
            self.model = self._build(y, nc=d["nc"], ch=getattr(self.model, "ch", 3))
        self.model.names = d["names"]
        train_set = YOLODataset(d["train"], imgsz=int(args["imgsz"]), augment=bool(args["augment"]),
                                hyp={k: args[k] for k in HYP_KEYS if k in args}, data=d, task=self.task,
                                cache=args.get("cache") or None)
        train_loader = DataLoader(train_set, batch_size=int(args["batch"]), shuffle=True, drop_last=True,
                                  max_gt=int(args["max_gt"]), workers=int(args["workers"]))
        self.trainer = task_map[self.task]["trainer"](self.model, args)

        val_fn = None
        if args.get("val", True) and d.get("val"):
            val_args = dict(args)

            def val_fn(model):
                try:
                    return Model._quick_val(model, d, val_args, self.task).fitness
                except Exception:  # the JAX facade trains on when a val fails; this logs why
                    LOGGER.exception("val failed; training goes on with fitness None")
                    return None

        self.trainer.train(train_loader, val_fn=val_fn)

    def _train_classify(self, d: dict, args: dict):
        """Classify training: the model rebuilt at the set's nc, the train
        folder shuffled, through `classify_augmentations` with augment=True
        (RandAugment, erasing 0.4: the dataset's defaults, which the JAX
        facade keeps whatever `auto_augment` and `erasing` say), the
        epoch-end val on the val folder."""
        from ultralytics_pro_tpu_torch.data import ClassificationDataset, DataLoader, collate_classify
        from ultralytics_pro_tpu_torch.models import task_map  # models/ imports this module

        if d["nc"] != self.model.nc:
            self.model = self._build(copy.deepcopy(self.model.yaml), nc=d["nc"])
        self.model.names = d["names"]
        train_set = ClassificationDataset(d["train"], imgsz=int(args["imgsz"]), augment=bool(args["augment"]))
        loader = DataLoader(train_set, batch_size=int(args["batch"]), shuffle=True, drop_last=True,
                            workers=int(args["workers"]), collate_fn=collate_classify)
        self.trainer = task_map["classify"]["trainer"](self.model, args)

        val_fn = None
        if args.get("val", True) and d.get("val"):
            def val_fn(model):
                try:
                    return Model._classify_val(model, d, args).fitness
                except Exception:  # as the detect branch: training goes on, the cause logged
                    LOGGER.exception("val failed; training goes on with fitness None")
                    return None

        self.trainer.train(loader, val_fn=val_fn)

    @staticmethod
    def _classify_val(model, d: dict, args: dict):
        """A classify set's val folder through ClassificationValidator."""
        from ultralytics_pro_tpu_torch.data import ClassificationDataset, DataLoader, collate_classify
        from ultralytics_pro_tpu_torch.models import task_map  # models/ imports this module

        dataset = ClassificationDataset(d["val"], imgsz=int(args["imgsz"]))
        loader = DataLoader(dataset, batch_size=int(args["batch"]), workers=int(args["workers"]),
                            collate_fn=collate_classify)
        return task_map["classify"]["validator"](args)(model, loader, names=d["names"])

    @staticmethod
    def _quick_val(model, d: dict, args: dict, task: str):
        """The epoch-end val: the dataset's val split through the task's validator."""
        from ultralytics_pro_tpu_torch.data import DataLoader, YOLODataset
        from ultralytics_pro_tpu_torch.models import task_map  # models/ imports this module

        dataset = YOLODataset(d["val"], imgsz=int(args["imgsz"]), augment=False, data=d, task=task,
                              rect=bool(args.get("rect", False)), batch_size=int(args["batch"]))
        loader = DataLoader(dataset, batch_size=int(args["batch"]), max_gt=int(args["max_gt"]),
                            workers=int(args["workers"]))
        return task_map[task]["validator"](args)(model, loader, names=d["names"])

    def __call__(self, source=None, stream: bool = False, **kwargs):
        return self.predict(source, stream, **kwargs)

    def _predictor(self, **kwargs):
        """The task's predictor for the merged args (conf 0.25 unless given),
        kept while the args and the model stay the same."""
        args = self._merged_args(**kwargs)
        args["conf"] = args.get("conf") or 0.25
        from ultralytics_pro_tpu_torch.models import predictor_for  # models/ imports this module

        if self.predictor is None or self.predictor.args != args or self.predictor.model is not self.model:
            self.predictor = predictor_for(self.model, self.task)(self.model, args)
        return self.predictor

    def predict_files(self, paths, batch: int = 16, **kwargs):
        """One Results a file, the files read and predicted in batches of `batch`."""
        return self._predictor(**kwargs).predict_files(paths, batch=batch)

    def track(self, source=None, stream: bool = False, persist: bool = False, tracker="botsort.yaml", **kwargs):
        """predict, one frame a call, then the tracker over the frames: each
        frame's boxes become (n, 7) rows with their track ids. A list of
        Results, or a generator with stream=True."""
        from ultralytics_pro_tpu_torch.trackers.track import register_tracker

        kwargs.setdefault("conf", 0.1)
        results = self.predict(source, stream=stream, **kwargs)
        return register_tracker(self, results, persist=persist, tracker_cfg=tracker)

    @torch.no_grad()
    def embed(self, source=None, imgsz: int = 224, **kwargs):
        """(N, D) numpy features: each image (an array or a path) resized to
        imgsz x imgsz, RGB / 255, the model's last neck maps pooled and
        L2-normalised."""
        import numpy as np

        from ultralytics_pro_tpu_torch.data.image_io import imread
        from ultralytics_pro_tpu_torch.data.imgproc import resize_linear
        from ultralytics_pro_tpu_torch.engine.predictor import rgb01

        self._bind_size(imgsz)
        imgs = source if isinstance(source, (list, tuple)) else [source]
        batch = np.stack([resize_linear(im if isinstance(im, np.ndarray) else imread(im), (imgsz, imgsz))
                          for im in imgs])
        with full_f32():
            return self.model(rgb01(torch.from_numpy(batch).to(self.device)), embed=True).cpu().numpy()

    @property
    def names(self):
        return self.model.names

    def info(self, verbose: bool = True):
        """(layers, parameters), logged with verbose."""
        return self.model.info(verbose=verbose)

    def save(self, path="model.ckpt"):
        """The model as the JAX facade's pickle (params and BN statistics as
        flax trees, no EMA, the model YAML, `overrides` as train_args), which
        `YOLO(path)` of either package reads."""
        from ultralytics_pro_tpu_torch.engine.trainer import save_pickle
        from ultralytics_pro_tpu_torch.utils.weights import torch_state_dict_to_jax

        trees = torch_state_dict_to_jax(self.model.state_dict())
        save_pickle(path, {"params": trees["params"], "ema": None, "batch_stats": trees["batch_stats"],
                           "model_yaml": dict(self.model.yaml), "train_args": self.overrides})
        return path


class YOLO(Model):
    """YOLO entry point."""
