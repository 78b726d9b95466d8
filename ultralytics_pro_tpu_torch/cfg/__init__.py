"""Predict, val and train settings of the port.

The keys of `ultralytics_pro_tpu/cfg/default.yaml` that `Model.predict`,
`Model.val`, `Model.train` and the trainer read, with the JAX package's
defaults, as a dict, so the port needs no YAML parser for them.
`plots` defaults to False here (True there): the port draws no plots yet, and
its validator raises when asked to. `augment` is off by default there too,
so a train run sees the val transforms unless it asks for augmentation, whose
gains (`HYP_KEYS`) go to the dataset as the JAX facade hands them; and
`optimizer` is left out: the
trainer runs its 3-group SGD whatever it says, as the JAX one does
(ROADMAP.md §3).
"""

DEFAULT_CFG_DICT = {
    "imgsz": 640,
    "batch": 16,
    "workers": 8,
    "device": None,  # train: 1 or None (one card); data parallel is not ported
    "conf": None,  # 0.25 at predict, 0.001 at val
    "iou": 0.7,
    "max_det": 300,
    "classes": None,
    "agnostic_nms": False,
    "augment": False,
    "split": "val",
    "single_cls": False,
    "rect": False,
    "max_gt": 128,  # padded GT slots per image
    "save_json": False,
    "plots": False,
    # train
    "epochs": 100,
    "time": None,  # max hours, overrides epochs
    "patience": 100,
    "save_period": -1,
    "cache": False,
    "project": None,
    "name": None,
    "cos_lr": False,
    "close_mosaic": 10,
    "resume": False,
    "multi_scale": False,
    "remat": False,
    "ckpt_format": "pickle",
    "val": True,
    "lr0": 0.01,
    "lrf": 0.01,
    "momentum": 0.937,
    "weight_decay": 0.0005,
    "warmup_epochs": 3.0,
    "warmup_momentum": 0.8,
    "warmup_bias_lr": 0.1,
    "box": 7.5,
    "cls": 0.5,
    "dfl": 1.5,
    "pose": 12.0,
    "kobj": 1.0,
    "overlap_mask": True,  # read by nothing: the collate always gives overlaps to the smaller instance
    "nbs": 64,
    # train augmentation (augment=True), cfg/default.yaml:106-123
    "hsv_h": 0.015,
    "hsv_s": 0.7,
    "hsv_v": 0.4,
    "degrees": 0.0,
    "translate": 0.1,
    "scale": 0.5,
    "shear": 0.0,
    "perspective": 0.0,
    "flipud": 0.0,
    "fliplr": 0.5,
    "mosaic": 1.0,
    "mixup": 0.0,
    "cutmix": 0.0,
    "copy_paste": 0.0,
    "copy_paste_mode": "flip",  # read by nothing: CopyPaste is the box-level flip-paste, as in the JAX package
    "auto_augment": "randaugment",  # classify: read by nothing, as in the JAX facade (the dataset's default)
    "erasing": 0.4,  # classify: read by nothing, as in the JAX facade (the dataset's default)
}

HYP_KEYS = ("mosaic", "mixup", "cutmix", "copy_paste", "degrees", "translate", "scale", "shear", "perspective",
            "hsv_h", "hsv_s", "hsv_v", "flipud", "fliplr")  # the train arguments the JAX facade hands its dataset
