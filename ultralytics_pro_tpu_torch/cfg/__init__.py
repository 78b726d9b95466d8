"""Predict and val settings of the port.

The keys of `ultralytics_pro_tpu/cfg/default.yaml` that `Model.predict` and
`Model.val` read, as a dict, so the port needs no YAML parser for them.
`plots` defaults to False here (True there): the port draws no plots yet, and
its validator raises when asked to.
"""

DEFAULT_CFG_DICT = {
    "imgsz": 640,
    "batch": 16,
    "workers": 8,
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
}
