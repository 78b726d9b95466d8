"""Tracker wiring for predict streams: one tracker a model, rows rewritten with track ids.

A copy of `ultralytics_pro_tpu/trackers/track.py` (`make_tracker:15`,
`register_tracker:41`). The tracker's settings are the bundled
`cfg/trackers/<name>.yaml` (or a YAML file given by path), read by
`utils/miniyaml.py`, under any explicit `args`. Each frame's detections
(x1, y1, x2, y2, conf, cls) go to the tracker with the original frame (GMC
reads it); its activated tracks become the frame's boxes as 7-column rows
x1, y1, x2, y2, id, conf, cls (`Boxes.is_track`), conf and cls those of
the detection each track matched. A frame without detections is passed
through untracked. With `persist` a model keeps its tracker across calls.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ultralytics_pro_tpu_torch.trackers.bot_sort import BOTSORT, ReID
from ultralytics_pro_tpu_torch.trackers.byte_tracker import BYTETracker
from ultralytics_pro_tpu_torch.utils import PKG_ROOT, miniyaml

TRACKER_MAP = {"bytetrack": BYTETracker, "botsort": BOTSORT}


def tracker_settings(tracker_cfg="botsort.yaml", args=None) -> dict:
    """The tracker YAML under `args`: the file's name says the tracker
    (botsort or bytetrack, as in the JAX package), its settings come from
    the file where it exists, else from the bundled YAML of that name."""
    path = Path(str(tracker_cfg))
    name = path.name.replace(".yaml", "")
    if name not in TRACKER_MAP:
        raise ValueError(f"unknown tracker '{tracker_cfg}'; choose from {list(TRACKER_MAP)}")
    if not path.is_file():
        path = PKG_ROOT / "cfg" / "trackers" / f"{name}.yaml"
    return {**miniyaml.load(path), **dict(args or {})}


def make_tracker(tracker_cfg="botsort.yaml", frame_rate=30, args=None, model=None):
    """A BYTETracker or BOTSORT from its YAML under `args`. BoT-SORT with
    `with_reid` embeds crops through `model` (the tracking facade) where the
    settings say `model: auto` (the default), else through a model built
    from the named YAML on the tracking model's device."""
    args = tracker_settings(tracker_cfg, args)
    cls = TRACKER_MAP[Path(str(tracker_cfg)).name.replace(".yaml", "")]
    if cls is BOTSORT and args.get("with_reid"):
        name = args.get("model") or "auto"
        if name == "auto" and model is None:
            raise ValueError("with_reid and model: auto embed through the tracking model; pass model=")
        encoder = ReID(model) if name == "auto" else ReID(name, device=getattr(model, "device", "cuda"))
        return cls(args, frame_rate=frame_rate, encoder=encoder)
    return cls(args, frame_rate=frame_rate)


def register_tracker(model, results, persist: bool = False, tracker_cfg="botsort.yaml"):
    """Track an iterable of Results (a list, or a generator with stream=True);
    returns them updated, as a list or a generator."""
    tracker = getattr(model, "_tracker", None)
    if tracker is None or not persist:
        tracker = make_tracker(tracker_cfg, model=model)
        model._tracker = tracker

    def process(r):
        if r.boxes is None or len(r.boxes) == 0:
            return r
        det = r.boxes.data
        tracks = tracker.update(det[:, :4], det[:, 4], det[:, 5], img=r.orig_img)
        if len(tracks):
            from ultralytics_pro_tpu_torch.engine.results import Boxes  # engine/ imports this package

            idx = tracks[:, -1].astype(int)
            r.boxes = Boxes(np.concatenate([tracks[:, :4], tracks[:, 4:5], det[idx, 4:5], det[idx, 5:6]], 1),
                            r.orig_shape)
        return r

    if hasattr(results, "__iter__") and not isinstance(results, list):
        return (process(r) for r in results)
    return [process(r) for r in results]
