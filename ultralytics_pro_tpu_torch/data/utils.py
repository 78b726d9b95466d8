"""Dataset config resolution, without PyYAML.

Counterpart of `ultralytics_pro_tpu/data/utils.py` (`check_det_dataset:15`,
`check_cls_dataset:85`). check_det_dataset:
parse the dataset YAML (with the port's `utils/miniyaml.py`), resolve `path`
and the split paths against it, and normalise `names` and `nc`; a relative
YAML path resolves against the working directory. There is no
download: a missing dataset raises with the path it looked for. A `synth:`
dataset whose files are missing raises too, because drawing the synthetic
set needs OpenCV. check_cls_dataset takes a folder (with `train/` and
`val/` or `test/` class folders, or the class folders themselves) or a
YAML whose `path` names one; a relative `path` resolves against the YAML's
directory, as check_det_dataset resolves it (the JAX function against the
working directory).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Union

from ultralytics_pro_tpu_torch.utils import miniyaml


def check_det_dataset(data: Union[str, Path, Dict]) -> Dict:
    """Resolve a detection dataset YAML/dict to absolute split paths + names."""
    if isinstance(data, (str, Path)):
        p = Path(data)
        if not p.exists():
            raise FileNotFoundError(f"dataset '{data}' not found")
        d = miniyaml.load(p)
        d["yaml_file"] = str(p.resolve())
        # without `path:` the YAML's own directory (the JAX function joins a
        # relative YAML path's directory twice)
        root = Path(d.get("path") or p.resolve().parent)
    else:
        d = dict(data)
        root = Path(d.get("path") or ".")

    root = root.expanduser()
    if not root.is_absolute():
        root = (Path(d.get("yaml_file", ".")).parent / root).resolve()
    d["path"] = root

    def _resolve(v):
        sp = Path(v)
        return str(sp if sp.is_absolute() else root / sp)

    for split in ("train", "val", "test"):
        if d.get(split):
            d[split] = ([_resolve(v) for v in d[split]]
                        if isinstance(d[split], (list, tuple)) else _resolve(d[split]))

    if d.get("synth"):
        paths = [v for s in ("train", "val") if d.get(s)
                 for v in (d[s] if isinstance(d[s], list) else [d[s]])]
        missing = [v for v in paths if not Path(v).exists()]
        if missing:
            raise FileNotFoundError(
                f"synthetic dataset files {missing} are missing; ultralytics_pro_tpu_torch cannot "
                "draw the synthetic set (that needs OpenCV): generate it with the JAX package's "
                "data/synth.py first")

    names = d.get("names")
    if isinstance(names, list):
        names = dict(enumerate(names))
    elif isinstance(names, dict):
        names = {int(k): v for k, v in names.items()}
    else:
        names = {i: f"class{i}" for i in range(d.get("nc", 80))}
    d["names"] = names
    d["nc"] = len(names)
    return d


def check_cls_dataset(data: Union[str, Path]) -> Dict:
    """A classify dataset folder or YAML -> {"path", "train", "val", "names",
    "nc"}: val is `val/`, else `test/`, else the train folder; the classes
    are the train folder's subfolders, sorted."""
    if str(data).endswith((".yaml", ".yml")):
        p = Path(data)
        if not p.exists():
            raise FileNotFoundError(f"classification dataset '{data}' not found")
        d = miniyaml.load(p)
        root = Path(d.get("path") or ".").expanduser()
        root = root if root.is_absolute() else (p.resolve().parent / root).resolve()
        if d.get("synth") == "classify" and not (root / "train").exists():
            raise FileNotFoundError(
                f"synthetic classify set {root} is missing; ultralytics_pro_tpu_torch cannot draw it yet (the "
                "JAX generator draws JPEGs with cv2; a numpy drawing comes with ROADMAP.md queue 1 item 10)")
        data = root
    root = Path(data).expanduser()
    if not root.is_dir():
        raise FileNotFoundError(f"classification dataset '{data}' not found")
    train = root / "train" if (root / "train").exists() else root
    val = next((root / s for s in ("val", "test") if (root / s).exists()), train)
    classes = sorted(d.name for d in train.iterdir() if d.is_dir())
    return {"path": root, "train": str(train), "val": str(val), "names": dict(enumerate(classes)),
            "nc": len(classes)}
