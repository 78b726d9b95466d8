"""Run directories: the next free `runs/.../trainN`, and the latest last.ckpt.

Copies of `ultralytics_pro_tpu/utils/__init__.py:increment_path:209` and
`ultralytics_pro_tpu/utils/files.py:get_latest_run:52`.
"""

from __future__ import annotations

import glob
import os
from pathlib import Path


def increment_path(path) -> Path:
    """runs/exp -> runs/exp2, exp3, ... when runs/exp exists."""
    path = Path(path)
    if path.exists():
        base, suffix = (path.with_suffix(""), path.suffix) if path.is_file() else (path, "")
        for n in range(2, 9999):
            p = f"{base}{n}{suffix}"
            if not os.path.exists(p):
                return Path(p)
    return path


def get_latest_run(search_dir: str = ".") -> str:
    """The most recent last*.ckpt under search_dir, or '' (for resume)."""
    paths = glob.glob(f"{search_dir}/**/last*.ckpt", recursive=True)
    return max(paths, key=os.path.getctime) if paths else ""
