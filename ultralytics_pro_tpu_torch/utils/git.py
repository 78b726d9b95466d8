"""Git state recorded in checkpoints.

Copy of `ultralytics_pro_tpu/utils/git.py:GIT:19`. Outside a git repository
(an unpacked archive, or a copy of the tree) or without a `git` binary every
field is the empty string.
"""

from __future__ import annotations

import subprocess
from pathlib import Path


def _git(args, cwd=None) -> str:
    try:
        return subprocess.run(["git", *args], cwd=cwd, capture_output=True, text=True,
                              timeout=5).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return ""


class GIT:
    """Snapshot of a directory's git state."""

    def __init__(self, path: str | Path = "."):
        self.path = Path(path)
        self.is_repo = bool(_git(["rev-parse", "--show-toplevel"], self.path))

    @property
    def branch(self) -> str:
        return _git(["rev-parse", "--abbrev-ref", "HEAD"], self.path) if self.is_repo else ""

    @property
    def commit(self) -> str:
        return _git(["rev-parse", "HEAD"], self.path) if self.is_repo else ""

    @property
    def origin(self) -> str:
        return _git(["remote", "get-url", "origin"], self.path) if self.is_repo else ""

    def as_dict(self) -> dict:
        return {"git_branch": self.branch, "git_commit": self.commit, "git_origin": self.origin}
