"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Every `csrc/*.cu` source compiles, in one nvcc call, into a shared library
with a plain C interface (no PyTorch headers, so the build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \
         -shared -Xcompiler -fPIC -o _build/libupt_kernels-<hash>.so csrc/*.cu

The library is named after a hash of the sources and flags, so it is rebuilt
only when they change. A file lock serialises concurrent builds. The build
runs at first use (`load_library()`), never at import.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG_ROOT = Path(__file__).resolve().parents[1]
CSRC = PKG_ROOT / "csrc"
BUILD_DIR = PKG_ROOT / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-fmad=false",
              "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")

_lib = None
build_info = {"seconds": None, "built": None, "path": None, "ptxas": ""}


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found on PATH or at /usr/local/cuda/bin/nvcc; "
                       "the CUDA kernels cannot be built")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libupt_kernels-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile csrc/*.cu unless a library for these exact sources exists."""
    out = library_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if out.exists():
                build_info.update(built=False)
            else:
                tmp = out.with_suffix(f".tmp{os.getpid()}")
                cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, _sources())]
                proc = subprocess.run(cmd, capture_output=True, text=True)
                if proc.returncode != 0:
                    tmp.unlink(missing_ok=True)
                    raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                                       f"{proc.stderr}")
                os.replace(tmp, out)
                build_info.update(built=True, ptxas=proc.stderr)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    build_info.update(seconds=time.perf_counter() - t0, path=str(out))
    return out


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built on first call and bound once."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.upt_greedy_nms.argtypes = [vp, vp, vp, vp, ci, ci, ci, ctypes.c_float, vp]
        lib.upt_greedy_nms.restype = ci
        lib.upt_greedy_nms_init.argtypes = [ctypes.POINTER(ci)]
        lib.upt_greedy_nms_init.restype = ci
        lib.upt_msda_sample_fused.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci,
                                              ctypes.POINTER(ci), vp]
        lib.upt_msda_sample_fused.restype = ci
        lib.upt_msda_sample_fused_backward.argtypes = [vp, vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci,
                                                       ctypes.POINTER(ci), vp]
        lib.upt_msda_sample_fused_backward.restype = ci
        lib.upt_cuda_error_string.argtypes = [ci]
        lib.upt_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(err: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error."""
    if err != 0:
        msg = load_library().upt_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")
