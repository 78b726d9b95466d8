"""Which machine instructions nvcc emits for Hopper's atomic adds.

K2's backward adds each sampling corner's weighted grad_out into grad_value.
A design that accumulates a slice of grad_value in shared memory instead of
with global atomics depends on what a shared-memory f32 atomicAdd costs. This
tool compiles one tiny kernel per kind of atomic add for sm_90a, disassembles
it with cuobjdump and prints, per kernel, the atomic-family opcodes in its
SASS (ATOM, ATOMS, ATOMG, RED, CAS): a native add shows as one ATOMS.ADD or
RED.E.ADD, a compare-and-swap loop as ATOMS.CAST.SPIN (or ATOMS.CAS) inside
a branch back.

    python3 tools/torch_smem_atomic_sass.py

Needs nvcc and cuobjdump (on PATH or under /usr/local/cuda/bin), no card.
Builds under ultralytics_pro_tpu_torch/_build/sass_probe/ (git-ignored) and
prints one JSON object as its last line.
"""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "ultralytics_pro_tpu_torch" / "_build" / "sass_probe"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")

# one kernel a source, so a kind the toolkit refuses fails alone
KERNELS = {
    "smem_f32_atomic_add": """
extern "C" __global__ void smem_f32_atomic_add(const int* idx, const float* v, float* out) {
  __shared__ float tile[1024];
  for (int i = threadIdx.x; i < 1024; i += blockDim.x) tile[i] = 0.f;
  __syncthreads();
  atomicAdd(&tile[idx[threadIdx.x] & 1023], v[threadIdx.x]);
  __syncthreads();
  for (int i = threadIdx.x; i < 1024; i += blockDim.x) out[i] = tile[i];
}""",
    "smem_i32_atomic_add": """
extern "C" __global__ void smem_i32_atomic_add(const int* idx, const int* v, int* out) {
  __shared__ int tile[1024];
  for (int i = threadIdx.x; i < 1024; i += blockDim.x) tile[i] = 0;
  __syncthreads();
  atomicAdd(&tile[idx[threadIdx.x] & 1023], v[threadIdx.x]);
  __syncthreads();
  for (int i = threadIdx.x; i < 1024; i += blockDim.x) out[i] = tile[i];
}""",
    "global_f32_atomic_add": """
extern "C" __global__ void global_f32_atomic_add(const int* idx, const float* v, float* out) {
  atomicAdd(out + idx[threadIdx.x], v[threadIdx.x]);
}""",
    "global_f32x4_atomic_add": """
extern "C" __global__ void global_f32x4_atomic_add(const int* idx, const float4* v, float4* out) {
  atomicAdd(out + idx[threadIdx.x], v[threadIdx.x]);
}""",
}

ATOMIC = re.compile(r"\b((?:ATOMS|ATOMG|ATOM|RED|REDG|CAS)(?:\.[A-Z0-9_]+)*)\b")


def tool(name: str) -> str:
    found = shutil.which(name)
    if found:
        return found
    default = Path("/usr/local/cuda/bin") / name
    if default.exists():
        return str(default)
    raise SystemExit(f"{name} not found on PATH or under /usr/local/cuda/bin")


def probe(name: str, src: str, nvcc: str, cuobjdump: str) -> dict:
    cu, cubin = OUT / f"{name}.cu", OUT / f"{name}.cubin"
    cu.write_text("#include <cuda_runtime.h>\n" + src + "\n")
    proc = subprocess.run([nvcc, *ARCH, "-O3", "-cubin", "-o", str(cubin), str(cu)], capture_output=True, text=True)
    if proc.returncode != 0:
        return {"compiled": False, "nvcc_stderr": proc.stderr[-2000:]}
    sass = subprocess.run([cuobjdump, "-sass", str(cubin)], capture_output=True, text=True, check=True).stdout
    ops = [m.group(1) for line in sass.splitlines() if (m := ATOMIC.search(line.split(";")[0]))]
    return {"compiled": True, "atomic_opcodes": sorted(set(ops)), "atomic_instructions": len(ops),
            "branches": sum(1 for line in sass.splitlines() if re.search(r"\bBRA\b", line)),
            "sass_lines": [line.strip() for line in sass.splitlines() if ATOMIC.search(line.split(";")[0])]}


def main() -> int:
    nvcc, cuobjdump = tool("nvcc"), tool("cuobjdump")
    OUT.mkdir(parents=True, exist_ok=True)
    version = subprocess.run([nvcc, "--version"], capture_output=True, text=True).stdout.strip().splitlines()[-1]
    result = {"nvcc": version, "arch": "sm_90a",
              "kernels": {name: probe(name, src, nvcc, cuobjdump) for name, src in KERNELS.items()}}
    for name, r in result["kernels"].items():
        print(name, r.get("atomic_opcodes", "did not compile"), flush=True)
    print(json.dumps(result))
    return 0 if all(r["compiled"] for name, r in result["kernels"].items() if name != "global_f32x4_atomic_add") else 1


if __name__ == "__main__":
    sys.exit(main())
