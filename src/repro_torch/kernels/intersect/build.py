"""Build and load the intersect kernels (``csrc/intersect.cu``).

The source is compiled at first use by ``nvcc`` into a shared library with a
plain C interface and loaded with ``ctypes``; no PyTorch headers are
involved, so a build takes seconds. The library is keyed by a hash of the
source and the flags and lives in ``build/kernels/`` at the root of the
checkout, which ``.gitignore`` lists. Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

from repro_torch.core.faults import KernelFault

SOURCE = Path(__file__).resolve().parent / "csrc" / "intersect.cu"
BUILD_DIR = Path(__file__).resolve().parents[4] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
)

_lib: ctypes.CDLL | None = None
build_log = ""        # nvcc's output of the build this process ran ("" if cached)
build_seconds = 0.0   # wall time of that build


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        shutil.which("nvcc") or "",
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise KernelFault("nvcc not found (set CUDA_HOME or put nvcc on PATH)",
                      op="build")


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"intersect_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the source unless a library for this exact source exists."""
    global build_log, build_seconds
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_seconds = time.perf_counter() - t0
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise KernelFault(f"nvcc failed ({proc.returncode}):\n{build_log}", op="build")
    os.replace(tmp, out)  # atomic: a concurrent build never sees a partial file
    return out


def load() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    p, i32, i64, u32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_uint32
    lib.fused_extend_launch.argtypes = [p] * 8 + [i64, i32, i32, i64, u32, u32, p]
    lib.fused_verify_launch.argtypes = [p] * 7 + [i64, i32, i32, i64, i32, p]
    lib.lex_bounds_launch.argtypes = [p] * 4 + [i32, i32, i64, i32, p]
    lib.multiway_membership_launch.argtypes = [p] * 3 + [i64, i32, i64, p]
    for fn in (lib.fused_extend_launch, lib.fused_verify_launch,
               lib.lex_bounds_launch, lib.multiway_membership_launch):
        fn.restype = ctypes.c_int
    _lib = lib
    return lib
