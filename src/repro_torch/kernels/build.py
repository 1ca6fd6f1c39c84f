"""Build and load the port's CUDA kernel libraries.

Each library is one ``csrc/*.cu`` file compiled at first use by ``nvcc``
into a shared library with a plain C interface and loaded with ``ctypes``;
no PyTorch headers are involved, so a build takes seconds. A library is keyed
by a hash of its source, of every local header it includes (``#include
"..."``, followed through the headers' own includes) and of the flags, and
lives in ``build/kernels/`` at the root of the checkout, which
``.gitignore`` lists, so an edited header never loads a stale library.
Nothing here runs at import time; a failed build raises :class:`KernelFault`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills of each kernel, into build_log
)
_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def local_sources(source: Path) -> list[Path]:
    """``source`` and every file it includes with quotes that lies beside
    the including file, followed through those files' own includes, in the
    order first met; a quoted name with no such file is the compiler's
    business and is left out."""
    seen: list[Path] = []
    todo = [source.resolve()]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        for name in _LOCAL_INCLUDE.findall(path.read_bytes()):
            inc = (path.parent / name.decode()).resolve()
            if inc.is_file():
                todo.append(inc)
    return seen


def _fault(message: str):
    # Imported here, not at the top: repro_torch.core's package imports the
    # engine, whose operators import the intersect library, which imports
    # this module; a top-level import would close that cycle.
    from repro_torch.core.faults import KernelFault

    return KernelFault(message, op="build")


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        shutil.which("nvcc") or "",
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise _fault("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


class CudaLibrary:
    """One ``.cu`` source, built once per process and loaded with ctypes.

    ``declare`` sets the argument and return types of the library's C entry
    points on the freshly loaded ``ctypes.CDLL``."""

    def __init__(self, name: str, source: Path, declare: Callable[[ctypes.CDLL], None]):
        self.name = name
        self.source = source
        self._declare = declare
        self._lib: ctypes.CDLL | None = None
        self.build_log = ""       # nvcc's output of the build this process ran ("" if cached)
        self.build_seconds = 0.0  # wall time of that build

    def library_path(self) -> Path:
        h = hashlib.sha256()
        for path in local_sources(self.source):
            h.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
        h.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"{self.name}_{h.hexdigest()[:16]}.so"

    def build(self) -> Path:
        """Compile the source unless a library for this exact source exists."""
        out = self.library_path()
        if out.exists():
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        self.build_seconds = time.perf_counter() - t0
        self.build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise _fault(f"nvcc failed on {self.source.name} ({proc.returncode}):\n"
                         f"{self.build_log}")
        os.replace(tmp, out)  # atomic: a concurrent build never sees a partial file
        return out

    def load(self) -> ctypes.CDLL:
        """The loaded kernel library, built first if needed."""
        if self._lib is None:
            lib = ctypes.CDLL(str(self.build()))
            self._declare(lib)
            self._lib = lib
        return self._lib
