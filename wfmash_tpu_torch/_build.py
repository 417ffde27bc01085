"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` is compiled by nvcc into a shared library with a
plain C interface under `_build/`, named by a hash of its source and the
flags, and loaded with ctypes. The build happens at first use, never at
import, so the package imports on machines without a CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

from .utils import perf

_DIR = Path(__file__).parent
_SRC = _DIR / "csrc"
_OUT = _DIR / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_name_locks: dict[str, threading.Lock] = {}
_libs: dict[str, ctypes.CDLL] = {}
# per kernel: the compiler's register/shared-memory report of the last
# build made in this process (empty when the library was already built)
ptxas_report: dict[str, str] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA "
                           "toolkit that builds the port's kernels")
    return found


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed.
    Different kernels build concurrently when loaded from different
    threads."""
    with _lock:
        name_lock = _name_locks.setdefault(name, threading.Lock())
    with name_lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        src = _SRC / f"{name}.cu"
        digest = hashlib.sha256(
            src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
        so = _OUT / f"lib{name}-{digest[:16]}.so"
        if not so.exists():
            _OUT.mkdir(exist_ok=True)
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            with perf.span("build.kernel"):
                r = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                                    str(src)], capture_output=True, text=True)
            if r.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name}:\n"
                                   f"{r.stderr}")
            os.replace(tmp, so)
            ptxas_report[name] = r.stderr
        lib = ctypes.CDLL(str(so))
        _libs[name] = lib
        return lib
