"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/*.cu`` source compiles on its own into a shared library with a
plain C interface (no PyTorch headers: seconds, not minutes), for Hopper
only (``sm_90a``).  Libraries land in ``build/repro_torch/`` at the root of
the checkout, named by a hash of their source and flags, so a changed source
rebuilds and an unchanged one loads at once.  Nothing is built at import:
the first launch builds, and ``build_all`` builds every source in parallel
(one ``nvcc`` process each) for callers that want the cost up front.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
from typing import Dict, Optional

__all__ = ["KERNEL_SOURCES", "NVCC_FLAGS", "build_dir", "build", "build_all",
           "load", "build_logs"]

_PKG = pathlib.Path(__file__).resolve().parents[1]          # src/repro_torch

#: kernel name -> CUDA source, relative to the package
KERNEL_SOURCES: Dict[str, str] = {
    "lmme": "kernels/lmme/csrc/lmme.cu",
    "matrix_scan": "kernels/goom_scan/csrc/matrix_scan.cu",
    "matrix_scan_zero_b": "kernels/goom_scan/csrc/matrix_scan_zero_b.cu",
    "diag_scan": "kernels/goom_scan/csrc/diag_scan.cu",
}

#: no --use_fast_math: the kernels hold expf/logf to IEEE f32 accuracy
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
_LOGS: Dict[str, str] = {}


def build_dir() -> pathlib.Path:
    """``build/repro_torch`` beside ``src/`` in the checkout."""
    return _PKG.parents[1] / "build" / "repro_torch"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def build(name: str) -> pathlib.Path:
    """Compile kernel ``name`` if its library is missing; return its path."""
    src = _PKG / KERNEL_SOURCES[name]
    text = src.read_bytes()
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = build_dir() / f"lib{name}-{digest}.so"
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    _LOGS[name] = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {src.name} "
                           f"(exit {proc.returncode}):\n{_LOGS[name]}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return out


def build_all() -> Dict[str, pathlib.Path]:
    """Build every kernel source at once, one ``nvcc`` per source."""
    with concurrent.futures.ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        futures = {n: pool.submit(build, n) for n in KERNEL_SOURCES}
        return {n: f.result() for n, f in futures.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            _LIBS[name] = lib
        return lib


def build_logs() -> Dict[str, Optional[str]]:
    """What ``nvcc`` (with ``-Xptxas -v``) printed for each kernel built by
    this process; None for one that was loaded from an earlier build."""
    return {n: _LOGS.get(n) for n in KERNEL_SOURCES}
