"""The one shared library of the port's hand-written CUDA kernels.

Every source under ``de_i2i_gan_torch/csrc/`` (``SOURCES``: the modulated
instance norm's kernels and the reflect pad's) is compiled by one ``nvcc``
call, at first use, into ``build/de_i2i_gan_torch/`` beside the package, and
loaded once with ctypes. Each source has a plain C interface; the kernel
modules (``norm_kernels.py``, ``pad_kernels.py``) bind their entry points
from ``load()``. Importing this module neither needs nor runs ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple, Optional

_PKG = Path(__file__).resolve().parents[2]
SOURCES = (_PKG / "csrc" / "modulated_instance_norm.cu",
           _PKG / "csrc" / "reflect_pad.cu")
BUILD_DIR = _PKG.parent / "build" / "de_i2i_gan_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib: Optional[ctypes.CDLL] = None


class BuildInfo(NamedTuple):
    path: Path
    seconds: float
    log: str  # nvcc's output, with the -Xptxas -v resource lines


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH): the "
            "port's CUDA kernels cannot be built")
    return found


def library_path() -> Path:
    """Build output named by a hash of the sources and flags, so an edited
    source never loads a stale library."""
    h = hashlib.sha256()
    for src in SOURCES:
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libdig_kernels_{h.hexdigest()[:16]}.so"


def build() -> BuildInfo:
    """Compile every source with one nvcc call; raises if nvcc fails."""
    out = library_path()
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent build never loads a torn file
    return BuildInfo(out, seconds, log)


def load() -> ctypes.CDLL:
    """The loaded library; builds it first if no library of these sources
    exists."""
    global _lib
    if _lib is None:
        path = library_path()
        if not path.exists():
            path = build().path
        _lib = ctypes.CDLL(str(path))
    return _lib
