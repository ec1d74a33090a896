"""Hand-written CUDA kernels: fused instance norm + style modulation (+ act),
forward and backward.

Replace ``de_i2i_gan_tpu/ops/pallas/norm_kernels.py::_fwd_kernel`` and
``::_bwd_kernel``. Both live in ``de_i2i_gan_torch/csrc/modulated_instance_norm.cu``,
built with ``nvcc`` at first use into ``build/de_i2i_gan_torch/`` beside the
package (one shared library with a plain C interface, loaded once with
ctypes). Importing this module neither needs nor runs ``nvcc``.

The wrappers take CUDA tensors only: they launch the kernel or raise. The
plain versions for CPU tensors are ``ops/fused.py::modulated_instance_norm_ref``
and ``::modulated_instance_norm_bwd_ref``. ``LAUNCHES`` and ``BWD_LAUNCHES``
count the forward and backward kernels' launches, so a run can show its path
went through them.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple, Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

_PKG = Path(__file__).resolve().parents[2]
SOURCE = _PKG / "csrc" / "modulated_instance_norm.cu"
BUILD_DIR = _PKG.parent / "build" / "de_i2i_gan_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
ACT_CODES = {None: 0, "relu": 1, "leaky_relu": 2}
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches since the last reset (forward, backward); incremented only
# where a launch succeeded
LAUNCHES = 0
BWD_LAUNCHES = 0

_fn = None  # (forward, backward) entry points once loaded


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
            "modulated instance norm kernel cannot be built")
    return found


def _library_path() -> Path:
    """Build output named by a hash of the source and flags, so an edited
    source never loads a stale library."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libdig_norm_{h.hexdigest()[:16]}.so"


def build() -> BuildInfo:
    """Compile the kernel source with nvcc; raises if nvcc fails."""
    out = _library_path()
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent build never loads a torn file
    return BuildInfo(out, seconds, log)


def _kernel():
    """The library's (forward, backward) entry points; builds it first if no
    library of this source exists."""
    global _fn
    if _fn is None:
        path = _library_path()
        if not path.exists():
            path = build().path
        lib = ctypes.CDLL(str(path))
        fwd = lib.dig_modulated_instance_norm_fwd
        fwd.argtypes = [ctypes.c_void_p] * 6 + [
            ctypes.c_int64, ctypes.c_int64, ctypes.c_float, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fwd.restype = ctypes.c_int
        bwd = lib.dig_modulated_instance_norm_bwd
        bwd.argtypes = [ctypes.c_void_p] * 9 + [
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        bwd.restype = ctypes.c_int
        _fn = (fwd, bwd)
    return _fn


def _aligned(*ts: torch.Tensor) -> bool:
    """16-byte vector loads need rows that start on 16-byte boundaries."""
    hw = ts[0].shape[2] * ts[0].shape[3]
    return (hw % (16 // ts[0].element_size()) == 0
            and all(t.data_ptr() % 16 == 0 for t in ts))


def _check(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
           act: Optional[str]) -> None:
    if not x.is_cuda:
        raise ValueError(
            f"the CUDA kernel takes CUDA tensors, got x on {x.device}; CPU "
            "tensors go through ops.fused.modulated_instance_norm")
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 4 or x.shape[2] * x.shape[3] == 0:
        raise ValueError(f"x must be non-empty NCHW, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("x must be NCHW-contiguous")
    n, c = x.shape[:2]
    for name, t in (("gamma", gamma), ("beta", beta)):
        if t.shape != (n, c):
            raise ValueError(f"{name} must be ({n}, {c}), got {tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_floating_point():
            raise TypeError(f"{name} must be floating point, got {t.dtype}")
    if act not in ACT_CODES:
        raise ValueError(f"unsupported fused activation {act}")


def modulated_instance_norm_fwd(x: torch.Tensor, gamma: torch.Tensor,
                                beta: torch.Tensor, act: Optional[str] = None,
                                eps: float = 1e-5
                                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the forward kernel: (y, mean, inv) for NCHW-contiguous CUDA x
    and (N, C) gamma/beta. y has x's dtype; mean and inv are float32 (N, C),
    the residuals a backward kernel needs."""
    global LAUNCHES
    _check(x, gamma, beta, act)
    n, c, h, w = x.shape
    hw = h * w
    g = gamma.to(torch.float32).contiguous()
    b = beta.to(torch.float32).contiguous()
    y = torch.empty_like(x)
    mean = torch.empty((n, c), dtype=torch.float32, device=x.device)
    inv = torch.empty_like(mean)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _kernel()[0](x.data_ptr(), g.data_ptr(), b.data_ptr(), y.data_ptr(),
                       mean.data_ptr(), inv.data_ptr(), n * c, hw, eps,
                       ACT_CODES[act], DTYPE_CODES[x.dtype],
                       int(_aligned(x, y)), x.device.index, stream)
    if rc != 0:
        raise RuntimeError(f"modulated instance norm kernel launch failed: "
                           f"cudaError {rc}")
    LAUNCHES += 1
    return y, mean, inv


def modulated_instance_norm_bwd(x: torch.Tensor, gamma: torch.Tensor,
                                beta: torch.Tensor, mean: torch.Tensor,
                                inv: torch.Tensor, dy: torch.Tensor,
                                act: Optional[str] = None
                                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the backward kernel: (dx, dgamma, dbeta) for NCHW-contiguous
    CUDA x and dy of one dtype, (N, C) gamma/beta and the forward's float32
    (N, C) mean and inv. dx has x's dtype; dgamma and dbeta are float32."""
    global BWD_LAUNCHES
    _check(x, gamma, beta, act)
    n, c, h, w = x.shape
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(
            f"dy must match x ({tuple(x.shape)}, {x.dtype}, {x.device}), got "
            f"({tuple(dy.shape)}, {dy.dtype}, {dy.device})")
    if not dy.is_contiguous():
        raise ValueError("dy must be NCHW-contiguous")
    for name, t in (("mean", mean), ("inv", inv)):
        if t.shape != (n, c) or t.dtype != torch.float32 or t.device != x.device:
            raise ValueError(f"{name} must be float32 ({n}, {c}) on {x.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    g = gamma.to(torch.float32).contiguous()
    b = beta.to(torch.float32).contiguous()
    mean, inv = mean.contiguous(), inv.contiguous()
    dx = torch.empty_like(x)
    dg = torch.empty((n, c), dtype=torch.float32, device=x.device)
    db = torch.empty_like(dg)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _kernel()[1](x.data_ptr(), g.data_ptr(), b.data_ptr(),
                       mean.data_ptr(), inv.data_ptr(), dy.data_ptr(),
                       dx.data_ptr(), dg.data_ptr(), db.data_ptr(), n * c,
                       h * w, ACT_CODES[act], DTYPE_CODES[x.dtype],
                       int(_aligned(x, dy, dx)), x.device.index, stream)
    if rc != 0:
        raise RuntimeError(f"modulated instance norm backward kernel launch "
                           f"failed: cudaError {rc}")
    BWD_LAUNCHES += 1
    return dx, dg, db


class _ModulatedInstanceNorm(torch.autograd.Function):
    """The forward kernel's y; its backward is the backward kernel, fed the
    forward kernel's own mean and inv. Once differentiable: a double
    backward through it (a gradient penalty through a styled norm) raises
    rather than return a dx without a graph."""

    @staticmethod
    def forward(ctx, x, gamma, beta, act, eps):
        y, mean, inv = modulated_instance_norm_fwd(x, gamma, beta, act, eps)
        ctx.act = act
        ctx.save_for_backward(x, gamma, beta, mean, inv)
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, gamma, beta, mean, inv = ctx.saved_tensors
        dx, dg, db = modulated_instance_norm_bwd(
            x, gamma, beta, mean, inv, dy.contiguous(), ctx.act)
        return dx, dg.to(gamma.dtype), db.to(beta.dtype), None, None


def cuda_modulated_instance_norm(x: torch.Tensor, gamma: torch.Tensor,
                                 beta: torch.Tensor, act: Optional[str] = None,
                                 eps: float = 1e-5) -> torch.Tensor:
    """The forward kernel's y, differentiable through the backward kernel."""
    return _ModulatedInstanceNorm.apply(x, gamma, beta, act, eps)
