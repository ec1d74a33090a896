"""Hand-written CUDA kernels: fused instance norm + style modulation (+ act),
forward and backward.

Replace ``de_i2i_gan_tpu/ops/pallas/norm_kernels.py::_fwd_kernel`` and
``::_bwd_kernel``. Both live in ``de_i2i_gan_torch/csrc/modulated_instance_norm.cu``,
built with ``nvcc`` at first use into ``build/de_i2i_gan_torch/`` beside the
package (one shared library with a plain C interface, loaded once with
ctypes). Importing this module neither needs nor runs ``nvcc``.

Each call is planned by ``plan``, a pure function of the row length, the
dtype and the pointers' alignment, into one of four tiers (the ``.cu``
header says what each does): W, a warp per row held in registers, for
aligned rows of at most 1024 elements; B, a block per row held in
registers, for aligned rows of at most 1024 16-byte vectors; C, a cluster
of 1, 2, 4 or 8 blocks per row, the row's slices in shared memory, for
longer aligned rows that a cluster of 8 holds; S, streaming, for the rest.
The C side checks the plan again and refuses one its kernels do not take.

The wrappers take CUDA tensors only: they launch the planned tier (or the
one a caller forces with ``tier=``) or raise. The plain versions for CPU
tensors are ``ops/fused.py::modulated_instance_norm_ref`` and
``::modulated_instance_norm_bwd_ref``. The model code reaches the kernels
through two ``torch.library`` custom ops,
``torch.ops.de_i2i_gan_torch.modulated_instance_norm_fwd`` and ``..._bwd``:
on a CUDA tensor each launches its kernel, on a CPU tensor each runs the
plain version, and under FakeTensor tracing (``torch.export``) each gives
its outputs' shapes, so an exported graph holds the op and its artifact
launches the kernel. ``LAUNCHES`` and ``BWD_LAUNCHES``
count the forward and backward kernels' launches, so a run can show its path
went through them; ``TIER_LAUNCHES`` counts them by tier.

The split forward, for rows split over ranks (height-sharded inference,
``parallel/spatial.py``), is two more kernels of the same library and two
more ops, forward only: ``modulated_instance_norm_moments`` (each row's f32
sum and sum of squares, (2, N, C)) and ``modulated_instance_norm_apply`` (y
from the row's mean and inv, given from outside). ``SPLIT_LAUNCHES`` counts
their launches, apart from ``LAUNCHES``.
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
VECTOR_ELEMS = {torch.float32: 4, torch.bfloat16: 8}  # in 16 bytes

# the planner's limits, as the .cu's kThreads, kWarpRowMax, kBlockVectors,
# kSliceBudget and cluster sizes: a block's threads; the longest row a warp
# holds (tier W); the 16-byte vectors of the longest row a block holds in
# registers (tier B); the shared memory a block may give its slices (tier
# C), which leaves two blocks resident on each SM
BLOCK_THREADS = 256
WARP_ROW_MAX = 1024
BLOCK_ROW_VECTORS = BLOCK_THREADS * 4
SLICE_BUDGET = 98304
CLUSTER_SIZES = (1, 2, 4, 8)
TIERS = ("W", "B", "C", "S")  # in the planner's order of preference
TIER_CODES = {"S": 0, "W": 1, "C": 2, "B": 3}
SLICE_TENSORS = {"fwd": 1, "bwd": 2}  # x; x and dy

# kernel launches since the last reset (forward, backward), and the same by
# tier; incremented only where a launch succeeded
LAUNCHES = 0
BWD_LAUNCHES = 0
TIER_LAUNCHES = {op: dict.fromkeys(TIERS, 0) for op in SLICE_TENSORS}
# the split forward's launches since the last reset
SPLIT_LAUNCHES = {"moments": 0, "apply": 0}

_fn = None  # (forward, backward, occupancy, moments, apply) once loaded


class Plan(NamedTuple):
    """One launch of a kernel: its tier, the rows a block takes, threads a
    block, blocks a cluster (a row), and dynamic shared memory in bytes."""
    tier: str
    rows_per_block: int
    threads: int
    cluster: int
    smem: int


def _vector(dtype: torch.dtype) -> int:
    """Elements in a 16-byte vector of ``dtype``."""
    if dtype not in VECTOR_ELEMS:
        raise TypeError(f"x must be float32 or bfloat16, got {dtype}")
    return VECTOR_ELEMS[dtype]


def _plans(op: str, hw: int, dtype: torch.dtype, aligned: bool) -> dict:
    """The tiers the kernels take for one call, each with its plan."""
    if op not in SLICE_TENSORS:
        raise ValueError(f"op must be 'fwd' or 'bwd', got {op!r}")
    if hw <= 0:
        raise ValueError(f"rows must be non-empty, got hw={hw}")
    v = _vector(dtype)
    plans = {"S": Plan("S", 1, BLOCK_THREADS, 1, 0)}
    if not aligned or hw % v:
        return plans
    if hw <= WARP_ROW_MAX:
        plans["W"] = Plan("W", BLOCK_THREADS // 32, BLOCK_THREADS, 1, 0)
    if hw // v <= BLOCK_ROW_VECTORS:
        plans["B"] = Plan("B", 1, BLOCK_THREADS, 1, 0)
    for cs in CLUSTER_SIZES:
        smem = SLICE_TENSORS[op] * -(-(hw // v) // cs) * 16
        if smem <= SLICE_BUDGET:
            plans["C"] = Plan("C", 1, BLOCK_THREADS, cs, smem)
            break
    return plans


def plan(op: str, hw: int, dtype: torch.dtype, aligned: bool,
         tier: Optional[str] = None) -> Plan:
    """The launch of the forward (``op="fwd"``) or backward (``"bwd"``)
    kernel for rows of ``hw`` elements of ``dtype`` whose pointers are all
    16-byte aligned (``aligned``).

    Tier W for rows of whole 16-byte vectors up to ``WARP_ROW_MAX``
    elements; else tier B for rows of up to ``BLOCK_ROW_VECTORS`` vectors;
    else tier C with the fewest blocks a row (1, 2, 4, 8) whose slices (of
    x, and of dy in the backward) fit ``SLICE_BUDGET`` bytes a block; else
    tier S. ``tier`` forces one tier (C still takes its fewest blocks); a
    tier the kernels do not take for the call raises ValueError.
    """
    plans = _plans(op, hw, dtype, aligned)
    if tier is None:
        return next(plans[t] for t in TIERS if t in plans)
    if tier not in TIER_CODES:
        raise ValueError(f"tier must be one of {TIERS}, got {tier!r}")
    if tier not in plans:
        raise ValueError(
            f"tier {tier} cannot run the {op} kernel on rows of {hw} "
            f"{str(dtype)[6:]} elements ({'' if aligned else 'un'}aligned); "
            f"it can run {', '.join(t for t in TIERS if t in plans)}")
    return plans[tier]


def feasible_tiers(op: str, hw: int, dtype: torch.dtype,
                   aligned: bool = True) -> Tuple[str, ...]:
    """The tiers the kernels take for one call, in the planner's order."""
    plans = _plans(op, hw, dtype, aligned)
    return tuple(t for t in TIERS if t in plans)


def longest_cluster_row(op: str, dtype: torch.dtype, cluster: int) -> int:
    """The longest aligned row that tier C holds with ``cluster`` blocks."""
    return cluster * (SLICE_BUDGET // (16 * SLICE_TENSORS[op])) * _vector(dtype)


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
    """The library's (forward, backward, occupancy) entry points; builds it
    first if no library of this source exists."""
    global _fn
    if _fn is None:
        path = _library_path()
        if not path.exists():
            path = build().path
        lib = ctypes.CDLL(str(path))
        plan_args = [ctypes.c_int] * 5  # tier, rows a block, threads, cluster, smem
        fwd = lib.dig_modulated_instance_norm_fwd
        fwd.argtypes = [ctypes.c_void_p] * 6 + [
            ctypes.c_int64, ctypes.c_int64, ctypes.c_float, ctypes.c_int,
            ctypes.c_int, *plan_args, ctypes.c_int, ctypes.c_void_p]
        fwd.restype = ctypes.c_int
        bwd = lib.dig_modulated_instance_norm_bwd
        bwd.argtypes = [ctypes.c_void_p] * 9 + [
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
            *plan_args, ctypes.c_int, ctypes.c_void_p]
        bwd.restype = ctypes.c_int
        occ = lib.dig_modulated_instance_norm_occupancy
        occ.argtypes = [ctypes.c_int, ctypes.c_int64, ctypes.c_int,
                        ctypes.c_int, *plan_args, ctypes.c_int,
                        ctypes.POINTER(ctypes.c_int),
                        ctypes.POINTER(ctypes.c_int)]
        occ.restype = ctypes.c_int
        moments = lib.dig_modulated_instance_norm_moments
        moments.argtypes = [ctypes.c_void_p] * 2 + [
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p]
        moments.restype = ctypes.c_int
        apply = lib.dig_modulated_instance_norm_apply
        apply.argtypes = [ctypes.c_void_p] * 6 + [
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p]
        apply.restype = ctypes.c_int
        _fn = (fwd, bwd, occ, moments, apply)
    return _fn


def _plan_args(p: Plan) -> Tuple[int, ...]:
    return (TIER_CODES[p.tier], p.rows_per_block, p.threads, p.cluster, p.smem)


def _aligned(*ts: torch.Tensor) -> bool:
    """16-byte vector loads and TMA copies need rows that start on 16-byte
    boundaries (plan checks the row length)."""
    return all(t.data_ptr() % 16 == 0 for t in ts)


def occupancy(op: str, hw: int, dtype: torch.dtype, act: Optional[str] = None,
              tier: Optional[str] = None, device: int = 0) -> Tuple[Plan, int, int]:
    """(plan, blocks resident on one SM, clusters resident on the card) of
    the kernel that runs aligned rows of ``hw`` elements; the clusters are
    ``cudaOccupancyMaxActiveClusters``'s count, 0 outside tier C."""
    p = plan(op, hw, dtype, True, tier)
    blocks, clusters = ctypes.c_int(0), ctypes.c_int(0)
    rc = _kernel()[2](0 if op == "fwd" else 1, hw, ACT_CODES[act],
                      DTYPE_CODES[dtype], *_plan_args(p), device,
                      ctypes.byref(blocks), ctypes.byref(clusters))
    if rc != 0:
        raise RuntimeError(f"occupancy query of {p} failed: cudaError {rc}")
    return p, blocks.value, clusters.value


def _check_x(x: torch.Tensor) -> None:
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


def _check(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
           act: Optional[str]) -> None:
    _check_x(x)
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
                                eps: float = 1e-5, *, tier: Optional[str] = None
                                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the forward kernel: (y, mean, inv) for NCHW-contiguous CUDA x
    and (N, C) gamma/beta. y has x's dtype; mean and inv are float32 (N, C),
    the residuals a backward kernel needs. ``tier`` forces a tier of
    ``plan`` (and raises where that tier cannot run the call)."""
    global LAUNCHES
    _check(x, gamma, beta, act)
    n, c, h, w = x.shape
    hw = h * w
    g = gamma.to(torch.float32).contiguous()
    b = beta.to(torch.float32).contiguous()
    y = torch.empty_like(x)
    mean = torch.empty((n, c), dtype=torch.float32, device=x.device)
    inv = torch.empty_like(mean)
    p = plan("fwd", hw, x.dtype, _aligned(x, y), tier)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _kernel()[0](x.data_ptr(), g.data_ptr(), b.data_ptr(), y.data_ptr(),
                       mean.data_ptr(), inv.data_ptr(), n * c, hw, eps,
                       ACT_CODES[act], DTYPE_CODES[x.dtype], *_plan_args(p),
                       x.device.index, stream)
    if rc != 0:
        raise RuntimeError(f"modulated instance norm kernel launch failed "
                           f"({p}): cudaError {rc}")
    LAUNCHES += 1
    TIER_LAUNCHES["fwd"][p.tier] += 1
    return y, mean, inv


def modulated_instance_norm_bwd(x: torch.Tensor, gamma: torch.Tensor,
                                beta: torch.Tensor, mean: torch.Tensor,
                                inv: torch.Tensor, dy: torch.Tensor,
                                act: Optional[str] = None, *,
                                tier: Optional[str] = None
                                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the backward kernel: (dx, dgamma, dbeta) for NCHW-contiguous
    CUDA x and dy of one dtype, (N, C) gamma/beta and the forward's float32
    (N, C) mean and inv. dx has x's dtype; dgamma and dbeta are float32.
    ``tier`` forces a tier of ``plan``."""
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
    p = plan("bwd", h * w, x.dtype, _aligned(x, dy, dx), tier)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _kernel()[1](x.data_ptr(), g.data_ptr(), b.data_ptr(),
                       mean.data_ptr(), inv.data_ptr(), dy.data_ptr(),
                       dx.data_ptr(), dg.data_ptr(), db.data_ptr(), n * c,
                       h * w, ACT_CODES[act], DTYPE_CODES[x.dtype],
                       *_plan_args(p), x.device.index, stream)
    if rc != 0:
        raise RuntimeError(f"modulated instance norm backward kernel launch "
                           f"failed ({p}): cudaError {rc}")
    BWD_LAUNCHES += 1
    TIER_LAUNCHES["bwd"][p.tier] += 1
    return dx, dg, db


def modulated_instance_norm_moments(x: torch.Tensor) -> torch.Tensor:
    """Launch the moments kernel: the float32 (2, N, C) sums of x and of
    x**2 over each (n, c) row of NCHW-contiguous CUDA x (this rank's rows
    of it)."""
    _check_x(x)
    n, c, h, w = x.shape
    sums = torch.empty((2, n, c), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _kernel()[3](x.data_ptr(), sums.data_ptr(), n * c, h * w,
                      DTYPE_CODES[x.dtype], x.device.index, stream)
    if rc != 0:
        raise RuntimeError(f"moments kernel launch failed: cudaError {rc}")
    SPLIT_LAUNCHES["moments"] += 1
    return sums


def modulated_instance_norm_apply(x: torch.Tensor, mean: torch.Tensor,
                                  inv: torch.Tensor, gamma: torch.Tensor,
                                  beta: torch.Tensor, act: Optional[str] = None
                                  ) -> torch.Tensor:
    """Launch the apply kernel: ``act((x - mean) * inv * (1 + gamma) +
    beta)`` in x's dtype for NCHW-contiguous CUDA x and (N, C) mean, inv
    (float32), gamma and beta."""
    _check(x, gamma, beta, act)
    n, c, h, w = x.shape
    for name, t in (("mean", mean), ("inv", inv)):
        if t.shape != (n, c) or t.dtype != torch.float32 or t.device != x.device:
            raise ValueError(f"{name} must be float32 ({n}, {c}) on {x.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    args = [t.to(torch.float32).contiguous() for t in (mean, inv, gamma, beta)]
    y = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _kernel()[4](x.data_ptr(), *(t.data_ptr() for t in args), y.data_ptr(),
                      n * c, h * w, ACT_CODES[act], DTYPE_CODES[x.dtype],
                      x.device.index, stream)
    if rc != 0:
        raise RuntimeError(f"apply kernel launch failed: cudaError {rc}")
    SPLIT_LAUNCHES["apply"] += 1
    return y


# ------------------------------------------------- the torch.library ops
# Both kernels are custom ops, so that torch.export and FakeTensor tracing
# see through them: a CUDA implementation (the launch above), a CPU one (the
# plain version, for opcheck and export on the CPU), a fake one (shapes,
# dtypes and strides as the kernels write them) and, for the forward, an
# autograd formula that runs the backward op.
OPS = "de_i2i_gan_torch"
Tensor = torch.Tensor


@torch.library.custom_op(f"{OPS}::modulated_instance_norm_fwd", mutates_args=(),
                         device_types="cuda")
def _fwd_op(x: Tensor, gamma: Tensor, beta: Tensor, act: Optional[str],
            eps: float) -> Tuple[Tensor, Tensor, Tensor]:
    return modulated_instance_norm_fwd(x, gamma, beta, act, eps)


@_fwd_op.register_kernel("cpu")
def _fwd_op_cpu(x, gamma, beta, act, eps):
    from de_i2i_gan_torch.ops.fused import modulated_instance_norm_ref
    y, mean, inv = modulated_instance_norm_ref(x, gamma, beta, act, eps)
    return y.contiguous(), mean.contiguous(), inv.contiguous()


@_fwd_op.register_fake
def _fwd_op_fake(x, gamma, beta, act, eps):
    n, c = x.shape[:2]
    stats = x.new_empty((n, c), dtype=torch.float32)
    return (torch.empty_like(x, memory_format=torch.contiguous_format),
            stats, torch.empty_like(stats))


@torch.library.custom_op(f"{OPS}::modulated_instance_norm_bwd", mutates_args=(),
                         device_types="cuda")
def _bwd_op(x: Tensor, gamma: Tensor, beta: Tensor, mean: Tensor, inv: Tensor,
            dy: Tensor, act: Optional[str]) -> Tuple[Tensor, Tensor, Tensor]:
    return modulated_instance_norm_bwd(x, gamma, beta, mean, inv,
                                       dy.contiguous(), act)


@_bwd_op.register_kernel("cpu")
def _bwd_op_cpu(x, gamma, beta, mean, inv, dy, act):
    from de_i2i_gan_torch.ops.fused import modulated_instance_norm_bwd_ref
    return modulated_instance_norm_bwd_ref(x, gamma, beta, mean, inv, dy, act)


@_bwd_op.register_fake
def _bwd_op_fake(x, gamma, beta, mean, inv, dy, act):
    n, c = x.shape[:2]
    grads = x.new_empty((n, c), dtype=torch.float32)
    return (torch.empty_like(x, memory_format=torch.contiguous_format),
            grads, torch.empty_like(grads))


def _fwd_setup(ctx, inputs, output):
    x, gamma, beta, act, _ = inputs
    _, mean, inv = output
    ctx.act = act
    ctx.save_for_backward(x, gamma, beta, mean, inv)


@once_differentiable
def _fwd_backward(ctx, dy, _dmean, _dinv):
    """The backward op, fed the forward's own mean and inv. Once
    differentiable: a double backward through it (a gradient penalty
    through a styled norm) raises rather than return a dx without a
    graph."""
    x, gamma, beta, mean, inv = ctx.saved_tensors
    dx, dg, db = _bwd_op(x, gamma, beta, mean, inv, dy, ctx.act)
    return dx, dg.to(gamma.dtype), db.to(beta.dtype), None, None


_fwd_op.register_autograd(_fwd_backward, setup_context=_fwd_setup)


def cuda_modulated_instance_norm(x: torch.Tensor, gamma: torch.Tensor,
                                 beta: torch.Tensor, act: Optional[str] = None,
                                 eps: float = 1e-5) -> torch.Tensor:
    """The forward op's y, differentiable through the backward op."""
    return _fwd_op(x, gamma, beta, act, eps)[0]


# The split forward's ops: inference only, so no autograd formula; a call on
# a tensor that requires grad raises before the op (``split_moments``,
# ``split_apply``).
@torch.library.custom_op(f"{OPS}::modulated_instance_norm_moments",
                         mutates_args=(), device_types="cuda")
def _moments_op(x: Tensor) -> Tensor:
    return modulated_instance_norm_moments(x)


@_moments_op.register_kernel("cpu")
def _moments_op_cpu(x):
    from de_i2i_gan_torch.ops.fused import modulated_instance_norm_moments_ref
    return modulated_instance_norm_moments_ref(x)


@_moments_op.register_fake
def _moments_op_fake(x):
    return x.new_empty((2, *x.shape[:2]), dtype=torch.float32)


@torch.library.custom_op(f"{OPS}::modulated_instance_norm_apply",
                         mutates_args=(), device_types="cuda")
def _apply_op(x: Tensor, mean: Tensor, inv: Tensor, gamma: Tensor,
              beta: Tensor, act: Optional[str]) -> Tensor:
    return modulated_instance_norm_apply(x, mean, inv, gamma, beta, act)


@_apply_op.register_kernel("cpu")
def _apply_op_cpu(x, mean, inv, gamma, beta, act):
    from de_i2i_gan_torch.ops.fused import modulated_instance_norm_apply_ref
    return modulated_instance_norm_apply_ref(x, mean, inv, gamma, beta,
                                             act).contiguous()


@_apply_op.register_fake
def _apply_op_fake(x, mean, inv, gamma, beta, act):
    return torch.empty_like(x, memory_format=torch.contiguous_format)


def _forward_only(*ts: torch.Tensor) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise RuntimeError(
            "the split modulated instance norm is inference only: call it "
            "under torch.no_grad() on tensors that do not require grad")


def split_moments(x: torch.Tensor) -> torch.Tensor:
    """The moments op's (2, N, C) float32 sums; forward only."""
    _forward_only(x)
    return _moments_op(x)


def split_apply(x: torch.Tensor, mean: torch.Tensor, inv: torch.Tensor,
                gamma: torch.Tensor, beta: torch.Tensor,
                act: Optional[str] = None) -> torch.Tensor:
    """The apply op's y; forward only."""
    _forward_only(x, mean, inv, gamma, beta)
    return _apply_op(x, mean, inv, gamma, beta, act)
