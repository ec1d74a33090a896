"""Hand-written CUDA kernels: reflect padding of NCHW images on H and W,
forward and backward.

They replace aten's ``reflection_pad2d`` (at about a fifth of its bytes'
bound on the card) and its backward (a zero fill and an atomic scatter) for
CUDA tensors. No TPU kernel stands behind them: the JAX package pads with
``jnp.pad``, which XLA fuses into the convolution. Both live in
``de_i2i_gan_torch/csrc/reflect_pad.cu`` (its header says what bounds them
and how a thread takes its work), in the library ``library.py`` builds at
first use. Importing this module neither needs nor runs ``nvcc``.

``reflect_pad_fwd`` and ``reflect_pad_bwd`` launch the kernels; they take
CUDA tensors only and launch or raise. The plain versions are
``reflect_pad_ref`` (``F.pad``, or gathers by ``reflect_index`` where a pad
reaches its axis: repeated reflection, which ``F.pad`` refuses) and
``reflect_pad_bwd_ref`` (the adjoint by ``index_add_``, summed in float32
and rounded once). The model code calls ``reflect_pad``, the
``torch.library`` custom op ``de_i2i_gan_torch::reflect_pad2d``: on a CUDA
tensor it launches the forward kernel, on a CPU tensor it runs the plain
version, and under FakeTensor tracing (``torch.export``) it gives its
output's shape. Its autograd formula is the op
``de_i2i_gan_torch::reflect_pad2d_bwd``, whose own formula is the forward
op again (the map is linear and each is the other's adjoint), so a double
backward through a padded convolution works.

``LAUNCHES`` and ``BWD_LAUNCHES`` count the launches of the forward and the
backward kernel. Their sum is the counter source ``pad.launches`` of
``utils/profiling.py``, and both are registered as host counts there, so a
CUDA graph's replay adds the launches its capture counted.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from de_i2i_gan_torch.ops.cuda import library
from de_i2i_gan_torch.utils import profiling

Pads4 = Tuple[int, int, int, int]  # top, bottom, left, right
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches since the last reset; incremented only where a launch
# succeeded
LAUNCHES = 0
BWD_LAUNCHES = 0
profiling.register_counter("pad.launches", lambda: LAUNCHES + BWD_LAUNCHES)


def _counts() -> Dict[str, int]:
    return {"fwd": LAUNCHES, "bwd": BWD_LAUNCHES}


def _add_counts(delta: Dict[str, int]) -> None:
    global LAUNCHES, BWD_LAUNCHES
    LAUNCHES += delta["fwd"]
    BWD_LAUNCHES += delta["bwd"]


profiling.register_host_counts("pad_kernels", _counts, _add_counts)

_fn = None  # (forward, backward) once loaded


def _kernel():
    """The library's (forward, backward) entry points; builds it first if
    no library of these sources exists."""
    global _fn
    if _fn is None:
        lib = library.load()
        _fn = (lib.dig_reflect_pad_fwd, lib.dig_reflect_pad_bwd)
        for f in _fn:
            f.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int64] * 7 + [
                ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            f.restype = ctypes.c_int
    return _fn


def reflect_index(n: int, lo: int, hi: int, device) -> torch.Tensor:
    """Source rows of a reflect pad of (lo, hi) on an axis of length n, with
    numpy's repeated-reflection semantics when the pad is >= the axis (the
    case where ``F.pad(mode="reflect")`` raises)."""
    idx = torch.arange(-lo, n + hi, device=device)
    if n == 1:
        return torch.zeros_like(idx)
    period = 2 * (n - 1)
    idx = torch.remainder(idx, period)
    return torch.where(idx >= n, period - idx, idx)


def reflect_pad_ref(x: torch.Tensor, pads: Sequence[int]) -> torch.Tensor:
    """Plain version of the forward: NCHW ``x`` reflect-padded by ``pads``
    (top, bottom, left, right)."""
    pt, pb, pl, pr = pads
    h, w = x.shape[-2:]
    if max(pt, pb) < h and max(pl, pr) < w:
        return F.pad(x, (pl, pr, pt, pb), mode="reflect")
    # pad wider than the axis (tiny feature maps): repeated reflection
    x = x.index_select(-2, reflect_index(h, pt, pb, x.device))
    return x.index_select(-1, reflect_index(w, pl, pr, x.device))


def reflect_pad_bwd_ref(dy: torch.Tensor, pads: Sequence[int], h: int,
                        w: int) -> torch.Tensor:
    """Plain version of the backward: the adjoint of ``reflect_pad_ref`` for
    an (N, C, h, w) input, each element the sum of the ``dy`` elements
    padded from it, summed in float32 (float64 stays float64) and rounded
    once to dy's dtype."""
    pt, pb, pl, pr = pads
    acc = dy.to(torch.promote_types(dy.dtype, torch.float32))
    n, c, _, wo = dy.shape
    rows = acc.new_zeros((n, c, h, wo)).index_add_(
        2, reflect_index(h, pt, pb, dy.device), acc)
    dx = acc.new_zeros((n, c, h, w)).index_add_(
        3, reflect_index(w, pl, pr, dy.device), rows)
    return dx.to(dy.dtype)


def _pads(pads: Sequence[int]) -> Pads4:
    if len(pads) != 4 or any(int(p) != p or p < 0 for p in pads):
        raise ValueError(f"pads must be 4 integers >= 0 (top, bottom, left, "
                         f"right), got {tuple(pads)}")
    return tuple(int(p) for p in pads)


def _check(t: torch.Tensor, name: str) -> None:
    """What the kernels take; raises before any launch."""
    if t.dim() != 4 or t.shape[2] * t.shape[3] == 0:
        raise ValueError(f"{name} must be NCHW with non-empty planes, got "
                         f"{tuple(t.shape)}")
    if t.dtype not in DTYPE_CODES:
        raise TypeError(f"{name} must be float32 or bfloat16, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be NCHW-contiguous")


def _check_device(t: torch.Tensor, name: str) -> None:
    if not t.is_cuda:
        raise ValueError(
            f"the CUDA kernel takes CUDA tensors, got {name} on {t.device}; "
            "CPU tensors go through reflect_pad_ref")


def _launch(op: int, src: torch.Tensor, out: torch.Tensor, h: int, w: int,
            pads: Pads4) -> None:
    n, c = src.shape[:2]
    stream = torch.cuda.current_stream(src.device).cuda_stream
    rc = _kernel()[op](src.data_ptr(), out.data_ptr(), n * c, h, w, *pads,
                       DTYPE_CODES[src.dtype], src.device.index, stream)
    if rc != 0:
        raise RuntimeError(f"reflect pad {('forward', 'backward')[op]} kernel "
                           f"launch failed ({tuple(src.shape)}, pads {pads}): "
                           f"cudaError {rc}")


def reflect_pad_fwd(x: torch.Tensor, pads: Sequence[int]) -> torch.Tensor:
    """Launch the forward kernel: NCHW-contiguous CUDA ``x`` (float32 or
    bfloat16) reflect-padded by ``pads`` (top, bottom, left, right; any
    width, repeated reflection where one reaches the axis), in x's dtype."""
    global LAUNCHES
    pads = _pads(pads)
    _check(x, "x")
    _check_device(x, "x")
    n, c, h, w = x.shape
    pt, pb, pl, pr = pads
    y = torch.empty((n, c, h + pt + pb, w + pl + pr), dtype=x.dtype,
                    device=x.device)
    if y.numel():
        _launch(0, x, y, h, w, pads)
        LAUNCHES += 1
    return y


def reflect_pad_bwd(dy: torch.Tensor, pads: Sequence[int], h: int,
                    w: int) -> torch.Tensor:
    """Launch the backward kernel: the gradient of an (N, C, h, w) input of
    the forward from its NCHW-contiguous CUDA output gradient ``dy``, in
    dy's dtype, each element's terms summed in float32 and rounded once."""
    global BWD_LAUNCHES
    pads = _pads(pads)
    _check(dy, "dy")
    n, c, ho, wo = dy.shape
    pt, pb, pl, pr = pads
    if h < 1 or w < 1 or (ho, wo) != (h + pt + pb, w + pl + pr):
        raise ValueError(f"dy of {tuple(dy.shape)} is no pad of an input of "
                         f"{h}x{w} by {pads}")
    _check_device(dy, "dy")
    dx = torch.empty((n, c, h, w), dtype=dy.dtype, device=dy.device)
    if dx.numel():
        _launch(1, dy, dx, h, w, pads)
        BWD_LAUNCHES += 1
    return dx


# ------------------------------------------------- the torch.library ops
OPS = "de_i2i_gan_torch"
Tensor = torch.Tensor


@torch.library.custom_op(f"{OPS}::reflect_pad2d", mutates_args=(),
                         device_types="cuda")
def _fwd_op(x: Tensor, pads: List[int]) -> Tensor:
    return reflect_pad_fwd(x.contiguous(), pads)


@_fwd_op.register_kernel("cpu")
def _fwd_op_cpu(x, pads):
    return reflect_pad_ref(x, pads).contiguous()


@_fwd_op.register_fake
def _fwd_op_fake(x, pads):
    n, c, h, w = x.shape
    pt, pb, pl, pr = pads
    return x.new_empty((n, c, h + pt + pb, w + pl + pr))


@torch.library.custom_op(f"{OPS}::reflect_pad2d_bwd", mutates_args=(),
                         device_types="cuda")
def _bwd_op(dy: Tensor, pads: List[int], h: int, w: int) -> Tensor:
    return reflect_pad_bwd(dy.contiguous(), pads, h, w)


@_bwd_op.register_kernel("cpu")
def _bwd_op_cpu(dy, pads, h, w):
    return reflect_pad_bwd_ref(dy, pads, h, w)


@_bwd_op.register_fake
def _bwd_op_fake(dy, pads, h, w):
    return dy.new_empty((dy.shape[0], dy.shape[1], h, w))


def _fwd_setup(ctx, inputs, output):
    x, pads = inputs
    ctx.pads, ctx.hw = pads, tuple(x.shape[2:])


def _fwd_backward(ctx, dy):
    return _bwd_op(dy, ctx.pads, *ctx.hw), None


def _bwd_setup(ctx, inputs, output):
    ctx.pads = inputs[1]


def _bwd_backward(ctx, ddx):
    return _fwd_op(ddx, ctx.pads), None, None, None


_fwd_op.register_autograd(_fwd_backward, setup_context=_fwd_setup)
_bwd_op.register_autograd(_bwd_backward, setup_context=_bwd_setup)


def reflect_pad(x: torch.Tensor, pads: Sequence[int]) -> torch.Tensor:
    """The forward op: NCHW ``x`` reflect-padded by ``pads`` (top, bottom,
    left, right), differentiable (twice, and on) through the ops."""
    return _fwd_op(x, list(pads))
