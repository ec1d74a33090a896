"""A convolution whose backward is itself a differentiable function, for the
forwards a gradient penalty differentiates twice.

A penalty on an input gradient (R1, WGAN-GP) takes that gradient with
``create_graph`` and then differentiates it in the weights. Through aten's
own convolution node, that second pass reaches
``_convolution_double_backward``, which computes the weight term (ggx, gy ->
gw) as a *forward* convolution of transposed tensors: ggx with the layer's
input channels as the batch and the batch as channels, under a filter of
gy, whose spatial size is the layer's whole output. On an H100 cuDNN runs
that as an sm80 indexed implicit GEMM at a few TFLOP/s (StarGAN v2's D at
256², about 0.26 TFLOP a penalty in about 100 ms).

``conv2d(x, w, stride)`` runs the same forward, ``F.conv2d``, under a pair
of autograd functions whose terms are each the cuDNN call made for them:

  * the first backward, gy -> (gx, gw): ``aten.convolution_backward`` (the
    dgrad and wgrad of autograd's own node);
  * the second backward, (ggx, ggw) -> (g_gy, g_x, g_w):
      - g_gy = conv2d(ggx, w) + conv2d(x, ggw), forward convolutions;
      - g_x, the input gradient of a convolution of weight ggw under the
        grad output gy (dgrad);
      - g_w, the weight gradient of a convolution of input ggx under the
        grad output gy (wgrad): the term that changes.

Both skip every term whose incoming gradient is None
(``set_materialize_grads(False)``) and every output the running backward
will not use (the engine's own test, as aten's nodes make it): in R1's
first pass no weight gradient, and in its second no g_x, since ggw is None.
Padding stays outside, before the call; bias too.

``Conv2d.run`` (``nn/layers.py``) takes this path for a CUDA tensor in grad
mode inside ``differentiated_twice()``, a scope that a penalty's owner
enters around the forward it will differentiate twice; everywhere else it
calls ``F.conv2d`` as before. The path stays out of other forwards: there
it gains nothing, and where a weight is a leaf (a float32 net) the engine
will not say whether the running backward uses its gradient, so the pair
would take D's weight gradients in every G update, which aten's node skips.

``CALLS`` counts the second backward's calls: the counter source
``conv.double_backward`` of ``utils/profiling.py``, also registered as host
counts, so a CUDA graph's replay adds what its capture counted.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from de_i2i_gan_torch.utils import profiling

CALLS = 0  # second backward calls
profiling.register_counter("conv.double_backward", lambda: CALLS)


def _counts() -> Dict[str, int]:
    return {"calls": CALLS}


def _add_counts(delta: Dict[str, int]) -> None:
    global CALLS
    CALLS += delta["calls"]


profiling.register_host_counts("conv_grad", _counts, _add_counts)

_SCOPE = threading.local()  # depth: open differentiated_twice() scopes


@contextlib.contextmanager
def differentiated_twice():
    """The convolutions of a forward this thread runs inside take
    ``conv2d``'s path where their tensors are on CUDA and grad mode is on
    (see the module's docstring)."""
    _SCOPE.depth = in_scope() + 1
    try:
        yield
    finally:
        _SCOPE.depth -= 1


def in_scope() -> int:
    """How many ``differentiated_twice()`` scopes this thread is inside."""
    return getattr(_SCOPE, "depth", 0)


def _wanted(ctx, i: int) -> bool:
    """Whether the running backward uses the gradient of input ``i``. The
    engine answers for a node it may run; of a leaf's accumulator it will
    not answer inside ``autograd.grad``, so a leaf's gradient is taken
    whenever it requires one."""
    if not ctx.needs_input_grad[i]:
        return False
    node = ctx.next_functions[i][0]
    if hasattr(node, "variable"):  # a leaf's AccumulateGrad
        return True
    return torch._C._will_engine_execute_node(node)


def _backward(gy: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
              stride: Tuple[int, int], mask: Tuple[bool, bool]
              ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """(gx, gw) of ``F.conv2d(x, w, stride=stride)`` under ``gy``, each
    where ``mask`` asks for it (None otherwise): cuDNN's dgrad and wgrad."""
    if not any(mask):
        return None, None
    gx, gw, _ = torch.ops.aten.convolution_backward(
        gy, x, w, None, list(stride), [0, 0], [1, 1], False, [0, 0], 1,
        [mask[0], mask[1], False])
    return gx, gw


class _ConvBackward(torch.autograd.Function):
    """gy -> (gx, gw), differentiable in gy, x and w."""

    @staticmethod
    def forward(ctx, gy, x, w, stride, mask):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(gy, x, w)
        ctx.stride = stride
        return _backward(gy, x, w, stride, mask)

    @staticmethod
    def backward(ctx, ggx, ggw):
        global CALLS
        CALLS += 1
        gy, x, w = ctx.saved_tensors
        stride = ctx.stride
        g_gy = g_x = g_w = None
        if _wanted(ctx, 0):
            if ggx is not None:
                g_gy = F.conv2d(ggx, w, stride=stride)
            if ggw is not None:
                term = F.conv2d(x, ggw, stride=stride)
                g_gy = term if g_gy is None else g_gy + term
        if ggw is not None and _wanted(ctx, 1):
            g_x = _backward(gy, x, ggw, stride, (True, False))[0]
        if ggx is not None and _wanted(ctx, 2):
            g_w = _backward(gy, ggx, w, stride, (False, True))[1]
        return g_gy, g_x, g_w, None, None


class _Conv(torch.autograd.Function):
    """``F.conv2d(x, w, stride=stride)`` whose backward is
    ``_ConvBackward``."""

    @staticmethod
    def forward(ctx, x, w, stride):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, w)
        ctx.stride = stride
        return F.conv2d(x, w, stride=stride)

    @staticmethod
    def backward(ctx, gy):
        if gy is None:
            return None, None, None
        x, w = ctx.saved_tensors
        mask = (_wanted(ctx, 0), _wanted(ctx, 1))
        gx, gw = _ConvBackward.apply(gy, x, w, ctx.stride, mask)
        return gx, gw, None


def conv2d(x: torch.Tensor, w: torch.Tensor,
           stride: Tuple[int, int] = (1, 1)) -> torch.Tensor:
    """``F.conv2d(x, w, stride=stride)`` (no padding, bias or groups),
    twice differentiable through cuDNN's dgrad and wgrad (see the module's
    docstring)."""
    return _Conv.apply(x, w, tuple(stride))
