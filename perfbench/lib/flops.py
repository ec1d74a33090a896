"""What a step costs by its shapes: the FLOPs of the matrix products and
convolutions the reference's step runs (``torch.utils.flop_counter``'s
formulas applied to each aten op, counted on the ``meta`` device), and the
bytes and operations of each modulated instance norm call, which bound the
norm kernels' time. A later change to how the program computes moves none
of these."""
from __future__ import annotations

from typing import Iterable, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

# the norm's arithmetic a element (pass 1: add + fma; pass 2: fma (+ act));
# backward: each pass xhat (sub, mul), gate fma, two sums; dx sub, fma, mul
FWD_FLOPS_PER_ELEMENT = 5
BWD_FLOPS_PER_ELEMENT = 12
STAT_BYTES = 4  # gamma, beta, mean, inv, dgamma, dbeta are float32


class FlopCounter(TorchDispatchMode):
    """Counts FLOPs of every op that ``flop_registry`` has a formula for.
    (``FlopCounterMode`` itself raises inside a double backward.)"""

    def __init__(self):
        super().__init__()
        self.flops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += int(formula(*args, **kwargs, out_val=out))
        return out


def norm_bound_s(calls: Iterable[Tuple[tuple, bool]], element_bytes: int,
                 peak_bytes_per_s: float, peak_flops: float) -> float:
    """Seconds the chip needs at least for the norm calls ``(shape,
    with_backward)``: each by the larger of its bytes over the memory's
    rate and its operations over the float32 rate. Forward: x read, y
    written, gamma and beta in, mean and inv out. Backward: x and dy read,
    dx written, gamma, beta, mean and inv in, dgamma and dbeta out."""
    total = 0.0
    for shape, backward in calls:
        n, c = shape[:2]
        numel = 1
        for d in shape:
            numel *= d
        passes = [(2 * numel * element_bytes + 4 * n * c * STAT_BYTES,
                   FWD_FLOPS_PER_ELEMENT * numel)]
        if backward:
            passes.append((3 * numel * element_bytes + 6 * n * c * STAT_BYTES,
                           BWD_FLOPS_PER_ELEMENT * numel))
        for nbytes, ops in passes:
            total += max(nbytes / peak_bytes_per_s, ops / peak_flops)
    return total


def element_bytes(dtype_name: str) -> int:
    return torch.empty((), dtype=getattr(torch, dtype_name)).element_size()
