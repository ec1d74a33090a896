"""Helpers that reach into the program's modules and optimizers."""
from __future__ import annotations

from typing import Dict

import torch


@torch.no_grad()
def load(module: torch.nn.Module, tensors: Dict[str, torch.Tensor]) -> None:
    """Copy ``tensors`` into ``module``'s parameters by name; every
    parameter must be given, and nothing else."""
    params = dict(module.named_parameters())
    if set(params) != set(tensors):
        missing = sorted(set(params) - set(tensors))
        extra = sorted(set(tensors) - set(params))
        raise KeyError(f"parameter names differ: the program's {missing[:5]} "
                       f"are not drawn, drawn {extra[:5]} are not the program's")
    for name, p in params.items():
        p.copy_(tensors[name])


def leaves(prefix: str, module: torch.nn.Module) -> Dict[str, torch.Tensor]:
    return {f"{prefix}.{n}": p for n, p in module.named_parameters()}


def watch_first(prefix: str, module: torch.nn.Module, optimizer,
                sink: Dict[str, float]) -> None:
    """After the first update of the program's ``optimizer``
    (``train/optim.py::Optimizer``), put the norm of Adam's first moment of
    each of ``module``'s parameters into ``sink``: the first gradient as
    the optimizer got it, times (1 - beta1). Later updates run the
    optimizer's own ``step``."""
    from perfbench.lib.compare import norms

    def first(grads):
        type(optimizer).step(optimizer, grads)
        del optimizer.step
        state = optimizer.opt.state
        sink.update(norms({f"{prefix}.{n}": state[p]["exp_avg"]
                           for n, p in module.named_parameters()}))

    optimizer.step = first
