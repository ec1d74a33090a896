"""Recomputation of a module's forward in the backward pass (``remat``), the
counterpart of ``jax.checkpoint`` over the JAX package's G forwards
(``train/steps.py`` and ``train/pix2pix_steps.py``).

``torch.utils.checkpoint`` keeps no activations of the forward and runs the
module again when the backward pass needs them. ``jax.checkpoint``
recomputes a pure function; a module's forward here has side effects:
BatchNorm's running statistics and spectral norm's u/v move in place, SEAN
adds to its running statistics, a collector list (SEAN's ``distill``) gains
entries and noise injection draws from an explicit ``torch.Generator``,
whose state ``preserve_rng_state`` does not cover; and the caller may have
switched the module's mode by the time the backward pass runs. So the rerun
starts from the modes and buffers as the first forward found them and from
the generator's state before its draws, and computes the same tensors; a
collector gets a list of its own; afterwards the modes, buffers and the
generator are put back as they were before the rerun, so the state moves
once, as without remat.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint


def remat(module: nn.Module, *args, generator: Optional[torch.Generator] = None,
          **kw):
    """``module(*args, generator=generator, **kw)``, its activations
    recomputed in the backward pass instead of kept."""
    modules = list(module.modules())
    modes = [m.training for m in modules]
    buffers = list(module.buffers())
    before = [b.detach().clone() for b in buffers]
    gen_before = None if generator is None else generator.get_state()
    calls = []

    def run(*a):
        calls.append(None)
        if len(calls) == 1:
            return module(*a, generator=generator, **kw)
        # the rerun: the first forward's starting state, then back
        modes_now = [m.training for m in modules]
        now = [b.detach().clone() for b in buffers]
        gen_now = None if generator is None else generator.get_state()
        for m, mode in zip(modules, modes):
            m.training = mode
        with torch.no_grad():
            for b, v in zip(buffers, before):
                b.copy_(v)
        if generator is not None:
            generator.set_state(gen_before)
        try:
            return module(*a, generator=generator,
                          **{k: [] if isinstance(v, list) else v
                             for k, v in kw.items()})
        finally:
            # also when the checkpoint stops the rerun early
            for m, mode in zip(modules, modes_now):
                m.training = mode
            with torch.no_grad():
                for b, v in zip(buffers, now):
                    b.copy_(v)
            if generator is not None:
                generator.set_state(gen_now)

    return checkpoint(run, *args, use_reentrant=False, preserve_rng_state=True)
