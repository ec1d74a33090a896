"""Optimizers and learning-rate schedules, counterpart of
``de_i2i_gan_tpu/train/optim.py``:

  * sgd | rmsprop | adam (betas 0.5/0.999) | adamw (betas 0.9/0.95), eps 1e-8
  * the StarGAN v2 solver's Adam with coupled weight decay and a constant
    learning rate (``make_solver_optimizer``)
  * per-network learning rates (TTUR)
  * schedules are functions of the optimizer's update count; a network
    updated every ``update_every`` iterations (the generator under
    ``num_critics``) converts its count back to epochs with that factor

The optimizers are ``torch.optim`` classes whose arithmetic matches optax's
update for update. The learning rate is not a torch scheduler: ``Optimizer``
sets it from its own update count before every step, as optax evaluates the
schedule at the count before the update. optax's rmsprop adds eps inside the
square root, which ``torch.optim.RMSprop`` does not, so rmsprop is a small
class of its own here.
"""
from __future__ import annotations

import math
from typing import Callable, Iterable

import torch

from de_i2i_gan_torch.config import TrainConfig
from de_i2i_gan_torch.parallel import distributed
from de_i2i_gan_torch.utils import profiling


def lr_schedule(tcfg: TrainConfig, base_lr: float, iters_per_epoch: int,
                num_epochs: int, update_every: int = 1
                ) -> Callable[[int], float]:
    """update count -> learning rate."""

    def epoch_of(count: int) -> int:
        return min(count * update_every // max(iters_per_epoch, 1), num_epochs)

    if tcfg.scheduler == "step":
        step_cnt = 4
        step_size = max(num_epochs // step_cnt, 1)
        gamma = tcfg.lr_decay ** (1.0 / step_cnt)
        return lambda count: base_lr * gamma ** (epoch_of(count) // step_size)
    if tcfg.scheduler == "exp":
        gamma = tcfg.lr_decay ** (1.0 / max(num_epochs, 1))
        return lambda count: base_lr * gamma ** epoch_of(count)
    if tcfg.scheduler == "cos":
        eta_min = base_lr * tcfg.lr_decay

        def cos(count: int) -> float:
            t = epoch_of(count) / max(num_epochs, 1)
            return eta_min + (base_lr - eta_min) * 0.5 * (1 + math.cos(math.pi * t))
        return cos
    if tcfg.scheduler in (None, "none", "const"):
        return lambda count: base_lr
    raise NameError(f"scheduler named {tcfg.scheduler} not defined")


class _RMSprop(torch.optim.Optimizer):
    """optax.rmsprop(decay, eps): nu = decay*nu + (1-decay)*g^2,
    p -= lr * g / sqrt(nu + eps)."""

    def __init__(self, params, lr: float, decay: float, eps: float):
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                nu = self.state[p].setdefault("nu", torch.zeros_like(p))
                nu.mul_(group["decay"]).addcmul_(p.grad, p.grad,
                                                 value=1 - group["decay"])
                p.addcdiv_(p.grad, (nu + group["eps"]).sqrt_(),
                           value=-group["lr"])


def _torch_optimizer(name: str, params) -> torch.optim.Optimizer:
    # the learning rate is set before every step; 0 is a placeholder
    if name == "sgd":
        return torch.optim.SGD(params, lr=0.0)
    if name == "rmsprop":
        return _RMSprop(params, lr=0.0, decay=0.99, eps=1e-8)
    if name == "adam":
        return torch.optim.Adam(params, lr=0.0, betas=(0.5, 0.999), eps=1e-8)
    if name == "adamw":
        # optax.adamw's default weight decay, applied as lr * wd * p
        return torch.optim.AdamW(params, lr=0.0, betas=(0.9, 0.95), eps=1e-8,
                                 weight_decay=1e-4)
    raise NameError(f"optimizer named {name} not defined")


def _zero_state(opt: torch.optim.Optimizer, p: torch.Tensor) -> dict:
    """The per-parameter state ``opt`` keeps, under the torch optimizer's
    own keys, as its first step would make it."""
    if isinstance(opt, torch.optim.Adam | torch.optim.AdamW):
        return {"step": torch.tensor(0.0), "exp_avg": torch.zeros_like(p),
                "exp_avg_sq": torch.zeros_like(p)}
    if isinstance(opt, _RMSprop):
        return {"nu": torch.zeros_like(p)}
    return {}


class Optimizer:
    """A torch optimizer whose learning rate follows ``schedule`` of its own
    update count. Its moments exist from the start, zeros at count 0, as
    optax's ``init`` makes them, so a checkpoint or a JAX state can fill
    them before the first update. With a process ``group``
    (``parallel/mesh.py::make_parallel_step``) an update applies the mean
    of the ranks' gradients: one flattened all-reduce of the network's
    gradients, the per-network all-reduce GSPMD inserts in the JAX step, in
    the span ``parallel.grad_all_reduce`` (``utils/profiling.py``)."""

    group = None

    def __init__(self, opt: torch.optim.Optimizer,
                 schedule: Callable[[int], float]):
        self.opt = opt
        self.params = [p for group in opt.param_groups for p in group["params"]]
        self.schedule = schedule
        for p in self.params:
            self.opt.state[p].update(_zero_state(opt, p))
        self.count = 0

    def step(self, grads) -> None:
        """One update from ``grads`` (one per parameter, in order), in the
        span ``optim.step``."""
        with profiling.span("optim.step"):
            lr = self.schedule(self.count)
            if self.group is not None:
                with profiling.span("parallel.grad_all_reduce"):
                    grads = [g.clone() for g in grads]
                    distributed.all_reduce_(grads, self.group, average=True)
            for p, g in zip(self.params, grads, strict=True):
                p.grad = g
            for group in self.opt.param_groups:
                group["lr"] = lr
            self.opt.step()
            for p in self.params:
                p.grad = None
            self.count += 1


def make_optimizer(tcfg: TrainConfig, params: Iterable[torch.Tensor],
                   base_lr: float, iters_per_epoch: int, num_epochs: int,
                   update_every: int = 1) -> Optimizer:
    return Optimizer(_torch_optimizer(tcfg.optimizer, list(params)),
                     lr_schedule(tcfg, base_lr, iters_per_epoch, num_epochs,
                                 update_every))


def make_solver_optimizer(params: Iterable[torch.Tensor], lr: float,
                          betas: tuple, weight_decay: float) -> Optimizer:
    """The StarGAN v2 solver's per-net Adam at a constant ``lr``
    (``de_i2i_gan_tpu/train/solver.py:121-134``): optax's
    ``add_decayed_weights`` -> ``scale_by_adam`` -> ``scale(-lr)`` adds the
    L2 term to the gradient before the adaptive scaling, which is
    ``torch.optim.Adam``'s coupled ``weight_decay`` (not ``AdamW``)."""
    return Optimizer(torch.optim.Adam(list(params), lr=lr, betas=betas,
                                      eps=1e-8, weight_decay=weight_decay),
                     lambda count: lr)


@torch.no_grad()
def ema_update(ema_params: Iterable[torch.Tensor],
               new_params: Iterable[torch.Tensor], decay: float) -> None:
    """In place: ema = decay * ema + (1 - decay) * new
    (``optax.incremental_update(new, ema, 1 - decay)``)."""
    ema_params, new_params = list(ema_params), list(new_params)
    torch._foreach_lerp_(ema_params, new_params, 1.0 - decay)
