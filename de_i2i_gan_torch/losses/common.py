"""Primitive loss functions, counterpart of ``de_i2i_gan_tpu/losses/common.py``:
bce/cce on raw logits, l1, l2, the ``cal_loss`` dispatch and StarGAN v2's
``r1_penalty``. All reductions are means in float32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def bce_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Sigmoid binary cross-entropy on logits, mean-reduced, in the
    numerically stable form max(x, 0) - x*t + log(1 + exp(-|x|))."""
    logits = logits.float()
    targets = targets.float()
    loss = torch.clamp_min(logits, 0) - logits * targets + \
        torch.log1p(torch.exp(-logits.abs()))
    return loss.mean()


def cce_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Softmax cross-entropy on logits; targets are class probabilities or
    integer class ids."""
    logits = logits.float()
    logp = F.log_softmax(logits, dim=-1)
    if targets.dim() == logits.dim() - 1:
        targets = F.one_hot(targets.long(), logits.shape[-1])
    return -(targets.float() * logp).sum(dim=-1).mean()


def l1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a.float() - b.float()).abs().mean()


def l2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a.float() - b.float()).square().mean()


_LOSSES = {"bce": bce_logits, "bce_logits": bce_logits,
           "cce": cce_logits, "cce_logits": cce_logits,
           "l1": l1, "l2": l2, "mse": l2}


def cal_loss(logits: torch.Tensor, targets: torch.Tensor,
             loss_type: str) -> torch.Tensor:
    try:
        fn = _LOSSES[loss_type]
    except KeyError:
        raise ValueError(f"loss_type: {loss_type} is invalid") from None
    return fn(logits, targets)


def r1_penalty(out: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Zero-centered gradient penalty on real images (solver.py:573-583):
    0.5 * E[ ||d sum(D(x)) / d x||^2 ], the square taken in float32.

    ``out`` is D's output on ``x``, which requires grad. The gradient keeps
    its graph (``create_graph``), so the penalty is differentiable in D's
    parameters: one D forward serves both the logits and the penalty."""
    (grad,) = torch.autograd.grad(out.sum(), x, create_graph=True)
    return 0.5 * grad.float().square().sum() / x.shape[0]
