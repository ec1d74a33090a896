"""Differentiable augmentation (DiffAugment, Zhao et al., arXiv 2006.10738)
of the discriminator's inputs, counterpart of ``de_i2i_gan_tpu/utils/diffaug.py``.

NHWC images, as the JAX package. A policy is a comma-separated list of
``color`` (brightness, saturation, contrast), ``translation`` and
``cutout``. The random draws are made apart from the arithmetic
(``draw_diff_augment``, then ``apply_diff_augment``), so the arithmetic can
be fed any draws, the JAX package's included. Gradients flow to the pixels
through every policy.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F

_POLICIES = {
    "color": ("brightness", "saturation", "contrast"),
    "translation": ("translation",),
    "cutout": ("cutout",),
}
TRANSLATION_RATIO = 0.125
CUTOUT_RATIO = 0.5


def _ops(policy: str) -> List[str]:
    if not policy:
        return []
    return [op for p in policy.split(",") for op in _POLICIES[p]]


def _half_extent(size: int, ratio: float) -> int:
    return int(size * ratio + 0.5)


def draw_diff_augment(shape: Sequence[int], policy: str,
                      generator: Optional[torch.Generator] = None,
                      device=None, dtype: torch.dtype = torch.float32):
    """The random draws of ``policy`` for NHWC images of ``shape``, one
    entry per operation: a uniform (N, 1, 1, 1) tensor in ``dtype`` for the
    colour operations; (rows, cols) integer (N, 1, 1) shifts for
    translation, each within +-ratio*size inclusive; (rows, cols) integer
    (N, 1, 1) centres for cutout."""
    n, h, w, _ = shape
    draws = []
    for op in _ops(policy):
        kw = dict(generator=generator, device=device)
        if op in ("brightness", "saturation", "contrast"):
            draws.append(torch.rand((n, 1, 1, 1), dtype=dtype, **kw))
        elif op == "translation":
            sh = _half_extent(h, TRANSLATION_RATIO)
            sw = _half_extent(w, TRANSLATION_RATIO)
            draws.append((torch.randint(-sh, sh + 1, (n, 1, 1), **kw),
                          torch.randint(-sw, sw + 1, (n, 1, 1), **kw)))
        else:  # cutout
            ch = _half_extent(h, CUTOUT_RATIO)
            cw = _half_extent(w, CUTOUT_RATIO)
            draws.append((torch.randint(0, h + (1 - ch % 2), (n, 1, 1), **kw),
                          torch.randint(0, w + (1 - cw % 2), (n, 1, 1), **kw)))
    return draws


def _translate(x: torch.Tensor, tx: torch.Tensor, ty: torch.Tensor):
    # zero-pad by 1 and gather the shifted indices, clamped onto the pad
    n, h, w, _ = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    gx = (torch.arange(h, device=x.device)[None, :, None] + tx + 1).clamp(0, h + 1)
    gy = (torch.arange(w, device=x.device)[None, None, :] + ty + 1).clamp(0, w + 1)
    return xp[torch.arange(n, device=x.device)[:, None, None], gx, gy]


def _cutout(x: torch.Tensor, ox: torch.Tensor, oy: torch.Tensor):
    _, h, w, _ = x.shape
    ch = _half_extent(h, CUTOUT_RATIO)
    cw = _half_extent(w, CUTOUT_RATIO)
    rows = torch.arange(h, device=x.device)[None, :, None]
    cols = torch.arange(w, device=x.device)[None, None, :]
    in_h = (rows >= ox - ch // 2) & (rows < ox - ch // 2 + ch)
    in_w = (cols >= oy - cw // 2) & (cols < oy - cw // 2 + cw)
    mask = 1.0 - (in_h & in_w).to(x.dtype)
    return x * mask[..., None]


def apply_diff_augment(x: torch.Tensor, policy: str, draws) -> torch.Tensor:
    """``policy`` on NHWC ``x`` with the draws of ``draw_diff_augment``."""
    ops = _ops(policy)
    if len(draws) != len(ops):
        raise ValueError(f"policy {policy!r} takes {len(ops)} draws, got "
                         f"{len(draws)}")
    for op, r in zip(ops, draws):
        if op == "brightness":
            x = x + (r - 0.5)
        elif op == "saturation":
            mean = x.mean(dim=3, keepdim=True)
            x = (x - mean) * (r * 2.0) + mean
        elif op == "contrast":
            mean = x.mean(dim=(1, 2, 3), keepdim=True)
            x = (x - mean) * (r + 0.5) + mean
        elif op == "translation":
            x = _translate(x, *r)
        else:
            x = _cutout(x, *r)
    return x


def diff_augment(x: torch.Tensor, policy: str = "",
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Apply the comma-separated DiffAugment ``policy`` to NHWC images, with
    draws from ``generator`` (None: torch's default generator of x's
    device)."""
    if not policy:
        return x
    draws = draw_diff_augment(x.shape, policy, generator, x.device, x.dtype)
    return apply_diff_augment(x, policy, draws)
