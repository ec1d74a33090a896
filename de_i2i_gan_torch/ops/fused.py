"""Fused-op dispatch: the hand-written CUDA kernel for CUDA tensors, the
plain PyTorch version for CPU tensors.

Counterpart of ``de_i2i_gan_tpu/ops/fused.py``. The plain version is the
oracle the kernel is held against (tests on the CPU, ``chip_smoke.py`` on
the card) and what a CPU tensor runs; its gradient is autograd's. The
backward kernel is held against ``modulated_instance_norm_bwd_ref``, which
nothing on the training path calls.

Dispatch of ``modulated_instance_norm``:

    x device   use_kernel   runs
    CUDA       True         the forward kernel, and the backward kernel in
                            the backward pass (each launches or raises)
    CPU        any          the plain version
    CUDA       False        the plain version (cfg.use_pallas=False)

``sharded_modulated_instance_norm`` is the same function on a band of rows
of each image (height-sharded inference, ``parallel/spatial.py``): the
moments of the band (the moments kernel, or its plain version), their
all-reduce over the band's group, and the apply (the apply kernel, or its
plain version) with the whole row's mean and inv, dispatched as above.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from de_i2i_gan_torch.ops.cuda.norm_kernels import (
    cuda_modulated_instance_norm, split_apply, split_moments)


def _apply_act(y: torch.Tensor, act: Optional[str]) -> torch.Tensor:
    if act is None:
        return y
    if act == "relu":
        return torch.clamp_min(y, 0.0)
    if act == "leaky_relu":
        return torch.where(y >= 0, y, 0.2 * y)
    raise ValueError(f"unsupported fused activation {act}")


def modulated_instance_norm_ref(x: torch.Tensor, gamma: torch.Tensor,
                                beta: torch.Tensor, act: Optional[str] = None,
                                eps: float = 1e-5
                                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version: (y, mean, inv) for NCHW x and (N, C) gamma/beta.

    Two-pass float32 statistics, as ``_xla_modulated_instance_norm``; y in
    x's dtype, mean and inv (the kernel's residuals) float32 (N, C).
    """
    xf = x.float()
    mean = xf.mean(dim=(2, 3), keepdim=True)
    xc = xf - mean
    inv = torch.rsqrt(xc.square().mean(dim=(2, 3), keepdim=True) + eps)
    y = xc * inv * (1.0 + gamma.float()[:, :, None, None]) + \
        beta.float()[:, :, None, None]
    y = _apply_act(y, act)
    return y.to(x.dtype), mean[:, :, 0, 0], inv[:, :, 0, 0]


def modulated_instance_norm_bwd_ref(x: torch.Tensor, gamma: torch.Tensor,
                                    beta: torch.Tensor, mean: torch.Tensor,
                                    inv: torch.Tensor, dy: torch.Tensor,
                                    act: Optional[str] = None
                                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain backward: (dx, dgamma, dbeta) for NCHW x and dy, (N, C)
    gamma/beta and the forward's (N, C) mean and inv.

    The formulas of ``_xla_bwd`` (the JAX package's
    ``ops/pallas/norm_kernels.py``): f32 math, dy gated at the recomputed
    pre-activation, dx in x's dtype, dgamma and dbeta float32 (N, C).
    """
    n, c = x.shape[:2]
    xf = x.float()
    dyf = dy.float()
    mean_ = mean.float().reshape(n, c, 1, 1)
    inv_ = inv.float().reshape(n, c, 1, 1)
    g = gamma.float().reshape(n, c, 1, 1)
    xhat = (xf - mean_) * inv_
    if act is not None:
        y = xhat * (1.0 + g) + beta.float().reshape(n, c, 1, 1)
        if act == "relu":
            dyf = torch.where(y > 0, dyf, 0.0)
        elif act == "leaky_relu":
            dyf = torch.where(y >= 0, dyf, 0.2 * dyf)
        else:
            raise ValueError(f"unsupported fused activation {act}")
    dg = (dyf * xhat).sum(dim=(2, 3))
    db = dyf.sum(dim=(2, 3))
    m_dy = dyf.mean(dim=(2, 3), keepdim=True)
    m_dyx = (dyf * xhat).mean(dim=(2, 3), keepdim=True)
    dx = ((1.0 + g) * inv_ * (dyf - m_dy - xhat * m_dyx)).to(x.dtype)
    return dx, dg, db


def modulated_instance_norm(x: torch.Tensor, gamma: torch.Tensor,
                            beta: torch.Tensor, act: Optional[str] = None,
                            eps: float = 1e-5,
                            use_kernel: bool = True) -> torch.Tensor:
    """instance_norm(x) * (1 + gamma) + beta (+ act); x NCHW, gamma/beta (N, C)."""
    if use_kernel and x.is_cuda:
        return cuda_modulated_instance_norm(x, gamma, beta, act, eps)
    return modulated_instance_norm_ref(x, gamma, beta, act, eps)[0]


def modulated_instance_norm_moments_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain moments: the float32 (2, N, C) sums of x and of x**2 over each
    (n, c) row of NCHW x."""
    xf = x.float()
    return torch.stack([xf.sum(dim=(2, 3)), xf.square().sum(dim=(2, 3))])


def moments_to_stats(sums: torch.Tensor, count: int, eps: float = 1e-5
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean, inv) of rows of ``count`` elements from their (2, N, C) sums,
    as the fused kernel computes them: var = max(E[x^2] - mean^2, 0), inv =
    rsqrt(var + eps), in float32. The count divides as a tensor: a Python
    number would divide on the card as a multiplication by its reciprocal,
    an ulp off the kernel's division."""
    n = sums.new_tensor(float(count))
    mean = sums[0] / n
    var = torch.clamp_min(sums[1] / n - mean * mean, 0.0)
    return mean, torch.rsqrt(var + eps)


def modulated_instance_norm_apply_ref(x: torch.Tensor, mean: torch.Tensor,
                                      inv: torch.Tensor, gamma: torch.Tensor,
                                      beta: torch.Tensor,
                                      act: Optional[str] = None) -> torch.Tensor:
    """Plain apply: ``act(x * scale + shift)`` with scale = inv * (1 +
    gamma) and shift = beta - mean * scale, per (n, c), in float32; y in
    x's dtype."""
    scale = inv.float() * (1.0 + gamma.float())
    shift = beta.float() - mean.float() * scale
    y = x.float() * scale[:, :, None, None] + shift[:, :, None, None]
    return _apply_act(y, act).to(x.dtype)


def sharded_modulated_instance_norm(x: torch.Tensor, gamma: torch.Tensor,
                                    beta: torch.Tensor,
                                    act: Optional[str] = None,
                                    eps: float = 1e-5, shard=None,
                                    use_kernel: bool = True) -> torch.Tensor:
    """``modulated_instance_norm`` of images whose rows are split over the
    ranks of ``shard`` (a ``parallel.spatial.HeightShard``; None: x holds
    whole images): x is this rank's band. One all-reduce of the band's
    (2, N, C) sums gives every rank the whole row's mean and inv. Forward
    only: a tensor that requires grad raises on the kernel path."""
    kernel = use_kernel and x.is_cuda
    sums = split_moments(x) if kernel else modulated_instance_norm_moments_ref(x)
    count = x.shape[2] * x.shape[3]
    if shard is not None:
        shard.all_reduce(sums)
        count *= shard.size
    mean, inv = moments_to_stats(sums, count, eps)
    if kernel:
        return split_apply(x, mean, inv, gamma, beta, act)
    return modulated_instance_norm_apply_ref(x, mean, inv, gamma, beta, act)


# loaders may ship images as u8 [0,255]; the first thing a step does is
# normalize them on the device. Float images pass through untouched.
IMAGE_KEYS = ("bg", "df", "imgs", "input", "target", "x_src", "x_ref")


def images_to_float(x: torch.Tensor) -> torch.Tensor:
    """u8 [0,255] -> f32 [-1,1]; floats pass through."""
    if x.dtype == torch.uint8:
        return x.to(torch.float32) / 127.5 - 1.0
    return x


def batch_images_to_float(batch):
    """Apply images_to_float to the image entries of a step batch dict.

    A 6-channel NHWC ``pair`` entry (input+target stacked channel-wise) is
    split into ``input``/``target``.
    """
    out = {k: (images_to_float(v) if k in IMAGE_KEYS else v)
           for k, v in batch.items() if k != "pair"}
    if "pair" in batch:
        pair = images_to_float(batch["pair"])
        out["input"] = pair[..., :3]
        out["target"] = pair[..., 3:]
    return out
