"""Fused-op dispatch: the hand-written CUDA kernel for CUDA tensors, the
plain PyTorch version for CPU tensors.

Counterpart of ``de_i2i_gan_tpu/ops/fused.py``. The plain version is the
oracle the kernel is held against (tests on the CPU, ``chip_smoke.py`` on
the card) and what a CPU tensor runs.

Dispatch of ``modulated_instance_norm``:

    x device   use_kernel   runs
    CUDA       True         the kernel (it launches or raises)
    CPU        any          the plain version
    CUDA       False        the plain version (cfg.use_pallas=False)
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from de_i2i_gan_torch.ops.cuda.norm_kernels import cuda_modulated_instance_norm


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


def modulated_instance_norm(x: torch.Tensor, gamma: torch.Tensor,
                            beta: torch.Tensor, act: Optional[str] = None,
                            eps: float = 1e-5,
                            use_kernel: bool = True) -> torch.Tensor:
    """instance_norm(x) * (1 + gamma) + beta (+ act); x NCHW, gamma/beta (N, C)."""
    if use_kernel and x.is_cuda:
        return cuda_modulated_instance_norm(x, gamma, beta, act, eps)
    return modulated_instance_norm_ref(x, gamma, beta, act, eps)[0]


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
