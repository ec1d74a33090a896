"""MAE patch masks, counterpart of ``de_i2i_gan_tpu/utils/masks.py``.

Reference: defectGAN/utils/util.py:48-71
  * generate_mask: a Bernoulli grid of patches, upsampled nearest to the
    pixel resolution
  * generate_shifted_mask: the same grid sampled one patch larger and
    cropped at a random (h, w) offset, so mask boundaries do not sit on a
    fixed patch lattice

Masks are NHWC (N, H, W, 1) float32, 1 = visible, 0 = masked, as the
images they mask. The draws come from a ``torch.Generator`` on the device
the mask is made on. The Bernoulli grid (``bernoulli_grid``), its upsampling
(``upsample_grid``) and the shifted crop (``shifted_crop``) are separate
functions, so a test can hand the port the grid and shifts that the JAX
package drew.
"""
from __future__ import annotations

from typing import Optional

import torch


def bernoulli_grid(batch: int, hs: int, ws: int, mask_ratio: float,
                   generator: Optional[torch.Generator] = None,
                   device: str | torch.device = "cpu") -> torch.Tensor:
    """(N, hs, ws, 1) float32 patch grid, each patch visible with
    probability 1 - mask_ratio."""
    u = torch.rand((batch, hs, ws, 1), generator=generator, device=device)
    return (u < 1.0 - mask_ratio).float()


def upsample_grid(grid: torch.Tensor, patch_size: int) -> torch.Tensor:
    """Each grid cell repeated into a patch_size x patch_size block."""
    return grid.repeat_interleave(patch_size, 1).repeat_interleave(patch_size, 2)


def shifted_crop(ext: torch.Tensor, h_shift, w_shift, height: int,
                 width: int) -> torch.Tensor:
    """The (height, width) window of ``ext`` at (h_shift, w_shift), ints or
    0-d tensors on ext's device (gathered there, so the host never waits
    for a drawn shift); a start past the end is clamped, as
    ``jax.lax.dynamic_slice`` clamps it."""
    dev = ext.device
    h0 = torch.as_tensor(h_shift, device=dev).clamp(0, ext.shape[1] - height)
    w0 = torch.as_tensor(w_shift, device=dev).clamp(0, ext.shape[2] - width)
    rows = torch.arange(height, device=dev) + h0
    cols = torch.arange(width, device=dev) + w0
    return ext[:, rows][:, :, cols]


def generate_mask(batch: int, height: int, width: int, patch_size: int,
                  mask_ratio: float, generator: Optional[torch.Generator] = None,
                  device: str | torch.device = "cpu") -> torch.Tensor:
    """(N, H, W, 1) float mask; 1 = visible, 0 = masked."""
    grid = bernoulli_grid(batch, height // patch_size, width // patch_size,
                          mask_ratio, generator, device)
    return upsample_grid(grid, patch_size)


def generate_shifted_mask(batch: int, height: int, width: int,
                          patch_size: int, mask_ratio: float,
                          generator: Optional[torch.Generator] = None,
                          device: str | torch.device = "cpu") -> torch.Tensor:
    """A randomly shifted patch mask (util.py:60-71)."""
    ext = generate_mask(batch, height + patch_size, width + patch_size,
                        patch_size, mask_ratio, generator, device)
    shifts = torch.randint(0, patch_size, (2,), generator=generator,
                           device=device)
    return shifted_crop(ext, shifts[0], shifts[1], height, width)
