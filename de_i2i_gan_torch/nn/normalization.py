"""Conditional normalization, counterpart of ``de_i2i_gan_tpu/nn/normalization.py``.

This slice holds the param-free ``instance_norm`` and ``AdaIN``. SPADE and
SEAN come in later slices.
"""
from __future__ import annotations

import torch
from torch import nn

from de_i2i_gan_torch.nn.layers import Dense
from de_i2i_gan_torch.ops.fused import modulated_instance_norm


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Param-free instance norm over H, W of NCHW x (nn.InstanceNorm2d(affine=False)).

    Two passes with float32 accumulation, as the JAX package: the centered
    tensor stays in x's dtype, only the statistics accumulate in float32.
    """
    mean = x.mean(dim=(2, 3), keepdim=True, dtype=torch.float32)
    xc = x - mean.to(x.dtype)
    var = xc.float().square().mean(dim=(2, 3), keepdim=True)
    return xc * torch.rsqrt(var + eps).to(x.dtype)


class AdaIN(nn.Module):
    """Adaptive instance norm driven by a style vector: two dense heads give
    per-(n, c) gamma and beta for the fused modulated instance norm."""

    def __init__(self, norm_nc: int, hidden_nc: int = 128,
                 dtype: torch.dtype = torch.float32, use_pallas: bool = True):
        super().__init__()
        self.hidden_nc = hidden_nc
        self.use_pallas = use_pallas
        self.mlp_gamma = Dense(hidden_nc, norm_nc, dtype=dtype)
        self.mlp_beta = Dense(hidden_nc, norm_nc, dtype=dtype)

    def forward(self, x: torch.Tensor, style_feat: torch.Tensor) -> torch.Tensor:
        n = x.shape[0]
        if style_feat is None or tuple(style_feat.shape) != (n, self.hidden_nc):
            got = None if style_feat is None else tuple(style_feat.shape)
            raise ValueError(
                f"style feature must be ({n}, {self.hidden_nc}), got {got}")
        gamma = self.mlp_gamma(style_feat)
        beta = self.mlp_beta(style_feat)
        return modulated_instance_norm(x, gamma, beta,
                                       use_kernel=self.use_pallas)
