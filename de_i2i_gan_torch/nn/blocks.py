"""Composite conv blocks of the DefectGAN family, counterpart of
``de_i2i_gan_tpu/nn/blocks.py`` in NCHW.

Unlike flax, torch modules know their input width at construction, so every
block takes ``in_features`` first. Attribute names follow the flax module
names (``conv``, ``norm``, ``conv_0`` ...), so weights map mechanically.

Eval mode only in this slice: BatchNorm normalizes with its running
statistics and raises in training mode; ``bn_groups`` and ``NoiseInjection``
come with the training slice.
"""
from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from de_i2i_gan_torch.nn.layers import Conv2d, avg_pool, upsample_nearest
from de_i2i_gan_torch.nn.normalization import AdaIN, instance_norm

Padding = Union[int, str]


def get_act(act: Optional[str]):
    """Activation dispatch."""
    if act is None:
        return lambda x: x
    if act == "leaky_relu":
        return lambda x: F.leaky_relu(x, negative_slope=0.2)
    if act == "relu":
        return F.relu
    if act == "sigmoid":
        return torch.sigmoid
    if act == "tanh":
        return torch.tanh
    raise NameError(f"activation layer named {act} not defined")


class BatchNorm(nn.Module):
    """Eval-mode BatchNorm2d from running statistics (eps 1e-5), in float32
    and rounded once to x's dtype, as flax's BatchNorm computes it."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise NotImplementedError(
                "train-mode BatchNorm (batch statistics, bn_groups) comes "
                "with the training slice; call .eval()")
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, False, 0.0, self.eps)


def _norm_layer(norm: Optional[str], features: int):
    """Base norm dispatch: 'batch' | 'instance' | None."""
    if norm is None:
        return None
    if norm == "batch":
        return BatchNorm(features)
    if norm == "instance":
        return instance_norm
    raise NameError(f"norm layer named {norm} not defined")


class ConvBlock(nn.Module):
    """conv -> (norm) -> act."""

    def __init__(self, in_features: int, features: int,
                 kernel_size=(3, 3), strides=(1, 1), padding: Padding = 0,
                 padding_mode: str = "zeros", use_bias: bool = False,
                 norm: Optional[str] = None, act: Optional[str] = None,
                 use_spectral: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv2d(in_features, features, kernel_size, strides,
                           padding, padding_mode, use_bias=use_bias,
                           use_spectral=use_spectral, dtype=dtype)
        self.norm = _norm_layer(norm, features)
        self.act = get_act(act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv(x)
        if self.norm is not None:
            y = self.norm(y)
        return self.act(y)


class DeConvBlock(nn.Module):
    """(2x upsample) -> conv -> (norm) -> act."""

    def __init__(self, in_features: int, features: int,
                 kernel_size=(3, 3), strides=(1, 1), padding: Padding = 0,
                 padding_mode: str = "zeros", use_bias: bool = False,
                 up_scale: bool = True, norm: Optional[str] = None,
                 act: Optional[str] = None, use_spectral: bool = False,
                 add_noise: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if add_noise:
            raise NotImplementedError(
                "NoiseInjection comes with the training slice")
        self.up_scale = up_scale
        self.conv = Conv2d(in_features, features, kernel_size, strides,
                           padding, padding_mode, use_bias=use_bias,
                           use_spectral=use_spectral, dtype=dtype)
        self.norm = _norm_layer(norm, features)
        self.act = get_act(act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.up_scale:
            x = upsample_nearest(x)
        y = self.conv(x)
        if self.norm is not None:
            y = self.norm(y)
        return self.act(y)


class ResBlock(nn.Module):
    """Two conv blocks + identity (or 1x1-conv + avg-pool when down-scaling)
    shortcut."""

    def __init__(self, in_features: int, features: int,
                 kernel_size=(3, 3), padding: Padding = "same",
                 padding_mode: str = "zeros", norm: Optional[str] = "instance",
                 act: Optional[str] = "relu", use_spectral: bool = False,
                 down_scale: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.down_scale = down_scale
        kw = dict(padding_mode=padding_mode, norm=norm,
                  use_spectral=use_spectral, dtype=dtype)
        self.conv_0 = ConvBlock(in_features, in_features, kernel_size, (1, 1),
                                padding, act=act, **kw)
        self.conv_1 = ConvBlock(in_features, features, kernel_size, (1, 1),
                                padding, act=None, **kw)
        self.conv_s = (ConvBlock(in_features, features, (1, 1), (1, 1), 0,
                                 act=None, **kw) if down_scale else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv_0(x)
        if self.down_scale:
            y = avg_pool(y, 2, 2)
        y = self.conv_1(y)
        s = avg_pool(self.conv_s(x), 2, 2) if self.down_scale else x
        return y + s


class _StyleNorm(nn.Module):
    """Style-norm dispatch used by NormConvBlock/NormResBlock:
    'adain' here; 'spade' and 'sean' come in later slices."""

    def __init__(self, style_type: str, norm_nc: int, label_nc: int,
                 hidden_nc: int, dtype: torch.dtype = torch.float32,
                 use_pallas: bool = True):
        super().__init__()
        if style_type in ("spade", "sean"):
            raise NotImplementedError(
                f"{style_type} style norm is not ported yet; only adain is")
        if style_type != "adain":
            raise ValueError(f"Unknown style norm block type: {style_type}")
        self.adain = AdaIN(norm_nc, hidden_nc, dtype=dtype,
                           use_pallas=use_pallas)

    def forward(self, x, labels, style_feat=None):
        return self.adain(x, style_feat)


class NormConvBlock(nn.Module):
    """(2x upsample) -> style-norm -> act -> conv."""

    def __init__(self, style_type: str, in_features: int, features: int,
                 label_nc: int, hidden_nc: int, kernel_size=(3, 3),
                 padding: Padding = "same", padding_mode: str = "zeros",
                 up_scale: bool = False, act: Optional[str] = "relu",
                 use_spectral: bool = False, add_noise: bool = False,
                 dtype: torch.dtype = torch.float32, use_pallas: bool = True):
        super().__init__()
        if add_noise:
            raise NotImplementedError(
                "NoiseInjection comes with the training slice")
        self.up_scale = up_scale
        self.norm = _StyleNorm(style_type, in_features, label_nc, hidden_nc,
                               dtype=dtype, use_pallas=use_pallas)
        self.act = get_act(act)
        self.conv = Conv2d(in_features, features, kernel_size, (1, 1), padding,
                           padding_mode, use_spectral=use_spectral, dtype=dtype)

    def forward(self, x, labels, style_feat=None):
        if self.up_scale:
            x = upsample_nearest(x)
        y = self.act(self.norm(x, labels, style_feat))
        return self.conv(y)


class NormResBlock(nn.Module):
    """Residual block of two style-norm conv branches; style-norm + conv
    shortcut only when up-scaling."""

    def __init__(self, style_type: str, in_features: int, features: int,
                 label_nc: int, hidden_nc: int, kernel_size=(3, 3),
                 padding: Padding = "same", padding_mode: str = "zeros",
                 up_scale: bool = False, act: Optional[str] = "relu",
                 use_spectral: bool = False, add_noise: bool = False,
                 dtype: torch.dtype = torch.float32, use_pallas: bool = True):
        super().__init__()
        if add_noise:
            raise NotImplementedError(
                "NoiseInjection comes with the training slice")
        self.up_scale = up_scale
        f_mid = min(in_features, features)
        norm_kw = dict(label_nc=label_nc, hidden_nc=hidden_nc, dtype=dtype,
                       use_pallas=use_pallas)
        conv_kw = dict(padding=padding, padding_mode=padding_mode,
                       use_spectral=use_spectral, dtype=dtype)
        if up_scale:
            self.norm_s = _StyleNorm(style_type, in_features, **norm_kw)
            self.conv_s = Conv2d(in_features, features, kernel_size, (1, 1),
                                 **conv_kw)
        self.act = get_act(act)
        self.norm_0 = _StyleNorm(style_type, in_features, **norm_kw)
        self.conv_0 = Conv2d(in_features, f_mid, kernel_size, (1, 1), **conv_kw)
        self.norm_1 = _StyleNorm(style_type, f_mid, **norm_kw)
        self.conv_1 = Conv2d(f_mid, features, kernel_size, (1, 1), **conv_kw)

    def forward(self, x, labels, style_feat=None):
        if self.up_scale:
            x = upsample_nearest(x)
            s = self.conv_s(self.norm_s(x, labels, style_feat))
        else:
            s = x
        y = self.conv_0(self.act(self.norm_0(x, labels, style_feat)))
        y = self.conv_1(self.act(self.norm_1(y, labels, style_feat)))
        return y + s
