"""Composite conv blocks of the DefectGAN family, counterpart of
``de_i2i_gan_tpu/nn/blocks.py`` in NCHW.

Unlike flax, torch modules know their input width at construction, so every
block takes ``in_features`` first. Attribute names follow the flax module
names (``conv``, ``norm``, ``conv_0`` ...), so weights map mechanically.

Train mode is torch's module mode (``.train()`` / ``.eval()``), where the
JAX package passes ``train=``. In train mode BatchNorm normalizes each of
``bn_groups`` contiguous batch groups with its own batch statistics
(``bn_groups`` is a forward argument of the blocks that hold BatchNorm).
``NoiseInjection`` draws its noise from the ``torch.Generator`` handed down
as ``generator`` (None: torch's default generator of the device), where the
JAX package draws from its 'noise' stream; a served graph hands down a
``serving.SeededNoise`` instead (``nn/layers.py::randn``). With a height
shard attached (``parallel/spatial.py``) it draws the noise of the whole
global batch at full height and keeps its band's rows, so that every rank's
stream stays one process's.
"""
from __future__ import annotations

from typing import Optional, Union

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from de_i2i_gan_torch.nn.layers import (
    Conv2d, Dense, avg_pool, randn, upsample_nearest)
from de_i2i_gan_torch.nn.normalization import (
    SEAN,
    SPADE,
    AdaIN,
    DistillTerms,
    instance_norm,
)

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


class NoiseInjection(nn.Module):
    """StyleGAN-style noise injection: ``x + weight * noise``, with a
    learned scalar ``weight`` (zero at init) and fresh standard-normal
    (N, 1, H, W) noise in x's dtype at every call, train or eval."""

    shard = None  # a parallel.spatial.HeightShard: x is a band of rows

    def __init__(self):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(1))

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        n, _, h, w = x.shape
        shard = self.shard
        if shard is None:
            noise = randn((n, 1, h, w), generator, x.dtype, x.device)
        else:
            noise = shard.take(randn((n * shard.data_size, 1, h * shard.size,
                                      w), generator, x.dtype, x.device), n, h)
        return x + self.weight.to(x.dtype) * noise


class _GlobalBatchNorm(torch.autograd.Function):
    """Train-mode BatchNorm of ``x`` (f32, (groups, n, C, H, W)) with the
    moments of the global batch over the ranks of ``group``, as
    SyncBatchNorm computes them. The forward all-reduces each group's sums
    and sums of squares of ``x - shift`` and its count (the shift, equal on
    every rank, keeps E[d^2] - E[d]^2 from cancelling); the backward
    all-reduces the sums of dy and of dy * xhat, so each rank's dx carries
    every rank's loss through the moments. The weight's and bias's
    gradients are this rank's, for the optimizer to average. Returns (y,
    mean, var), the moments biased and detached."""

    @staticmethod
    def forward(ctx, x, weight, bias, shift, eps, group):
        c = x.shape[2]
        d = x - shift[None, None, :, None, None]
        count = x.new_full((x.shape[0], 1), float(x[0, :, 0].numel()))
        sums = torch.cat([d.sum(dim=(1, 3, 4)), d.square().sum(dim=(1, 3, 4)),
                          count], dim=1)
        dist.all_reduce(sums, group=group)
        total = sums[:, 2 * c:]
        dmean = sums[:, :c] / total
        var = (sums[:, c:2 * c] / total - dmean.square()).clamp_min(0.0)
        invstd = torch.rsqrt(var + eps)
        xhat = (d - dmean[:, None, :, None, None]) * invstd[:, None, :, None, None]
        ctx.save_for_backward(xhat, invstd, weight)
        ctx.total, ctx.group = total, group
        y = xhat * weight[None, None, :, None, None] + bias[None, None, :, None, None]
        return y, shift + dmean, var

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy, _dmean, _dvar):
        xhat, invstd, weight = ctx.saved_tensors
        c = xhat.shape[2]
        sum_dy = dy.sum(dim=(1, 3, 4))
        sum_dy_xhat = (dy * xhat).sum(dim=(1, 3, 4))
        sums = torch.cat([sum_dy, sum_dy_xhat], dim=1)
        dist.all_reduce(sums, group=ctx.group)
        mean_dy = sums[:, :c] / ctx.total
        mean_dy_xhat = sums[:, c:] / ctx.total
        dx = (dy - mean_dy[:, None, :, None, None]
              - xhat * mean_dy_xhat[:, None, :, None, None]) * (
            invstd * weight)[:, None, :, None, None]
        return (dx, sum_dy_xhat.sum(dim=0), sum_dy.sum(dim=0), None, None,
                None)


class BatchNorm(nn.Module):
    """BatchNorm2d (eps 1e-5) as flax's ``nn.BatchNorm(momentum=0.9)``
    computes it, in float32 and rounded once to x's dtype.

    Eval mode normalizes with the running statistics. Train mode
    (``nn/blocks.py::_apply_norm`` of the JAX package) normalizes each of
    ``bn_groups`` contiguous batch groups with its own biased batch
    statistics, and updates the running averages group after group:
    ``running = 0.9 * running + 0.1 * batch`` with the biased batch
    variance, as flax does. (``F.batch_norm`` would update the running
    variance with the unbiased one, so the update is done here.)

    With a process ``group`` (``parallel/mesh.py::make_parallel_step``) the
    statistics are the global batch's, as GSPMD computes them: each rank
    holds its share of every batch group, and ``_GlobalBatchNorm`` sums the
    f32 sums, sums of squares and counts of its groups over the ranks in
    one all-reduce, and in the backward pass the sums of the gradient in
    another. The variance is flax's E[x^2] - E[x]^2, taken about the
    running mean; the running statistics move from the global moments,
    equal on every rank. With the parameter gradients averaged by the
    optimizer, this is SyncBatchNorm's semantics. Its forward runs in the
    profiler range ``parallel.batch_norm``.
    """

    momentum = 0.1  # flax momentum 0.9
    group = None

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor, bn_groups: int = 1) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        if bn_groups < 1 or x.shape[0] % bn_groups:
            raise ValueError(
                f"batch {x.shape[0]} not divisible into {bn_groups} BN groups")
        if self.group is not None:
            with torch.profiler.record_function("parallel.batch_norm"):
                return self._global(x, bn_groups)
        parts = []
        for part in x.chunk(bn_groups, dim=0):
            parts.append(F.batch_norm(part, None, None, self.weight,
                                      self.bias, True, 0.0, self.eps))
            with torch.no_grad():
                var, mean = torch.var_mean(part.float(), dim=(0, 2, 3),
                                           correction=0)
                self.running_mean.lerp_(mean, self.momentum)
                self.running_var.lerp_(var, self.momentum)
        return parts[0] if bn_groups == 1 else torch.cat(parts, dim=0)

    def _global(self, x: torch.Tensor, bn_groups: int) -> torch.Tensor:
        """Train mode over the ranks of ``self.group``."""
        xf = x.float().unflatten(0, (bn_groups, -1))  # (groups, n, C, H, W)
        y, mean, var = _GlobalBatchNorm.apply(
            xf, self.weight.float(), self.bias.float(),
            self.running_mean.detach().clone(), self.eps, self.group)
        with torch.no_grad():
            for g in range(bn_groups):
                self.running_mean.lerp_(mean[g], self.momentum)
                self.running_var.lerp_(var[g], self.momentum)
        return y.flatten(0, 1).to(x.dtype)


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

    def forward(self, x: torch.Tensor, bn_groups: int = 1) -> torch.Tensor:
        y = self.conv(x)
        if isinstance(self.norm, BatchNorm):
            y = self.norm(y, bn_groups)
        elif self.norm is not None:
            y = self.norm(y)
        return self.act(y)


class DeConvBlock(nn.Module):
    """(2x upsample) -> conv -> (noise) -> (norm) -> act."""

    def __init__(self, in_features: int, features: int,
                 kernel_size=(3, 3), strides=(1, 1), padding: Padding = 0,
                 padding_mode: str = "zeros", use_bias: bool = False,
                 up_scale: bool = True, norm: Optional[str] = None,
                 act: Optional[str] = None, use_spectral: bool = False,
                 add_noise: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.up_scale = up_scale
        self.conv = Conv2d(in_features, features, kernel_size, strides,
                           padding, padding_mode, use_bias=use_bias,
                           use_spectral=use_spectral, dtype=dtype)
        self.noise = NoiseInjection() if add_noise else None
        self.norm = _norm_layer(norm, features)
        self.act = get_act(act)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.up_scale:
            x = upsample_nearest(x)
        y = self.conv(x)
        if self.noise is not None:
            y = self.noise(y, generator)
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

    def forward(self, x: torch.Tensor, bn_groups: int = 1) -> torch.Tensor:
        y = self.conv_0(x, bn_groups)
        if self.down_scale:
            y = avg_pool(y, 2, 2)
        y = self.conv_1(y, bn_groups)
        s = avg_pool(self.conv_s(x, bn_groups), 2, 2) if self.down_scale else x
        return y + s


class _StyleNorm(nn.Module):
    """Style-norm dispatch used by NormConvBlock/NormResBlock: 'spade' |
    'sean' | 'adain', held as the submodule of that name."""

    def __init__(self, style_type: str, norm_nc: int, label_nc: int,
                 hidden_nc: int, embed_nc: Optional[int] = None,
                 style_distill: bool = False,
                 dtype: torch.dtype = torch.float32, use_pallas: bool = True):
        super().__init__()
        self.style_type = style_type
        if style_type == "spade":
            self.spade = SPADE(norm_nc, label_nc, hidden_nc, dtype=dtype)
        elif style_type == "sean":
            if embed_nc is None:
                raise ValueError("embed_nc must be specified for SEAN")
            self.sean = SEAN(embed_nc, norm_nc, label_nc, hidden_nc,
                             style_distill=style_distill, dtype=dtype,
                             use_pallas=use_pallas)
        elif style_type == "adain":
            self.adain = AdaIN(norm_nc, hidden_nc, dtype=dtype,
                               use_pallas=use_pallas)
        else:
            raise ValueError(f"Unknown style norm block type: {style_type}")

    def forward(self, x, labels, style_feat=None, *, track_stats=False,
                inference_stats=False, distill: Optional[DistillTerms] = None):
        if self.style_type == "spade":
            return self.spade(x, labels)
        if self.style_type == "sean":
            return self.sean(x, labels, style_feat, track_stats=track_stats,
                             inference_stats=inference_stats, distill=distill)
        return self.adain(x, style_feat)


class NormConvBlock(nn.Module):
    """(2x upsample) -> style-norm -> act -> conv -> (noise)."""

    def __init__(self, style_type: str, in_features: int, features: int,
                 label_nc: int, hidden_nc: int, embed_nc: Optional[int] = None,
                 style_distill: bool = False, kernel_size=(3, 3),
                 padding: Padding = "same", padding_mode: str = "zeros",
                 up_scale: bool = False, act: Optional[str] = "relu",
                 use_spectral: bool = False, add_noise: bool = False,
                 dtype: torch.dtype = torch.float32, use_pallas: bool = True):
        super().__init__()
        self.up_scale = up_scale
        self.norm = _StyleNorm(style_type, in_features, label_nc, hidden_nc,
                               embed_nc, style_distill, dtype=dtype,
                               use_pallas=use_pallas)
        self.act = get_act(act)
        self.conv = Conv2d(in_features, features, kernel_size, (1, 1), padding,
                           padding_mode, use_spectral=use_spectral, dtype=dtype)
        self.noise = NoiseInjection() if add_noise else None

    def forward(self, x, labels, style_feat=None, *,
                generator: Optional[torch.Generator] = None, **norm_kw):
        """``norm_kw``: ``track_stats``, ``inference_stats``, ``distill``
        for a SEAN norm."""
        if self.up_scale:
            x = upsample_nearest(x)
        y = self.conv(self.act(self.norm(x, labels, style_feat, **norm_kw)))
        if self.noise is not None:
            y = self.noise(y, generator)
        return y


class NormResBlock(nn.Module):
    """Residual block of two style-norm conv branches, each followed by
    noise when ``add_noise``; style-norm + conv shortcut only when
    up-scaling."""

    def __init__(self, style_type: str, in_features: int, features: int,
                 label_nc: int, hidden_nc: int, embed_nc: Optional[int] = None,
                 style_distill: bool = False, kernel_size=(3, 3),
                 padding: Padding = "same", padding_mode: str = "zeros",
                 up_scale: bool = False, act: Optional[str] = "relu",
                 use_spectral: bool = False, add_noise: bool = False,
                 dtype: torch.dtype = torch.float32, use_pallas: bool = True):
        super().__init__()
        self.up_scale = up_scale
        f_mid = min(in_features, features)
        norm_kw = dict(label_nc=label_nc, hidden_nc=hidden_nc,
                       embed_nc=embed_nc, style_distill=style_distill,
                       dtype=dtype, use_pallas=use_pallas)
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
        self.noise_0 = NoiseInjection() if add_noise else None
        self.noise_1 = NoiseInjection() if add_noise else None

    def forward(self, x, labels, style_feat=None, *,
                generator: Optional[torch.Generator] = None, **norm_kw):
        """``norm_kw``: ``track_stats``, ``inference_stats``, ``distill``
        for SEAN norms."""
        if self.up_scale:
            x = upsample_nearest(x)
            s = self.conv_s(self.norm_s(x, labels, style_feat, **norm_kw))
        else:
            s = x
        y = self.conv_0(self.act(self.norm_0(x, labels, style_feat, **norm_kw)))
        if self.noise_0 is not None:
            y = self.noise_0(y, generator)
        y = self.conv_1(self.act(self.norm_1(y, labels, style_feat, **norm_kw)))
        if self.noise_1 is not None:
            y = self.noise_1(y, generator)
        return y + s


class MaskToken(nn.Module):
    """Learnable fill value for MAE-masked patches (architecture.py:392-418).

    imgs are NHWC, masks (N, H, W, 1) with 1 = keep, 0 = masked. The token
    ``mask_token`` is a float32 parameter, zero at init, of shape (1, 1, 1,
    1) (scalar), (1, 1, 1, C) (vector), (1, S, S, 1) (position) or (1, S,
    S, C) (full), NHWC as the JAX package's; ``zero`` fills 0 and ``mean``
    the per-image channel mean of the visible pixels over the mask ratio,
    and neither has a parameter."""

    SHAPES = {"scalar": lambda c, s: (1, 1, 1, 1),
              "vector": lambda c, s: (1, 1, 1, c),
              "position": lambda c, s: (1, s, s, 1),
              "full": lambda c, s: (1, s, s, c)}

    def __init__(self, mask_token_type: str, mask_ratio: float,
                 input_nc: int = 3, image_size: int = 128):
        super().__init__()
        if mask_token_type not in ("zero", "mean", *self.SHAPES):
            raise ValueError(f"Unknown mask token type: {mask_token_type}")
        self.mask_token_type = mask_token_type
        self.mask_ratio = mask_ratio
        if mask_token_type in self.SHAPES:
            self.mask_token = nn.Parameter(torch.zeros(
                self.SHAPES[mask_token_type](input_nc, image_size)))

    def forward(self, imgs: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
        masked = imgs * masks
        if self.mask_token_type == "zero":
            return masked
        if self.mask_token_type == "mean":
            # dynamic, not a parameter (architecture.py:416-418)
            token = masked.mean(dim=(1, 2), keepdim=True) / self.mask_ratio
        else:
            token = self.mask_token
        return masked + token.to(imgs.dtype) * (1.0 - masks)


class EmbedEncoder(nn.Module):
    """Style-embedding MLP (architecture.py:420-431): (N, in) or (N, k, in)
    embeddings (averaged over k) -> relu(fc_0) -> relu(fc_1), hidden_nc
    wide."""

    def __init__(self, in_features: int, hidden_nc: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc_0 = Dense(in_features, hidden_nc, dtype=dtype)
        self.fc_1 = Dense(hidden_nc, hidden_nc, dtype=dtype)

    def forward(self, feat: torch.Tensor) -> torch.Tensor:
        if feat.dim() == 3:
            feat = feat.mean(dim=1)
        return F.relu(self.fc_1(F.relu(self.fc_0(feat))))


class LatentDecoder(nn.Module):
    """Label + noise -> latent style MLP (architecture.py:434-448): the
    labels (flattened) and ``latent_dim - label_nc`` standard-normal noise
    values -> relu(fc_0), hidden_nc // 2 wide -> relu(fc_1), hidden_nc
    wide. The noise is ``noise`` when given, else drawn from
    ``generator``."""

    def __init__(self, label_nc: int, hidden_nc: int, latent_dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.label_nc, self.latent_dim, self.dtype = label_nc, latent_dim, dtype
        self.fc_0 = Dense(latent_dim, hidden_nc // 2, dtype=dtype)
        self.fc_1 = Dense(hidden_nc // 2, hidden_nc, dtype=dtype)

    def forward(self, labels: torch.Tensor,
                noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        labels = labels.reshape(labels.shape[0], -1)
        if noise is None:
            noise = randn((labels.shape[0], self.latent_dim - self.label_nc),
                          generator, self.dtype, labels.device)
        latent = torch.cat([labels.to(self.dtype), noise.to(self.dtype)], dim=1)
        return F.relu(self.fc_1(F.relu(self.fc_0(latent))))
