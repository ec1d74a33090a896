"""StarGAN v2 networks (with the author's SEAN), counterpart of
``de_i2i_gan_tpu/models/starganv2.py``.

Mirrors stargan-v2/core/model.py:
  ResBlk        (:26-67)   pre-act residual, sqrt(2) scaling, optional
                           affine instance norm, avg-pool downsample
  StyleAdaIN    (:70-80)   style vector -> fc -> (gamma, beta)
  SEANv2        (:139-236) embedding MLP + per-domain label embedding,
                           per-domain running style statistics, mix_alpha
                           weighting, std_weight sampling
  _StyledResBlk (:83-123, 278-318) the AdaIN / SEAN residual block; with
                           w_hpf > 0 the shortcut is dropped
  Generator     (:321-393) from_rgb -> encoder ResBlks -> styled decoder
                           -> to_rgb, layer_split_index style control
  MappingNetwork (:442-471), StyleEncoder (:474-505)
  StarGANv2Discriminator (:508-532) per-domain real/fake logits

``Generator``, ``MappingNetwork`` and ``StyleEncoder`` take and return NHWC
images, as the JAX modules do; the blocks inside work in NCHW. Domain labels
are integer ids (N,). ``StyleAdaIN`` and ``SEANv2`` end in the fused
modulated instance norm (``ops/fused.py``), which launches the hand-written
CUDA kernel for a CUDA tensor; in the JAX package they have no switch for
it, and here neither. With ``w_hpf > 0`` the generator takes FAN masks
(``models/wing.py``): the high-pass of its encoder skips at 32, 64 and 128
px, weighted by the masks resized as ``jax.image.resize`` does.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from de_i2i_gan_torch.models.vit import resize_bilinear
from de_i2i_gan_torch.nn.layers import Conv2d, Dense, avg_pool, upsample_nearest
from de_i2i_gan_torch.nn.normalization import (
    finalize_running_stats, instance_norm)
from de_i2i_gan_torch.ops.fused import modulated_instance_norm

_SQRT2 = math.sqrt(2.0)
MAPPING_HIDDEN = 512  # core/model.py:446, fixed in the reference


def _leaky(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.2)


def _conv3(in_f: int, out_f: int, dtype) -> Conv2d:
    return Conv2d(in_f, out_f, (3, 3), padding=1, use_bias=True, dtype=dtype)


class AffineInstanceNorm(nn.Module):
    """The param-free instance norm with a per-channel ``scale`` and ``bias``
    (float32 parameters, applied in x's dtype)."""

    def __init__(self, num_features: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale = self.scale.to(x.dtype)[:, None, None]
        return instance_norm(x) * scale + self.bias.to(x.dtype)[:, None, None]


class ResBlk(nn.Module):
    def __init__(self, in_features: int, features: int, normalize: bool = False,
                 downsample: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.normalize, self.downsample = normalize, downsample
        if in_features != features:
            self.conv1x1 = Conv2d(in_features, features, (1, 1), dtype=dtype)
        else:
            self.conv1x1 = None
        if normalize:
            self.norm1 = AffineInstanceNorm(in_features)
            self.norm2 = AffineInstanceNorm(in_features)
        self.conv1 = _conv3(in_features, in_features, dtype)
        self.conv2 = _conv3(in_features, features, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x if self.conv1x1 is None else self.conv1x1(x)
        if self.downsample:
            s = avg_pool(s, 2, 2)
        h = self.norm1(x) if self.normalize else x
        h = self.conv1(_leaky(h))
        if self.downsample:
            h = avg_pool(h, 2, 2)
        if self.normalize:
            h = self.norm2(h)
        h = self.conv2(_leaky(h))
        return (s + h) / _SQRT2


class StyleAdaIN(nn.Module):
    """AdaIN (model.py:70-80): ``fc(style)`` split into gamma and beta for
    the fused modulated instance norm."""

    def __init__(self, style_dim: int, num_features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc = Dense(style_dim, num_features * 2, dtype=dtype)

    def forward(self, x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
        gamma, beta = self.fc(s).chunk(2, dim=-1)
        return modulated_instance_norm(x, gamma, beta)


class SEANv2(nn.Module):
    """The author's SEAN for StarGAN v2 (model.py:139-236).

    The style code by call:
      * ``inference_stats``: ``feat`` is (N, hidden_nc) noise, and the code
        ``feat * std * std_weight + mean`` samples the running statistics of
        the row's domain;
      * otherwise ``feat`` is (N, num_embeds, embed_nc) embeddings: the code
        is ``relu(mlp_shared(feat)) + label_embedding(labels)``, averaged
        over the embeddings, or weighted by ``mix_alpha`` (N, num_embeds)
        normalized per row. ``track_stats`` adds it to its domain's
        accumulators.

    The statistics are float32 buffers named as the flax ``sean_stats``
    collection: ``mean`` and ``std`` (finalized, mean first), ``sum`` and
    ``sumsq`` (label_nc, hidden_nc) and ``count`` (label_nc,), accumulating
    until ``sean_v2_update_stats``. Unlike DefectGAN's SEAN, a zero code has
    no fallback.
    """

    def __init__(self, embed_nc: int, norm_nc: int, label_nc: int,
                 hidden_nc: int = 128, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.mlp_shared = Dense(embed_nc, hidden_nc, dtype=dtype)
        self.label_embedding = nn.Embedding(label_nc, hidden_nc)
        self.mlp_gamma = Dense(hidden_nc, norm_nc, dtype=dtype)
        self.mlp_beta = Dense(hidden_nc, norm_nc, dtype=dtype)
        for name in ("mean", "std", "sum", "sumsq"):
            self.register_buffer(name, torch.zeros(label_nc, hidden_nc))
        self.register_buffer("count", torch.zeros(label_nc))

    def forward(self, x: torch.Tensor, labels: torch.Tensor,
                feat: torch.Tensor, *, track_stats: bool = False,
                inference_stats: bool = False, std_weight: float = 1.0,
                mix_alpha: Optional[torch.Tensor] = None) -> torch.Tensor:
        dt = self.dtype
        if inference_stats:
            mix = (feat.to(dt) * self.std[labels].to(dt) * std_weight
                   + self.mean[labels].to(dt))
        else:
            if feat.dim() != 3:
                raise ValueError(f"SEANv2 takes (N, num_embeds, embed_nc) "
                                 f"embeddings, got {tuple(feat.shape)}")
            enc = F.relu(self.mlp_shared(feat.to(dt)))
            mix = enc + self.label_embedding(labels).to(dt)[:, None, :]
            if mix_alpha is not None:
                w = mix_alpha / mix_alpha.sum(dim=1, keepdim=True)
                mix = (mix * w[..., None]).sum(dim=1)
            else:
                mix = mix.mean(dim=1)
            if track_stats:
                tracked = mix.detach().float()
                self.sum.index_add_(0, labels, tracked)
                self.sumsq.index_add_(0, labels, tracked.square())
                self.count.index_add_(0, labels, torch.ones_like(tracked[:, 0]))
        gamma = self.mlp_gamma(mix)
        beta = self.mlp_beta(mix)
        return modulated_instance_norm(x, gamma, beta)


class _StyledResBlk(nn.Module):
    """Shared body of AdainResBlk / SEANResBlk (model.py:83-123, 278-318)."""

    def __init__(self, in_features: int, features: int, norm_type: str,
                 style_dim: int = 64, embed_nc: int = 768, label_nc: int = 3,
                 hidden_nc: int = 256, w_hpf: float = 0.0,
                 upsample: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        if norm_type not in ("adain", "sean"):
            raise ValueError(f"unknown norm_type {norm_type!r}")
        self.norm_type, self.w_hpf, self.upsample = norm_type, w_hpf, upsample

        def norm(nc):
            if norm_type == "adain":
                return StyleAdaIN(style_dim, nc, dtype=dtype)
            return SEANv2(embed_nc, nc, label_nc, hidden_nc, dtype=dtype)

        self.norm1 = norm(in_features)
        self.conv1 = _conv3(in_features, features, dtype)
        self.norm2 = norm(features)
        self.conv2 = _conv3(features, features, dtype)
        self.conv1x1 = (Conv2d(in_features, features, (1, 1), dtype=dtype)
                        if w_hpf == 0 and in_features != features else None)

    def forward(self, x: torch.Tensor, s: torch.Tensor,
                labels: Optional[torch.Tensor] = None, **sean_kw) -> torch.Tensor:
        def norm(layer, h):
            if self.norm_type == "adain":
                return layer(h, s)
            return layer(h, labels, s, **sean_kw)

        h = _leaky(norm(self.norm1, x))
        if self.upsample:
            h = upsample_nearest(h)
        h = self.conv1(h)
        h = self.conv2(_leaky(norm(self.norm2, h)))
        if self.w_hpf == 0:
            sc = upsample_nearest(x) if self.upsample else x
            if self.conv1x1 is not None:
                sc = self.conv1x1(sc)
            h = (h + sc) / _SQRT2
        return h


def high_pass(x: torch.Tensor, w_hpf: float) -> torch.Tensor:
    """Depthwise 3x3 Laplacian high-pass filter of NCHW x (model.py:126-136)."""
    c = x.shape[1]
    filt = torch.tensor([[-1.0, -1.0, -1.0], [-1.0, 8.0, -1.0],
                         [-1.0, -1.0, -1.0]], dtype=x.dtype,
                        device=x.device) / w_hpf
    return F.conv2d(x, filt.expand(c, 1, 3, 3), padding=1, groups=c)


def _encoder_plan(img_size: int, max_conv_dim: int, w_hpf: float):
    dim_in = 2 ** 14 // img_size
    repeat_num = int(math.log2(img_size)) - 4 + (1 if w_hpf > 0 else 0)
    dims, d = [], dim_in
    for _ in range(repeat_num):
        dims.append((d, min(d * 2, max_conv_dim)))
        d = min(d * 2, max_conv_dim)
    return dim_in, dims, d


class Generator(nn.Module):
    """model.py:321-393. ``forward(x, s, masks=None, labels=None,
    layer_split_index=None, **sean_kw)``: x NHWC images; s the style
    ((N, style_dim) for AdaIN, (N, num_embeds, embed_nc) embeddings or
    (N, hidden_nc) noise for SEAN, with a second style on axis 1 when
    ``layer_split_index`` lists decoder layers that take it); masks the two
    NHWC FAN masks (``models/wing.py::fan_masks``) of ``w_hpf > 0``, or
    None; labels the domain ids SEAN needs. Returns NHWC images."""

    def __init__(self, img_size: int = 256, style_dim: int = 64,
                 max_conv_dim: int = 512, w_hpf: float = 1.0,
                 norm_type: str = "adain", embed_nc: int = 768,
                 label_nc: int = 3, hidden_nc: int = 256,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype, self.w_hpf = dtype, w_hpf
        dim_in, dims, d = _encoder_plan(img_size, max_conv_dim, w_hpf)
        self.num_encode = len(dims)
        self.from_rgb = _conv3(3, dim_in, dtype)
        for i, (di, do) in enumerate(dims):
            setattr(self, f"encode_{i}",
                    ResBlk(di, do, normalize=True, downsample=True, dtype=dtype))
        for i in range(2):
            setattr(self, f"encode_bottleneck_{i}",
                    ResBlk(d, d, normalize=True, dtype=dtype))
        blk_kw = dict(norm_type=norm_type, style_dim=style_dim,
                      embed_nc=embed_nc, label_nc=label_nc,
                      hidden_nc=hidden_nc, w_hpf=w_hpf, dtype=dtype)
        for i in range(2):
            setattr(self, f"decode_bottleneck_{i}",
                    _StyledResBlk(d, d, upsample=False, **blk_kw))
        for i, (di, do) in enumerate(reversed(dims)):
            setattr(self, f"decode_{i}",
                    _StyledResBlk(do, di, upsample=True, **blk_kw))
        self.to_rgb_norm = AffineInstanceNorm(dim_in)
        self.to_rgb = Conv2d(dim_in, 3, (1, 1), use_bias=True, dtype=dtype)

    def forward(self, x: torch.Tensor, s: torch.Tensor, masks=None,
                labels: Optional[torch.Tensor] = None,
                layer_split_index: Optional[Sequence[int]] = None,
                **sean_kw) -> torch.Tensor:
        x = self.from_rgb(x.permute(0, 3, 1, 2).contiguous().to(self.dtype))
        cache = {}  # the encoder's skips at 32, 64 and 128 px (masks only)
        for i in range(self.num_encode):
            if masks is not None and x.shape[2] in (32, 64, 128):
                cache[x.shape[2]] = x
            x = getattr(self, f"encode_{i}")(x)
        for i in range(2):
            x = getattr(self, f"encode_bottleneck_{i}")(x)

        def style_for(idx):
            if layer_split_index is None:
                return s
            # s: (N, 2, ...): the second style for the listed decoder layers
            # (model.py:381-386)
            return s[:, 1] if idx in layer_split_index else s[:, 0]

        blocks = [f"decode_bottleneck_{i}" for i in range(2)] + [
            f"decode_{i}" for i in range(self.num_encode)]
        for idx, name in enumerate(blocks):
            x = getattr(self, name)(x, style_for(idx), labels, **sean_kw)
            size = x.shape[2]
            if masks is not None and size in (32, 64, 128) and \
                    name.startswith("decode_"):
                # the FAN masks' high-pass of the skip (model.py:381-393);
                # the masks are float32, so x leaves in float32, as in JAX
                mask = masks[0] if size == 32 else masks[1]
                mask = resize_bilinear(mask.permute(0, 3, 1, 2).float(), size)
                x = x + high_pass(mask * cache[size], self.w_hpf)
        x = self.to_rgb(_leaky(self.to_rgb_norm(x)))
        return x.permute(0, 2, 3, 1)


def _select(out: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(N, num_domains, style_dim) -> each row's domain (N, style_dim)."""
    return out[torch.arange(y.shape[0], device=y.device), y]


class MappingNetwork(nn.Module):
    """model.py:442-471: latent z and domain y -> style."""

    def __init__(self, latent_dim: int = 16, style_dim: int = 64,
                 num_domains: int = 2, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype, self.num_domains = dtype, num_domains
        for i in range(4):
            setattr(self, f"shared_{i}",
                    Dense(latent_dim if i == 0 else MAPPING_HIDDEN,
                          MAPPING_HIDDEN, dtype=dtype))
        for d in range(num_domains):
            for j in range(3):
                setattr(self, f"unshared_{d}_{j}",
                        Dense(MAPPING_HIDDEN, MAPPING_HIDDEN, dtype=dtype))
            setattr(self, f"unshared_{d}_out",
                    Dense(MAPPING_HIDDEN, style_dim, dtype=dtype))

    def forward(self, z: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        h = z.to(self.dtype)
        for i in range(4):
            h = F.relu(getattr(self, f"shared_{i}")(h))
        outs = []
        for d in range(self.num_domains):
            u = h
            for j in range(3):
                u = F.relu(getattr(self, f"unshared_{d}_{j}")(u))
            outs.append(getattr(self, f"unshared_{d}_out")(u))
        return _select(torch.stack(outs, dim=1), y)


class StyleEncoder(nn.Module):
    """model.py:474-505: NHWC image x and domain y -> style."""

    def __init__(self, img_size: int = 256, style_dim: int = 64,
                 num_domains: int = 2, max_conv_dim: int = 512,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype, self.num_domains = dtype, num_domains
        dim_in = 2 ** 14 // img_size
        self.from_rgb = _conv3(3, dim_in, dtype)
        self.num_blocks = int(math.log2(img_size)) - 2
        d = dim_in
        for i in range(self.num_blocks):
            out = min(d * 2, max_conv_dim)
            setattr(self, f"block_{i}", ResBlk(d, out, downsample=True,
                                               dtype=dtype))
            d = out
        self.conv4 = Conv2d(d, d, (4, 4), use_bias=True, dtype=dtype)
        for i in range(num_domains):
            setattr(self, f"unshared_{i}", Dense(d, style_dim, dtype=dtype))

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        h = self.from_rgb(x.permute(0, 3, 1, 2).contiguous().to(self.dtype))
        for i in range(self.num_blocks):
            h = getattr(self, f"block_{i}")(h)
        h = _leaky(self.conv4(_leaky(h)))
        # (N, C, h, w) in NHWC order, as the JAX reshape flattens it
        h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
        outs = [getattr(self, f"unshared_{i}")(h) for i in range(self.num_domains)]
        return _select(torch.stack(outs, dim=1), y)


class StarGANv2Discriminator(nn.Module):
    """model.py:508-532: NHWC image x and domain y -> the real/fake logit of
    each row's domain (N,). No normalization, so R1's double backward never
    reaches the modulated instance norm."""

    def __init__(self, img_size: int = 256, num_domains: int = 2,
                 max_conv_dim: int = 512, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        dim_in = 2 ** 14 // img_size
        self.from_rgb = _conv3(3, dim_in, dtype)
        self.num_blocks = int(math.log2(img_size)) - 2
        d = dim_in
        for i in range(self.num_blocks):
            out = min(d * 2, max_conv_dim)
            setattr(self, f"block_{i}", ResBlk(d, out, downsample=True,
                                               dtype=dtype))
            d = out
        self.conv4 = Conv2d(d, d, (4, 4), use_bias=True, dtype=dtype)
        self.head = Conv2d(d, num_domains, (1, 1), use_bias=True, dtype=dtype)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        h = self.from_rgb(x.permute(0, 3, 1, 2).contiguous().to(self.dtype))
        for i in range(self.num_blocks):
            h = getattr(self, f"block_{i}")(h)
        h = self.head(_leaky(self.conv4(_leaky(h))))
        # flattened in NHWC order, as the JAX reshape does
        out = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
        return out[torch.arange(y.shape[0], device=y.device), y]


@torch.no_grad()
def sean_v2_update_stats(module: nn.Module, eps: float = 1e-5,
                         group=None) -> None:
    """Finalize the running styles of every SEANv2 layer in ``module``, in
    place (model.py:186-201): per domain, the mean and the unbiased std,
    sqrt(var + eps), of the codes tracked since the last call; a domain with
    no tracked code keeps its previous mean and std; the accumulators
    reset. With a process ``group`` the ranks' accumulators are summed
    first (``parallel/mesh.py::reduce_running_styles``)."""
    if group is not None:
        from de_i2i_gan_torch.parallel.mesh import reduce_running_styles
        reduce_running_styles(module, group)
    for m in module.modules():
        if isinstance(m, SEANv2):
            finalize_running_stats(m, eps)
