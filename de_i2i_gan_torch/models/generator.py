"""DefectGAN generator, counterpart of ``de_i2i_gan_tpu/models/generator.py``:
an encoder-decoder with a style-normalized decoder and dual heads
(foreground tanh + spatial-probability sigmoid) composed over the input
image, ``out = x * (1 - p) + fg * p``.

``forward`` takes and returns NHWC, as the JAX module does; the modules
inside work in NCHW and the layout changes once at each end. Train mode is
the module's mode (``.train()``); ``bn_groups`` scopes the BatchNorm batch
statistics of the stem and encoder to contiguous batch groups, so one fused
2B forward equals two B forwards. Spectral norm, where configured, updates
its u/v in train mode only.

The decoder's style norm is SPADE (driven by the labels), AdaIN (a
(N, hidden_nc) style code) or SEAN (labels and (N, num_embeds, embed_nc)
style embeddings, or (N, hidden_nc) noise with ``inference_stats``).

``WGanGenerator`` is the WGAN's noise -> image DCGAN-style generator.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from de_i2i_gan_torch.config import DefectGanConfig, WGanConfig
from de_i2i_gan_torch.nn.blocks import (
    ConvBlock,
    DeConvBlock,
    NormConvBlock,
    NormResBlock,
    ResBlock,
)
from de_i2i_gan_torch.nn.layers import Conv2d, avg_pool, upsample_nearest
from de_i2i_gan_torch.nn.normalization import DistillTerms


class DefectGanGenerator(nn.Module):
    def __init__(self, cfg: DefectGanConfig):
        super().__init__()
        if cfg.num_res % 2:
            raise ValueError("num_res must be even")
        self.cfg = cfg
        dt = cfg.dtype
        style_kw = dict(label_nc=cfg.label_nc, hidden_nc=cfg.hidden_nc,
                        embed_nc=cfg.embed_nc, style_distill=cfg.style_distill,
                        padding="same", padding_mode="reflect", act="relu",
                        use_spectral=cfg.use_spectral, add_noise=cfg.add_noise,
                        dtype=dt, use_pallas=cfg.use_pallas)
        st = cfg.style_norm_block_type

        self.stem = ConvBlock(cfg.input_nc, cfg.ngf, (7, 7), (1, 1), "same",
                              "reflect", norm="batch", act="leaky_relu",
                              use_spectral=cfg.use_spectral, dtype=dt)
        crt = cfg.ngf
        skip_nc = []
        for i in range(cfg.num_scales):
            skip_nc.append(crt)
            setattr(self, f"enc_{i}",
                    ConvBlock(crt, crt * 2, (4, 4), (2, 2), 1, "reflect",
                              norm="batch", act="leaky_relu",
                              use_spectral=cfg.use_spectral, dtype=dt))
            crt *= 2
        for i in range(cfg.num_res // 2):
            setattr(self, f"enc_res_{i}",
                    ResBlock(crt, crt, (3, 3), "same", "reflect", norm="batch",
                             act="leaky_relu", use_spectral=cfg.use_spectral,
                             dtype=dt))
        for i in range(cfg.num_res // 2):
            setattr(self, f"dec_res_{i}", NormResBlock(st, crt, crt, **style_kw))
        for i in range(cfg.num_scales):
            f_in = crt + (skip_nc[-1 - i] if cfg.skip_conn else 0)
            crt //= 2
            setattr(self, f"dec_{i}",
                    NormConvBlock(st, f_in, crt, kernel_size=(3, 3),
                                  up_scale=True, **style_kw))
        self.foreground_head = DeConvBlock(
            crt, 3, (3, 3), padding="same", padding_mode="reflect",
            up_scale=False, act="tanh", dtype=dt)
        self.distribution_head = DeConvBlock(
            crt, 1, (3, 3), padding="same", padding_mode="reflect",
            up_scale=False, act="sigmoid", dtype=dt)

    def forward(self, x: torch.Tensor, labels: torch.Tensor,
                style_feat: Optional[torch.Tensor] = None,
                bn_groups: int = 1, *, track_stats: bool = False,
                inference_stats: bool = False,
                distill: Optional[DistillTerms] = None,
                generator: Optional[torch.Generator] = None):
        """x: NHWC images in [-1, 1]; labels: (N, label_nc) one-hot;
        style_feat: the decoder's style input (None for spade); bn_groups:
        BatchNorm groups in train mode. SEAN only: ``track_stats`` adds the
        style codes to the running statistics, ``inference_stats`` samples
        them, ``distill`` collects the distillation terms. ``generator``
        drives the noise injection. Returns NHWC (out, prob)."""
        cfg = self.cfg
        scale = 2 ** cfg.num_scales
        if x.shape[1] % scale or x.shape[2] % scale:
            raise ValueError(
                f"image dims {x.shape[1]}x{x.shape[2]} must be divisible by "
                f"2**num_scales={scale}")
        x = x.permute(0, 3, 1, 2).to(cfg.dtype)
        dec_kw = dict(track_stats=track_stats, inference_stats=inference_stats,
                      distill=distill, generator=generator)

        feat = self.stem(x, bn_groups)
        skips = []
        for i in range(cfg.num_scales):
            skips.append(feat)
            feat = getattr(self, f"enc_{i}")(feat, bn_groups)
        for i in range(cfg.num_res // 2):
            feat = getattr(self, f"enc_res_{i}")(feat, bn_groups)
        for i in range(cfg.num_res // 2):
            feat = getattr(self, f"dec_res_{i}")(feat, labels, style_feat,
                                                  **dec_kw)
        for i in range(cfg.num_scales):
            if cfg.skip_conn:
                feat = torch.cat([feat, _shrink_to(skips[-1 - i], feat)], dim=1)
            feat = getattr(self, f"dec_{i}")(feat, labels, style_feat, **dec_kw)

        feat = torch.nan_to_num(feat)
        foreground = self.foreground_head(feat)
        spatial_prob = self.distribution_head(feat)
        first = foreground if cfg.cycle_gan else \
            x * (1.0 - spatial_prob) + foreground * spatial_prob
        return first.permute(0, 2, 3, 1), spatial_prob.permute(0, 2, 3, 1)


def _shrink_to(skip: torch.Tensor, feat: torch.Tensor) -> torch.Tensor:
    """Average-pool an encoder feature down to the decoder feature's spatial
    size for U-Net concatenation."""
    fh = skip.shape[2] // feat.shape[2]
    if fh <= 1:
        return skip
    return avg_pool(skip, fh, fh)


class WGanGenerator(nn.Module):
    """Noise -> image DCGAN-style generator (JAX ``WGanGenerator``).

    Spatial schedule for image_size=64, num_layers=3: 1 -> 2 (up) -> 4 ->
    8 -> 16 -> 32 (upsampling deconvs, BatchNorm, ReLU) -> 64 (up) ->
    4x4 'same' conv to RGB -> tanh.
    """

    def __init__(self, cfg: WGanConfig):
        super().__init__()
        self.cfg = cfg
        dt = cfg.dtype
        crt = cfg.ngf * (2 ** cfg.num_layers)
        kw = dict(padding="same", norm="batch", act="relu", up_scale=True,
                  dtype=dt)
        self.head = DeConvBlock(cfg.noise_dim, crt, (4, 4), **kw)
        for i in range(cfg.num_layers):
            setattr(self, f"up_{i}", DeConvBlock(crt, crt // 2, (4, 4), **kw))
            crt //= 2
        self.to_rgb = Conv2d(crt, 3, (4, 4), (1, 1), "same", dtype=dt)

    def forward(self, noise: torch.Tensor) -> torch.Tensor:
        """noise: (N, noise_dim). Returns NHWC images in [-1, 1]."""
        cfg = self.cfg
        x = noise.reshape(noise.shape[0], cfg.noise_dim, 1, 1).to(cfg.dtype)
        x = self.head(upsample_nearest(x))
        for i in range(cfg.num_layers):
            x = getattr(self, f"up_{i}")(x)
        x = self.to_rgb(upsample_nearest(x))
        return torch.tanh(x).permute(0, 2, 3, 1)
