"""DefectGAN discriminator, counterpart of
``de_i2i_gan_tpu/models/discriminator.py::DefectGanDiscriminator``: a
StarGAN discriminator with a PatchGAN ``src`` head (3x3 conv, per-patch
real/fake logits) and a multi-label ``cls`` head whose kernel covers the
whole remaining spatial extent. No normalization, so a batch of 4B is the
same as four batches of B. Spectral norm, where configured, covers the stem
and the encoder convs, not the heads; it updates its u/v in train mode only.

``WGanDiscriminator`` is the WGAN critic: a BatchNorm conv stack, a max
pool, a global average pool and one linear output. ``ViTClassifier`` is the
linear head of the ViT classifier.
"""
from __future__ import annotations

import torch
from torch import nn

from de_i2i_gan_torch.config import DefectGanConfig, WGanConfig
from de_i2i_gan_torch.nn.blocks import ConvBlock
from de_i2i_gan_torch.nn.layers import Dense, adaptive_avg_pool, max_pool


class DefectGanDiscriminator(nn.Module):
    def __init__(self, cfg: DefectGanConfig):
        super().__init__()
        self.cfg = cfg
        dt = cfg.dtype
        ks = cfg.image_size // (2 ** (cfg.num_layers + 1))
        if ks < 1:
            raise ValueError(f"image_size {cfg.image_size} too small for "
                             f"num_layers {cfg.num_layers}")
        crt = cfg.ndf
        sn = cfg.use_spectral
        self.stem = ConvBlock(cfg.input_nc, crt, (4, 4), (2, 2), 1, "reflect",
                              act="leaky_relu", use_spectral=sn, dtype=dt)
        for i in range(cfg.num_layers):
            setattr(self, f"enc_{i}",
                    ConvBlock(crt, crt * 2, (4, 4), (2, 2), 1, "reflect",
                              act="leaky_relu", use_spectral=sn, dtype=dt))
            crt *= 2
        self.cls_clf = ConvBlock(crt, cfg.label_nc, (ks, ks), dtype=dt)
        self.src_clf = ConvBlock(crt, 1, (3, 3), (1, 1), "same", "reflect",
                                 dtype=dt)

    def forward(self, x: torch.Tensor):
        """x: NHWC images. Returns (src logits NHWC (N, h, w, 1), cls logits
        (N, label_nc)), in the compute dtype."""
        cfg = self.cfg
        feat = self.stem(x.permute(0, 3, 1, 2).to(cfg.dtype))
        for i in range(cfg.num_layers):
            feat = getattr(self, f"enc_{i}")(feat)
        cls_logits = self.cls_clf(feat)
        src_logits = self.src_clf(feat)
        return (src_logits.permute(0, 2, 3, 1),
                cls_logits.reshape(x.shape[0], cfg.label_nc))


class WGanDiscriminator(nn.Module):
    """Conv critic (JAX ``WGanDiscriminator``): 7x7/2 stem, 3x3/2 max pool,
    ``num_layers`` 3x3/2 blocks, each with BatchNorm and ReLU, a global
    average pool and ``critic``, a linear layer to one logit."""

    def __init__(self, cfg: WGanConfig):
        super().__init__()
        self.cfg = cfg
        dt = cfg.dtype
        self.stem = ConvBlock(3, cfg.ndf, (7, 7), (2, 2), 3, "reflect",
                              norm="batch", act="relu", dtype=dt)
        crt = cfg.ndf
        for i in range(cfg.num_layers):
            setattr(self, f"enc_{i}", ConvBlock(crt, crt * 2, (3, 3), (2, 2), 1,
                                                norm="batch", act="relu",
                                                dtype=dt))
            crt *= 2
        self.critic = Dense(crt, 1, dtype=dt)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: NHWC images. Returns (N, 1) logits in the compute dtype."""
        cfg = self.cfg
        feat = self.stem(x.permute(0, 3, 1, 2).to(cfg.dtype))
        feat = max_pool(feat, 3, 2, 1)
        for i in range(cfg.num_layers):
            feat = getattr(self, f"enc_{i}")(feat)
        return self.critic(adaptive_avg_pool(feat))


class ViTClassifier(nn.Module):
    """The linear head over frozen ViT CLS embeddings
    (``de_i2i_gan_tpu/models/discriminator.py::ViTClassifier``, the
    reference's discriminator.py:157-164): ``clf``, hidden -> label_nc."""

    def __init__(self, hidden: int, label_nc: int):
        super().__init__()
        self.clf = Dense(hidden, label_nc)

    def forward(self, embeds: torch.Tensor) -> torch.Tensor:
        return self.clf(embeds)
