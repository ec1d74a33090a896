"""Style extractor for the AdaIN path, counterpart of
``de_i2i_gan_tpu/models/extractor.py``:
  * sean_alpha == 0: (label, noise) latent -> MLP -> hidden_nc
  * otherwise:       image -> conv/ResBlock downsample pyramid -> hidden_nc
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from de_i2i_gan_torch.config import DefectGanConfig
from de_i2i_gan_torch.nn.blocks import ConvBlock, ResBlock
from de_i2i_gan_torch.nn.layers import Dense

MAX_DIM = 256


class StyleExtractor(nn.Module):
    def __init__(self, cfg: DefectGanConfig):
        super().__init__()
        self.cfg = cfg
        dt = cfg.dtype
        if cfg.sean_alpha == 0:
            self.fc_in = Dense(cfg.latent_dim, MAX_DIM, dtype=dt)
            for i in range(3):
                setattr(self, f"fc_{i}", Dense(MAX_DIM, MAX_DIM, dtype=dt))
            self.fc_out = Dense(MAX_DIM, cfg.hidden_nc, dtype=dt)
            return

        size = cfg.image_size
        if size < 16 or size & (size - 1):
            raise ValueError(
                f"image_size must be a power of two >= 16, got {size}")
        self.num_blocks = int(math.log2(size)) - 3
        crt = cfg.ndf
        self.stem = ConvBlock(cfg.input_nc, crt, (7, 7), (2, 2), 3, "reflect",
                              act="leaky_relu", dtype=dt)
        for i in range(self.num_blocks):
            nxt = min(crt * 2, MAX_DIM)
            setattr(self, f"res_{i}",
                    ResBlock(crt, nxt, (3, 3), "same", "reflect",
                             norm="instance", act="leaky_relu",
                             down_scale=True, dtype=dt))
            crt = nxt
        self.head = ConvBlock(crt, cfg.hidden_nc, (4, 4), dtype=dt)

    def forward(self, x: torch.Tensor, labels: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x: NHWC images in [-1, 1]; labels: (N, label_nc). Returns the
        (N, hidden_nc) style code. ``generator`` drives the latent path's
        noise draw."""
        cfg = self.cfg
        dt = cfg.dtype
        if cfg.sean_alpha == 0:
            noise = torch.randn((labels.shape[0], cfg.latent_dim - cfg.label_nc),
                                generator=generator, dtype=dt,
                                device=labels.device)
            h = torch.cat([labels.to(dt), noise], dim=1)
            h = F.relu(self.fc_in(h))
            for i in range(3):
                h = F.relu(getattr(self, f"fc_{i}")(h))
            return self.fc_out(h)

        h = self.stem(x.permute(0, 3, 1, 2).to(dt))
        for i in range(self.num_blocks):
            h = getattr(self, f"res_{i}")(h)
        h = self.head(h)
        return h.reshape(h.shape[0], cfg.hidden_nc)
