"""DefectGAN steps, counterpart of ``de_i2i_gan_tpu/train/steps.py``.

This slice holds the serving path, ``DefectGanSteps.generate``: eval-mode
generation with the AdaIN style code taken from the input images when no
style is given. The discriminator, the losses and the optimizers come with
the training slice.
"""
from __future__ import annotations

import copy
from typing import Optional

import torch

from de_i2i_gan_torch.config import DefectGanConfig, TrainConfig
from de_i2i_gan_torch.models.extractor import StyleExtractor
from de_i2i_gan_torch.models.generator import DefectGanGenerator


class DefectGanSteps:
    """Holds the generator ``G``, the AdaIN style extractor ``E`` (or None)
    and the EMA generator ``ema_G`` (when ``tcfg.ema_decay > 0``), in eval
    mode on ``device``."""

    def __init__(self, cfg: DefectGanConfig,
                 tcfg: Optional[TrainConfig] = None,
                 device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.tcfg = tcfg if tcfg is not None else TrainConfig()
        self.device = torch.device(device)
        self.G = DefectGanGenerator(cfg).to(self.device).eval()
        self.E = (StyleExtractor(cfg).to(self.device).eval()
                  if cfg.style_norm_block_type == "adain" else None)
        self.ema_G = (copy.deepcopy(self.G) if self.tcfg.ema_decay > 0
                      else None)

    @torch.no_grad()
    def generate(self, data: torch.Tensor, labels: torch.Tensor,
                 style_feat: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None,
                 use_ema: bool = False):
        """Eval-mode generation. data: NHWC float images in [-1, 1];
        labels: (N, label_nc) one-hot; returns NHWC (out, prob)."""
        data = torch.as_tensor(data, device=self.device)
        labels = torch.as_tensor(labels, device=self.device)
        if style_feat is not None:
            style_feat = torch.as_tensor(style_feat, device=self.device)
        G = self.ema_G if (use_ema and self.ema_G is not None) else self.G
        if (self.cfg.style_norm_block_type == "adain" and style_feat is None
                and self.E is not None):
            style_feat = self.E(data, labels, generator=generator)
        return G(data, labels, style_feat)
