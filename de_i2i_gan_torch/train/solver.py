"""StarGAN v2 serving, counterpart of the sampling side of
``de_i2i_gan_tpu/train/solver.py::StarGANv2Solver``.

The solver holds the generator G, the mapping network M and the style
encoder S (AdaIN only), and their EMA copies, in eval mode on one device.
Style codes (core/utils.py:485-516 get_style_code): AdaIN takes M(z, y)
for a latent style or S(x_ref, y) for a reference style; SEAN takes the
caller's frozen-ViT embeddings of the reference images, or noise that
samples its running styles (``inference_stats``). SEAN's running styles
are buffers of each generator: G's hold the JAX state's
``G.state["sean_stats"]``, ``ema_G``'s its ``ema_sean_stats``.

Every method runs under ``torch.inference_mode()``. Training (D, R1, the
losses, the EMA updates), the data and the CLI wait for ROADMAP A.3.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Dict, Optional

import torch

from de_i2i_gan_torch.models.starganv2 import (
    Generator, MappingNetwork, StyleEncoder, sean_v2_update_stats)


@dataclasses.dataclass(frozen=True)
class StarGANv2Config:
    """main.py:150-267 defaults; the same fields and defaults as the JAX
    package's, with ``dtype`` a ``torch.dtype``."""

    img_size: int = 256
    num_domains: int = 2
    latent_dim: int = 16
    hidden_nc: int = 256
    style_dim: int = 64
    embed_nc: int = 768
    norm_type: str = "adain"  # adain | sean
    w_hpf: float = 1.0
    max_conv_dim: int = 512
    lambda_reg: float = 1.0
    lambda_cyc: float = 1.0
    lambda_sty: float = 1.0
    lambda_ds: float = 1.0
    lambda_rec: float = 10.0  # MAE pretrain reconstruction (main.py:175)
    ds_iter: int = 100_000
    total_iters: int = 100_000
    batch_size: int = 8
    lr: float = 1e-4
    f_lr: float = 1e-6
    beta1: float = 0.0
    beta2: float = 0.99
    weight_decay: float = 1e-4
    num_embeds: int = 5
    diff_aug: str = ""
    ema_beta: float = 0.999
    fused_prop: bool = False
    compute_dtype: str = "float32"
    allow_degraded_losses: bool = False

    @property
    def dtype(self) -> torch.dtype:
        dt = getattr(torch, self.compute_dtype, None)
        if not isinstance(dt, torch.dtype):
            raise ValueError(f"unknown compute_dtype {self.compute_dtype!r}")
        return dt

    def replace(self, **kw) -> "StarGANv2Config":
        return dataclasses.replace(self, **kw)


class StarGANv2Solver:
    def __init__(self, cfg: StarGANv2Config, device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        adain = cfg.norm_type == "adain"
        self.G = Generator(cfg.img_size, cfg.style_dim, cfg.max_conv_dim,
                           cfg.w_hpf, cfg.norm_type, cfg.embed_nc,
                           cfg.num_domains, cfg.hidden_nc, dtype=cfg.dtype)
        self.M = MappingNetwork(cfg.latent_dim, cfg.style_dim, cfg.num_domains,
                                dtype=cfg.dtype) if adain else None
        self.S = StyleEncoder(cfg.img_size, cfg.style_dim, cfg.num_domains,
                              cfg.max_conv_dim, dtype=cfg.dtype) if adain else None
        for name in ("G", "M", "S"):
            net = getattr(self, name)
            if net is not None:
                net.to(self.device).eval().requires_grad_(False)
            setattr(self, f"ema_{name}", copy.deepcopy(net))

    def nets(self) -> Dict[str, torch.nn.Module]:
        """The solver's networks by name: G, M, S and their EMA copies."""
        return {name: getattr(self, name)
                for name in ("G", "M", "S", "ema_G", "ema_M", "ema_S")
                if getattr(self, name) is not None}

    def _as(self, t: Optional[torch.Tensor], dtype=None):
        return None if t is None else torch.as_tensor(t, dtype=dtype,
                                                      device=self.device)

    @torch.inference_mode()
    def style(self, batch: Dict[str, torch.Tensor], y_trg: torch.Tensor, *,
              which: str = "ref", latent: bool, use_ema: bool = False
              ) -> torch.Tensor:
        """get_style_code (utils.py:485-516; the JAX solver's ``_style``):
        AdaIN maps ``batch["z_<which>"]`` through M (``latent``) or encodes
        the NHWC images ``batch["x_<which>"]`` through S; SEAN returns the
        embeddings ``batch["s_<which>"]``. ``use_ema`` takes the EMA nets, as
        sampling does."""
        y_trg = self._as(y_trg, torch.int64)
        if self.cfg.norm_type == "adain":
            if latent:
                net = self.ema_M if use_ema else self.M
                return net(self._as(batch[f"z_{which}"]), y_trg)
            net = self.ema_S if use_ema else self.S
            return net(self._as(batch[f"x_{which}"]), y_trg)
        return self._as(batch[f"s_{which}"])

    @torch.inference_mode()
    def generate(self, x: torch.Tensor, s: torch.Tensor, y: torch.Tensor,
                 masks=None, use_ema: bool = True, **kw) -> torch.Tensor:
        """Translate the NHWC images ``x`` to domains ``y`` with style ``s``;
        ``use_ema`` takes the EMA generator and its running styles. ``kw``:
        ``layer_split_index``, and for SEAN ``inference_stats``,
        ``std_weight`` and ``mix_alpha``."""
        G = self.ema_G if use_ema else self.G
        return G(self._as(x), self._as(s), masks,
                 labels=self._as(y, torch.int64), **kw)

    @torch.inference_mode()
    def track_stats_step(self, x: torch.Tensor, s: torch.Tensor,
                         y: torch.Tensor, masks=None) -> None:
        """One tracking forward of the EMA generator, the body of the
        ``update_stats`` CLI mode (solver.py:379-406): the style codes land
        in ``ema_G``'s SEANv2 accumulators."""
        self.ema_G(self._as(x), self._as(s), masks,
                   labels=self._as(y, torch.int64), track_stats=True)

    @torch.inference_mode()
    def finalize_ema_stats(self) -> None:
        """Finalize the EMA running styles after an update_stats sweep."""
        sean_v2_update_stats(self.ema_G)
