"""Model / training configuration dataclasses.

A jax-free copy of ``de_i2i_gan_tpu/config/defaults.py``: the same fields
and defaults, so one configuration reads the same in both packages. Only
``dtype`` differs: it returns a ``torch.dtype``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


def _dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown compute_dtype {name!r}")
    return dt


@dataclasses.dataclass(frozen=True)
class DefectGanConfig:
    """Architecture hyper-parameters for the DefectGAN generator/discriminator."""

    # input/output
    image_size: int = 128
    input_nc: int = 3
    output_nc: int = 3
    label_nc: int = 6

    # generator
    ngf: int = 64
    num_scales: int = 2
    num_res: int = 6
    add_noise: bool = False
    style_norm_block_type: str = "spade"  # spade | sean | adain
    hidden_nc: int = 128

    # discriminator
    ndf: int = 64
    num_layers: int = 5

    # model switches
    init_type: str = "normal"
    init_variance: float = 0.02
    cycle_gan: bool = False
    skip_conn: bool = False
    use_spectral: bool = False

    # SEAN style embeddings
    embed_nc: int = 768
    latent_dim: int = 16
    num_embeds: int = 5
    sean_alpha: Optional[float] = None
    style_distill: bool = False
    use_running_stats: bool = False

    # compute policy: parameters stay float32, activations are cast to
    # this dtype at every conv and dense
    compute_dtype: str = "float32"
    # route the AdaIN/SEAN modulated instance norm through the hand-written
    # kernel (ops/cuda/norm_kernels.py) for CUDA tensors
    use_pallas: bool = False
    fused_g_forward: bool = True
    remat: bool = False

    @property
    def dtype(self) -> torch.dtype:
        return _dtype(self.compute_dtype)

    def replace(self, **kw) -> "DefectGanConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class MAEConfig:
    """MAE-GAN pretraining options (defectgan_options.py:144-189)."""

    mask_ratio: float = 0.75
    patch_size: int = 8
    mask_token_type: str = "position"  # zero|mean|scalar|vector|position|full
    split_training: bool = False


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimization options."""

    batch_size: int = 4
    optimizer: str = "adam"  # sgd|rmsprop|adam|adamw
    lr: Tuple[float, ...] = (2e-4,)  # (lr,) or (lr_d, lr_g)  TTUR
    lr_decay: float = 5e-3
    scheduler: str = "step"  # step|exp|cos
    num_epochs: int = -1
    num_iters: int = 500_000
    num_critics: int = 5
    # [clf_d, clf_g, rec, sd_cyc, sd_con]
    loss_weight: Tuple[float, ...] = (2.0, 5.0, 5.0, 5.0, 1.0)
    diff_aug: str = ""  # comma-separated DiffAugment policy
    clf_loss_type: str = "bce"  # bce for codebrim multilabel, cce for mvtec
    ema_decay: float = 0.0  # 0 disables

    @property
    def lr_d(self) -> float:
        return self.lr[0]

    @property
    def lr_g(self) -> float:
        return self.lr[1] if len(self.lr) > 1 else self.lr[0]


@dataclasses.dataclass(frozen=True)
class WGanConfig:
    """WGAN options (options/wgan_options.py:7-72)."""

    image_size: int = 64
    noise_dim: int = 100
    ngf: int = 64
    ndf: int = 64
    num_layers: int = 3
    clipping_limit: float = 0.03
    num_critics: int = 5
    compute_dtype: str = "float32"

    @property
    def dtype(self) -> torch.dtype:
        return _dtype(self.compute_dtype)
