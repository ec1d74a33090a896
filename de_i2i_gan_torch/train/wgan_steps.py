"""WGAN training steps, weight clipping and gradient penalty, counterpart of
``de_i2i_gan_tpu/train/wgan_steps.py`` (reference trainers/wgan_trainer.py
and models/wgan_model.py):

  * the critic's weights, every parameter of D including BatchNorm's scale
    and bias (not its running statistics), are clipped to +/-
    ``clipping_limit`` before each D step, and the update applies to the
    clipped weights
  * Wasserstein losses: d_loss = mean(D(fake)) - mean(D(real)),
    g_loss = -mean(D(G(z)))
  * one G update every ``num_critics`` D updates (``super_step``); G's
    learning-rate schedule counts with ``update_every=num_critics``
  * ``gp_weight > 0``: the interpolated gradient penalty in place of the
    clipping, (||dD/dx_hat|| - 1)^2 with the norm in float32 (+1e-12),
    D in eval mode on its running statistics from before the step

The critic runs BatchNorm: D sees the real batch, then the fake one, in two
train-mode forwards whose running statistics chain, as the reference does
(one mixed batch would change the statistics). The penalty's pass runs
first, on a snapshot of the statistics from before those forwards.

The noise ``z`` and the penalty's ``eps`` are drawn from the ``generator``
a call is given, or taken as arguments (tests hand in the JAX draws).
``step`` counts D updates.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from de_i2i_gan_torch.config import TrainConfig, WGanConfig
from de_i2i_gan_torch.models.discriminator import WGanDiscriminator
from de_i2i_gan_torch.models.generator import WGanGenerator
from de_i2i_gan_torch.nn.conv_grad import differentiated_twice
from de_i2i_gan_torch.ops.fused import batch_images_to_float
from de_i2i_gan_torch.train.optim import make_optimizer


@torch.no_grad()
def clip_tree(params, limit: float) -> None:
    """Clamp every tensor of ``params`` to [-limit, limit], in place."""
    for p in params:
        p.clamp_(-limit, limit)


class WGanSteps:
    """Holds G, D and their optimizers ``tx_G``, ``tx_D`` on ``device``."""

    E = ema_G = tx_E = None  # the checkpoint's net list: G and D

    def __init__(self, cfg: WGanConfig, tcfg: TrainConfig,
                 iters_per_epoch: int = 1000, num_epochs: int = 120,
                 gp_weight: float = 0.0, device: str | torch.device = "cuda"):
        self.cfg, self.tcfg = cfg, tcfg
        self.gp_weight = gp_weight  # > 0: WGAN-GP, no clipping
        self.device = torch.device(device)
        self.G = WGanGenerator(cfg).to(self.device).eval()
        self.D = WGanDiscriminator(cfg).to(self.device).eval()
        self.tx_D = make_optimizer(tcfg, self.D.parameters(), tcfg.lr_d,
                                   iters_per_epoch, num_epochs)
        self.tx_G = make_optimizer(tcfg, self.G.parameters(), tcfg.lr_g,
                                   iters_per_epoch, num_epochs,
                                   update_every=cfg.num_critics)
        self.step = 0

    def _noise(self, b: int, generator: Optional[torch.Generator]):
        return torch.randn((b, self.cfg.noise_dim), generator=generator,
                           device=self.device)

    def _penalty(self, real: torch.Tensor, fake: torch.Tensor,
                 eps: torch.Tensor) -> torch.Tensor:
        """gp_weight * mean((||dD/dx_hat|| - 1)^2) at x_hat = eps * real +
        (1 - eps) * fake, D in eval mode on a snapshot of its running
        statistics (the train-mode forwards move the live ones in place
        while this graph still needs them); a graph for the double
        backward, the critic's forward inside ``differentiated_twice()``
        (``nn/conv_grad.py``)."""
        x_hat = (eps * real + (1 - eps) * fake).requires_grad_(True)
        stats = {k: v.clone() for k, v in self.D.named_buffers()}
        with differentiated_twice():
            critic = torch.func.functional_call(self.D, stats, (x_hat,))
        (g,) = torch.autograd.grad(critic.sum(), x_hat, create_graph=True)
        norms = torch.sqrt(g.float().square().sum(dim=(1, 2, 3)) + 1e-12)
        return self.gp_weight * (norms - 1.0).square().mean()

    def d_step(self, batch, generator: Optional[torch.Generator] = None,
               z: Optional[torch.Tensor] = None,
               eps: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """One critic update on ``batch["imgs"]`` (NHWC). ``z``: (B,
        noise_dim) noise, ``eps``: (B, 1, 1, 1) interpolation weights of
        the penalty; drawn when not given."""
        real = torch.as_tensor(batch["imgs"], device=self.device)
        b = real.shape[0]
        z = self._noise(b, generator) if z is None else z.to(self.device)
        if self.gp_weight > 0 and eps is None:
            eps = torch.rand((b, 1, 1, 1), generator=generator,
                             device=self.device)
        if self.gp_weight <= 0:
            clip_tree(self.tx_D.params, self.cfg.clipping_limit)
        with torch.no_grad():
            fake = self.G(z)
        penalty = (self._penalty(real, fake, eps.to(self.device))
                   if self.gp_weight > 0 else None)
        self.D.train()
        try:
            real_logits = self.D(real)
            fake_logits = self.D(fake)
        finally:
            self.D.eval()
        w_dist = real_logits.mean() - fake_logits.mean()
        loss = -w_dist
        if penalty is not None:
            loss = loss + penalty
        self.tx_D.step(torch.autograd.grad(loss, self.tx_D.params))
        self.step += 1
        return {"w_dist": w_dist.detach()}

    def g_step(self, batch, generator: Optional[torch.Generator] = None,
               z: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """One G update against the critic in eval mode; ``z`` as in
        ``d_step``."""
        b = batch["imgs"].shape[0]
        z = self._noise(b, generator) if z is None else z.to(self.device)
        self.G.train()
        try:
            fake = self.G(z)
        finally:
            self.G.eval()
        g_loss = -self.D(fake).mean()
        self.tx_G.step(torch.autograd.grad(g_loss, self.tx_G.params))
        return {"g_loss": g_loss.detach()}

    def super_step(self, batches, generator: Optional[torch.Generator] = None,
                   z: Optional[torch.Tensor] = None,
                   eps: Optional[torch.Tensor] = None
                   ) -> Dict[str, torch.Tensor]:
        """``num_critics`` D updates, one per row of the leading axis of
        ``batches["imgs"]`` (u8 or [-1, 1] NHWC), then one G update on the
        last row. ``z``: (rows + 1, B, noise_dim), the D steps' noise then
        G's; ``eps``: (rows, B, 1, 1, 1); drawn when not given."""
        batches = batch_images_to_float(
            {k: torch.as_tensor(v, device=self.device)
             for k, v in batches.items()})
        rows = batches["imgs"].shape[0]
        d_metrics = [self.d_step(
            {k: v[i] for k, v in batches.items()}, generator,
            None if z is None else z[i], None if eps is None else eps[i])
            for i in range(rows)]
        metrics = {k: torch.stack([m[k] for m in d_metrics]).float().mean()
                   for k in d_metrics[0]}
        metrics.update(self.g_step({k: v[-1] for k, v in batches.items()},
                                   generator, None if z is None else z[rows]))
        return metrics

    @torch.no_grad()
    def sample(self, noise: torch.Tensor) -> torch.Tensor:
        """G in eval mode on ``noise`` (N, noise_dim): NHWC images."""
        return self.G(torch.as_tensor(noise, device=self.device))
