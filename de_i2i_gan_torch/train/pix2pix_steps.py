"""Paired image-to-image training with a multi-scale discriminator and a
feature-matching loss (pix2pixHD-style), counterpart of
``de_i2i_gan_tpu/train/pix2pix_steps.py``.

  * generator: the DefectGAN encoder-decoder with SPADE and
    ``cycle_gan=True`` (the raw tanh foreground is the translation); the
    labels are a constant one-hot of class 0
  * discriminator: N PatchGANs over an average-pool pyramid (1, 1/2, 1/4,
    ...), each returning its intermediate features; instance norm only, so
    real and fake pairs share one forward exactly
  * losses: LSGAN or hinge adversarial + lambda_L1 * L1 + lambda_FM *
    multi-scale feature matching

``train_step`` is the pix2pix schedule: the fake is made once in train
mode; D is updated on it detached; G's gradient comes from the same fake
against the updated D (two D forwards of 2B pairs, one G forward, one G
backward). ``fused_train_step`` (FusedProp, arxiv 2004.03335) takes both
gradients from the nets before the update: one G forward and one D forward
of the 2B pairs with the fake attached, then D's gradient from the D term
and G's from the G term, each by its own ``torch.autograd.grad`` (the JAX
package writes two D forwards that XLA merges into one; one forward with
two partial backwards is the same arithmetic). ``super_step`` runs
``train_step`` over the leading ``iters_per_launch`` axis of a batch.

The modules hold the state and the steps update it in place; ``step``
counts iterations. ``cfg.remat`` recomputes G's train-mode forwards in the
backward pass (``train/remat.py``). Noise injection draws from the
``generator`` a call is given.
"""
from __future__ import annotations

import copy
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from de_i2i_gan_torch.config import DefectGanConfig, TrainConfig
from de_i2i_gan_torch.losses.common import l1
from de_i2i_gan_torch.models.generator import DefectGanGenerator
from de_i2i_gan_torch.nn.blocks import ConvBlock
from de_i2i_gan_torch.nn.layers import avg_pool
from de_i2i_gan_torch.ops.fused import batch_images_to_float, images_to_float
from de_i2i_gan_torch.train.optim import ema_update, make_optimizer
from de_i2i_gan_torch.train.remat import remat

Batch = Dict[str, torch.Tensor]
Outs = List[Tuple[torch.Tensor, List[torch.Tensor]]]


def _conv_out(h: int, k: int, s: int, p: int) -> int:
    return (h + 2 * p - k) // s + 1


class PatchDiscriminatorFeatures(nn.Module):
    """70x70-ish PatchGAN that returns its per-layer features and logits.

    ``image_size`` is the input's height: the JAX module stops deepening
    below 2 px and falls back to a 1x1 head below 3 px (tiny test scales),
    which a torch module decides when it is built."""

    def __init__(self, in_features: int, ndf: int = 64, num_layers: int = 3,
                 image_size: int = 256, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stem = ConvBlock(in_features, ndf, (4, 4), (2, 2), 1,
                              act="leaky_relu", dtype=dtype)
        h = _conv_out(image_size, 4, 2, 1)
        crt = ndf
        self.num_blocks = 0
        for i in range(num_layers):
            if h < 2:
                break
            nxt = min(crt * 2, 512)
            stride = 2 if i < num_layers - 1 else 1
            setattr(self, f"layer_{i}",
                    ConvBlock(crt, nxt, (4, 4), (stride, stride), 1,
                              norm="instance", act="leaky_relu", dtype=dtype))
            h = _conv_out(h, 4, stride, 1)
            crt = nxt
            self.num_blocks += 1
        if h >= 3:
            self.head = ConvBlock(crt, 1, (4, 4), (1, 1), 1, dtype=dtype)
        else:
            self.head = ConvBlock(crt, 1, (1, 1), dtype=dtype)

    def forward(self, x: torch.Tensor):
        """x: NCHW. Returns (logits, [features]), NCHW."""
        h = self.stem(x)
        feats = [h]
        for i in range(self.num_blocks):
            h = getattr(self, f"layer_{i}")(h)
            feats.append(h)
        return self.head(h), feats


class MultiScaleDiscriminator(nn.Module):
    """``num_scales`` PatchGANs over an average-pool pyramid (pix2pixHD)."""

    def __init__(self, num_scales: int = 2, ndf: int = 64, num_layers: int = 3,
                 image_size: int = 256, in_features: int = 6,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_scales = num_scales
        self.dtype = dtype
        for s in range(num_scales):
            setattr(self, f"scale_{s}", PatchDiscriminatorFeatures(
                in_features, ndf, num_layers, image_size // 2 ** s, dtype))

    def forward(self, x: torch.Tensor) -> Outs:
        """x: NHWC pairs (input | image on the channels). Returns one
        (logits, [features]) per scale, NHWC views, in the compute dtype."""
        x = x.permute(0, 3, 1, 2).to(self.dtype)
        outs = []
        for s in range(self.num_scales):
            logits, feats = getattr(self, f"scale_{s}")(x)
            outs.append((logits.permute(0, 2, 3, 1),
                         [f.permute(0, 2, 3, 1) for f in feats]))
            if s + 1 < self.num_scales:
                x = avg_pool(x, 2, 2)
        return outs


def gan_loss(logits: torch.Tensor, target_real: bool, kind: str,
             for_disc: bool) -> torch.Tensor:
    lf = logits.float()
    if kind == "lsgan":
        t = 1.0 if target_real else 0.0
        return (lf - t).square().mean()
    if kind == "hinge":
        if for_disc:
            return (F.relu(1.0 - lf) if target_real else F.relu(1.0 + lf)).mean()
        return -lf.mean()
    raise ValueError(kind)


def feature_matching(real_feats: List[List[torch.Tensor]],
                     fake_feats: List[List[torch.Tensor]]) -> torch.Tensor:
    total = 0.0
    n = 0
    for rf, ff in zip(real_feats, fake_feats):
        for r, f in zip(rf, ff):
            total = total + l1(f, r.detach())
            n += 1
    return total / max(n, 1)


class Pix2PixSteps:
    """Paired i2i: batch = {'input': x, 'target': y} (NHWC), or a u8
    ``pair`` of both on the channels. Holds G, D, ``ema_G`` (when
    ``tcfg.ema_decay > 0``) and the optimizers ``tx_G``, ``tx_D`` on
    ``device``."""

    E = None  # the checkpoint's and the NaN guard's net list has no E
    tx_E = None

    def __init__(self, cfg: DefectGanConfig, tcfg: TrainConfig,
                 num_d_scales: int = 2, gan_kind: str = "lsgan",
                 lambda_l1: float = 100.0, lambda_fm: float = 10.0,
                 iters_per_epoch: int = 1000, num_epochs: int = 100,
                 n_layers_d: int = 3, fused_prop: bool = False,
                 device: str | torch.device = "cuda"):
        self.cfg, self.tcfg = cfg, tcfg
        self.device = torch.device(device)
        self.gan_kind = gan_kind
        self.lambda_l1 = lambda_l1
        self.lambda_fm = lambda_fm
        self.fused_prop = fused_prop
        self.G = DefectGanGenerator(cfg).to(self.device).eval()
        self.D = MultiScaleDiscriminator(
            num_d_scales, cfg.ndf, n_layers_d, cfg.image_size,
            cfg.input_nc + cfg.output_nc, dtype=cfg.dtype).to(self.device)
        self.ema_G = copy.deepcopy(self.G) if tcfg.ema_decay > 0 else None
        sched = (iters_per_epoch, num_epochs)
        self.tx_G = make_optimizer(tcfg, self.G.parameters(), tcfg.lr_g, *sched)
        self.tx_D = make_optimizer(tcfg, self.D.parameters(), tcfg.lr_d, *sched)
        self.step = 0

    def _batch(self, batch) -> Batch:
        return batch_images_to_float(
            {k: torch.as_tensor(v, device=self.device) for k, v in batch.items()})

    def _labels(self, x: torch.Tensor) -> torch.Tensor:
        labels = torch.zeros((x.shape[0], self.cfg.label_nc), device=x.device)
        labels[:, 0] = 1.0
        return labels

    def _gen(self, x: torch.Tensor, generator: Optional[torch.Generator],
             train: bool, G: Optional[nn.Module] = None) -> torch.Tensor:
        """G's translation of x (NHWC). Train mode updates BatchNorm's
        statistics and spectral norm's u/v; with ``cfg.remat`` its
        activations are recomputed in the backward pass."""
        G = self.G if G is None else G
        G.train(train)
        try:
            if train and self.cfg.remat:
                out, _ = remat(G, x, self._labels(x), generator=generator)
            else:
                out, _ = G(x, self._labels(x), generator=generator)
        finally:
            G.eval()
        return out

    def _d_loss(self, outs: Outs, b: int) -> torch.Tensor:
        """Real pairs first, fakes second."""
        loss = 0.0
        for lg, _ in outs:
            loss = loss + 0.5 * (
                gan_loss(lg[:b], True, self.gan_kind, True) +
                gan_loss(lg[b:], False, self.gan_kind, True))
        return loss / len(outs)

    def _g_loss(self, outs: Outs, fake: torch.Tensor, y: torch.Tensor,
                fake_rows: slice, real_rows: slice):
        adv = sum(gan_loss(lg[fake_rows], True, self.gan_kind, False)
                  for lg, _ in outs) / len(outs)
        fm = feature_matching([[f[real_rows] for f in fs] for _, fs in outs],
                              [[f[fake_rows] for f in fs] for _, fs in outs])
        rec = l1(fake, y)
        loss = adv + self.lambda_l1 * rec + self.lambda_fm * fm
        return loss, {"adv": adv, "l1": rec, "fm": fm}

    def _g_grads(self, loss: torch.Tensor):
        """G's gradient of ``loss``; D gets none (the unused foreground
        head's is zero, as JAX's)."""
        return torch.autograd.grad(loss, self.tx_G.params, allow_unused=True,
                                   materialize_grads=True)

    def _step_g(self, grads) -> None:
        """G's update, then the EMA."""
        self.tx_G.step(grads)
        if self.ema_G is not None:
            ema_update(self.ema_G.parameters(), self.G.parameters(),
                       self.tcfg.ema_decay)
            self._sync_ema_state()

    def _sync_ema_state(self) -> None:
        """generate(use_ema=True) reads G's state (BatchNorm statistics,
        spectral u/v), as JAX does."""
        with torch.no_grad():
            for e, g in zip(self.ema_G.buffers(), self.G.buffers()):
                e.copy_(g)

    @staticmethod
    def _pairs(x, a, b):
        return torch.cat([torch.cat([x, a], dim=-1),
                          torch.cat([x, b], dim=-1)], dim=0)

    # ------------------------------------------------------------- steps
    def d_step(self, batch, generator: Optional[torch.Generator] = None
               ) -> Dict[str, torch.Tensor]:
        """One D update on fakes of G in eval mode."""
        batch = self._batch(batch)
        x, y = batch["input"], batch["target"]
        b = x.shape[0]
        with torch.no_grad():
            fake = self._gen(x, generator, train=False)
        loss = self._d_loss(self.D(self._pairs(x, y, fake)), b)
        self.tx_D.step(torch.autograd.grad(loss, self.tx_D.params))
        self.step += 1
        return {"d_loss": loss.detach()}

    def g_step(self, batch, generator: Optional[torch.Generator] = None
               ) -> Dict[str, torch.Tensor]:
        """One G update against the current D."""
        batch = self._batch(batch)
        x, y = batch["input"], batch["target"]
        b = x.shape[0]
        fake = self._gen(x, generator, train=True)
        outs = self.D(self._pairs(x, fake, y))
        loss, metrics = self._g_loss(outs, fake, y, slice(None, b),
                                     slice(b, None))
        self._step_g(self._g_grads(loss))
        return {k: v.detach() for k, v in metrics.items()}

    def train_step(self, batch, generator: Optional[torch.Generator] = None
                   ) -> Dict[str, torch.Tensor]:
        """One iteration: the fake made once; D's update on it detached;
        G's from the same fake against the updated D."""
        if self.fused_prop:
            return self.fused_train_step(batch, generator)
        batch = self._batch(batch)
        x, y = batch["input"], batch["target"]
        b = x.shape[0]
        fake = self._gen(x, generator, train=True)
        d_loss = self._d_loss(self.D(self._pairs(x, y, fake.detach())), b)
        self.tx_D.step(torch.autograd.grad(d_loss, self.tx_D.params))
        # D's weights moved in place: this forward sees the update
        outs = self.D(self._pairs(x, fake, y))
        loss, metrics = self._g_loss(outs, fake, y, slice(None, b),
                                     slice(b, None))
        self._step_g(self._g_grads(loss))
        self.step += 1
        return {"d_loss": d_loss.detach(),
                **{k: v.detach() for k, v in metrics.items()}}

    def fused_train_step(self, batch, generator: Optional[torch.Generator] = None
                         ) -> Dict[str, torch.Tensor]:
        """FusedProp: one G forward and one D forward of [real | fake] pairs;
        D's gradient from the D term, G's from the G term, both taken
        before either update (simultaneous-update semantics: G's gradient
        sees the D before its update)."""
        batch = self._batch(batch)
        x, y = batch["input"], batch["target"]
        b = x.shape[0]
        fake = self._gen(x, generator, train=True)
        outs = self.D(self._pairs(x, y, fake))
        loss_d = self._d_loss(outs, b)
        loss_g, metrics = self._g_loss(outs, fake, y, slice(b, None),
                                       slice(None, b))
        # the D term's gradient reaches D alone, the G term's G alone; both
        # before D's weights move in place under the shared forward
        d_grads = torch.autograd.grad(loss_d, self.tx_D.params,
                                      retain_graph=True)
        g_grads = self._g_grads(loss_g)
        self.tx_D.step(d_grads)
        self._step_g(g_grads)
        self.step += 1
        return {"d_loss": loss_d.detach(),
                **{k: v.detach() for k, v in metrics.items()}}

    def super_step(self, batches, generator: Optional[torch.Generator] = None
                   ) -> Dict[str, torch.Tensor]:
        """``train_step`` over each row of the leading (iters_per_launch,)
        axis of ``batches``; the metrics averaged over the rows."""
        batches = {k: torch.as_tensor(v, device=self.device)
                   for k, v in batches.items()}
        rows = next(iter(batches.values())).shape[0]
        ms = [self.train_step({k: v[i] for k, v in batches.items()}, generator)
              for i in range(rows)]
        return {k: torch.stack([m[k] for m in ms]).mean() for k in ms[0]}

    @torch.no_grad()
    def generate(self, x, use_ema: bool = True,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Folder inference: the EMA generator where there is one, in eval
        mode. x: NHWC images, u8 or [-1, 1]."""
        x = images_to_float(torch.as_tensor(x, device=self.device))
        G = self.ema_G if (use_ema and self.ema_G is not None) else self.G
        return self._gen(x, generator, train=False, G=G)
