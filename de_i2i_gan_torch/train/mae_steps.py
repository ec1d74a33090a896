"""MAE-GAN pretraining steps, counterpart of
``de_i2i_gan_tpu/train/mae_steps.py``.

The reference's masked-autoencoder GAN pretraining of the DefectGAN
generator (defectGAN/models/defectgan_model.py:106-171, 361-383 and
trainers/mae_trainer.py), with the JAX package's loss graph and schedule:
  * random shifted patch masks (utils/util.py:60-71) filled by a learnable
    ``MaskToken``; G reconstructs the image from them (``repair``)
  * G objective: D-fooling BCE + L1 reconstruction * w_rec + classifier
    * w_clf_g (mae_trainer.py:123-139); D in eval mode, not updated
  * D objective: the mean of BCE on [repaired | real] in one 2B call, +
    classifier-on-reals * w_clf_d (mae_trainer.py:149-158); the repair runs
    without gradients, G and E in eval mode
  * the mask token trains with G's optimizer (mae_trainer.py:28); the AdaIN
    style extractor E with its own, through the G loss
  * ``split_training`` trains only reconstruction / only the classifier
    (defectgan_model.py:119-120, 157-158)
  * ``super_step``: ``num_critics`` D updates, then one G update on the
    last sub-batch (the MAE default is one critic)

As ``DefectGanSteps``, the modules hold the state and the steps update it in
place; D and the optimizers are built at the first training call
(``init_training``). ``step`` counts D updates. The masks, E's latent noise
and the noise injection draw from the ``generator`` a call is given.
``cfg.remat`` is accepted and has no effect: the JAX ``MAESteps`` never
reads it, so the MAE forward keeps its activations in both packages.

A checkpoint (``train/checkpoint.py::train_state``) holds G as the bare
generator's ``state_dict`` and the token as an entry of its own,
``token``, so ``DefectGanTrainer(load_model_name=<MAE run>)`` restores every
generator tensor, and E and D, from it. The JAX package's MAE state nests G
under ``{"net", "token"}``, so its warm start restores none of G (ROADMAP
§C).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from de_i2i_gan_torch.config import DefectGanConfig, MAEConfig, TrainConfig
from de_i2i_gan_torch.losses.common import bce_logits, cal_loss, l1
from de_i2i_gan_torch.models.discriminator import DefectGanDiscriminator
from de_i2i_gan_torch.models.extractor import StyleExtractor
from de_i2i_gan_torch.models.generator import DefectGanGenerator
from de_i2i_gan_torch.nn.blocks import MaskToken
from de_i2i_gan_torch.ops.fused import batch_images_to_float
from de_i2i_gan_torch.train.optim import make_optimizer
from de_i2i_gan_torch.utils.masks import generate_shifted_mask

Batch = Dict[str, torch.Tensor]


class MAESteps:
    """Holds the generator ``G``, the mask token ``token`` and the AdaIN
    style extractor ``E`` (or None) on ``device``; after the first training
    call also the discriminator ``D`` and the optimizers ``tx_D``, ``tx_G``
    (G's parameters and the token's) and ``tx_E``."""

    # the nets a checkpoint holds (train/checkpoint.py::train_state)
    STATE_NETS = ("G", "token", "E", "D")

    def __init__(self, cfg: DefectGanConfig, mcfg: MAEConfig,
                 tcfg: TrainConfig, device: str | torch.device = "cuda",
                 iters_per_epoch: int = 1000, num_epochs: int = 200):
        # MAE loss weights [rec, clf_d, clf_g] (defectgan_options.py:174-175)
        if len(tcfg.loss_weight) != 3:
            raise ValueError("MAE loss_weight must have 3 entries")
        self.cfg, self.mcfg, self.tcfg = cfg, mcfg, tcfg
        self.w_rec, self.w_clf_d, self.w_clf_g = tcfg.loss_weight
        self.device = torch.device(device)
        self.iters_per_epoch, self.num_epochs = iters_per_epoch, num_epochs
        self.G = DefectGanGenerator(cfg).to(self.device).eval()
        self.token = MaskToken(mcfg.mask_token_type, mcfg.mask_ratio,
                               cfg.input_nc, cfg.image_size).to(self.device)
        self.E = (StyleExtractor(cfg).to(self.device).eval()
                  if cfg.style_norm_block_type == "adain" else None)
        self.ema_G = None
        self.D = None
        self.tx_D = self.tx_G = self.tx_E = None
        self.step = 0  # D updates

    def init_training(self) -> None:
        """Build D and the optimizers; a no-op once they exist."""
        if self.D is not None:
            return
        cfg, tcfg = self.cfg, self.tcfg
        self.D = DefectGanDiscriminator(cfg).to(self.device).eval()
        sched = (self.iters_per_epoch, self.num_epochs)
        self.tx_D = make_optimizer(tcfg, self.D.parameters(), tcfg.lr_d, *sched)
        self.tx_G = make_optimizer(
            tcfg, [*self.G.parameters(), *self.token.parameters()], tcfg.lr_g,
            *sched, update_every=tcfg.num_critics)
        if self.E is not None:
            self.tx_E = make_optimizer(tcfg, self.E.parameters(), tcfg.lr_g,
                                       *sched, update_every=tcfg.num_critics)

    def _batch(self, batch) -> Batch:
        return batch_images_to_float(
            {k: torch.as_tensor(v, device=self.device) for k, v in batch.items()})

    # --------------------------------------------------------------- repair
    def _style_feat(self, batch: Batch, generator: Optional[torch.Generator]):
        """The decoder's style input: none for SPADE, the batch's
        ``embeds`` for SEAN, E's code of the images for AdaIN."""
        st = self.cfg.style_norm_block_type
        if st == "spade":
            return None
        if st == "sean":
            return batch.get("embeds")
        return self.E(batch["imgs"], batch["labels"], generator=generator)

    def repair(self, imgs: torch.Tensor, labels: torch.Tensor,
               style_feat: Optional[torch.Tensor], *, train: bool,
               mask: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Mask -> token fill -> generator reconstruction
        (defectgan_model.py:361-383), G in train mode when ``train``.
        Returns the NHWC reconstruction and the (N, H, W, 1) mask."""
        b, h, w, _ = imgs.shape
        if mask is None:
            mask = generate_shifted_mask(b, h, w, self.mcfg.patch_size,
                                         self.mcfg.mask_ratio, generator,
                                         imgs.device)
        masked = self.token(imgs, mask)
        self.G.train(train)
        try:
            pred, _ = self.G(masked, labels, style_feat, generator=generator)
        finally:
            self.G.eval()
        return pred, mask

    # ---------------------------------------------------------------- steps
    def g_loss(self, batch: Batch, generator: Optional[torch.Generator] = None
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The JAX ``g_loss_fn``: (loss, {rec, gan_G, clf_G}) with the graph
        of G, the token and E; the frozen D in eval mode."""
        imgs, labels = batch["imgs"], batch["labels"]
        feat = self._style_feat(batch, generator)
        pred, _ = self.repair(imgs, labels, feat, train=True,
                              generator=generator)
        rec = l1(pred, imgs)
        if self.mcfg.split_training:
            gan = clf = torch.zeros((), device=self.device)
        else:
            src, cls = self.D(pred)
            gan = bce_logits(src, torch.ones_like(src))
            clf = cal_loss(cls, labels, self.tcfg.clf_loss_type)
        loss = gan + rec * self.w_rec + clf * self.w_clf_g
        return loss, {"rec": rec, "gan_G": gan, "clf_G": clf}

    def d_loss(self, batch: Batch, generator: Optional[torch.Generator] = None
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The JAX ``d_loss_fn``: (loss, {gan_D, clf_D}) with D's graph, D in
        train mode; the repair without gradients, G and E in eval mode."""
        imgs, labels = batch["imgs"], batch["labels"]
        self.D.train()
        try:
            if self.mcfg.split_training:
                _, cls = self.D(imgs)
                clf = cal_loss(cls, labels, self.tcfg.clf_loss_type)
                return clf * self.w_clf_d, {
                    "gan_D": torch.zeros((), device=self.device), "clf_D": clf}
            with torch.no_grad():
                feat = self._style_feat(batch, generator)
                pred, _ = self.repair(imgs, labels, feat, train=False,
                                      generator=generator)
            src, cls = self.D(torch.cat([pred.to(imgs.dtype), imgs]))
        finally:
            self.D.eval()
        b = imgs.shape[0]
        fake_src, real_src = src[:b], src[b:]
        gan = (bce_logits(fake_src, torch.zeros_like(fake_src)) +
               bce_logits(real_src, torch.ones_like(real_src))) / 2.0
        clf = cal_loss(cls[b:], labels, self.tcfg.clf_loss_type)
        return gan + clf * self.w_clf_d, {"gan_D": gan, "clf_D": clf}

    def d_step(self, batch, generator: Optional[torch.Generator] = None
               ) -> Dict[str, torch.Tensor]:
        """One D update. batch: NHWC ``imgs`` (float or u8), (B, label_nc)
        ``labels``, and for SEAN (B, num_embeds, embed_nc) ``embeds``.
        Returns the loss terms as 0-d tensors."""
        self.init_training()
        loss, metrics = self.d_loss(self._batch(batch), generator)
        # split_training leaves D's source head out of the loss
        self.tx_D.step(torch.autograd.grad(loss, self.tx_D.params,
                                           allow_unused=True,
                                           materialize_grads=True))
        self.step += 1
        return {k: v.detach() for k, v in metrics.items()}

    def g_step(self, batch, generator: Optional[torch.Generator] = None
               ) -> Dict[str, torch.Tensor]:
        """One update of G and the token (``tx_G``) and of E (``tx_E``)
        against the frozen D. Returns the loss terms as 0-d tensors."""
        self.init_training()
        loss, metrics = self.g_loss(self._batch(batch), generator)
        params = self.tx_G.params + (self.tx_E.params if self.E is not None
                                     else [])
        grads = torch.autograd.grad(loss, params, allow_unused=True,
                                    materialize_grads=True)
        n_g = len(self.tx_G.params)
        self.tx_G.step(grads[:n_g])
        if self.E is not None:
            self.tx_E.step(grads[n_g:])
        return {k: v.detach() for k, v in metrics.items()}

    def super_step(self, batches, generator: Optional[torch.Generator] = None
                   ) -> Dict[str, torch.Tensor]:
        """``num_critics`` D updates, one per row of the leading axis of
        ``batches``, then one G update on the last row. Returns the D terms
        averaged over the critics and the G terms, as 0-d tensors."""
        batches = {k: torch.as_tensor(v, device=self.device)
                   for k, v in batches.items()}
        rows = next(iter(batches.values())).shape[0]
        d_metrics = [self.d_step({k: v[i] for k, v in batches.items()},
                                 generator) for i in range(rows)]
        metrics = {k: torch.stack([m[k] for m in d_metrics]).mean()
                   for k in d_metrics[0]}
        metrics.update(self.g_step({k: v[-1] for k, v in batches.items()},
                                   generator))
        return metrics

    # ----------------------------------------------------------- evaluation
    @torch.no_grad()
    def eval_losses(self, batch, generator: Optional[torch.Generator] = None
                    ) -> Dict[str, torch.Tensor]:
        """mae_inference (defectgan_model.py:131-147): {rec, gan, clf}
        without updates, every net in eval mode."""
        self.init_training()
        batch = self._batch(batch)
        imgs, labels = batch["imgs"], batch["labels"]
        feat = self._style_feat(batch, generator)
        pred, _ = self.repair(imgs, labels, feat, train=False,
                              generator=generator)
        src, cls = self.D(pred)
        return {"rec": l1(pred, imgs),
                "gan": bce_logits(src, torch.ones_like(src)),
                "clf": cal_loss(cls, labels, self.tcfg.clf_loss_type)}

    @torch.no_grad()
    def repair_grid(self, imgs, labels, generator: Optional[torch.Generator] = None,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """[orig | combined | masked | pred | pred-masked] panels
        (defectgan_model.py:346-359), a (B, 5, H, W, C) float32 stack. The
        decoder's style input is E's code for AdaIN and none otherwise, as
        in the JAX package."""
        imgs = torch.as_tensor(imgs, device=self.device)
        labels = torch.as_tensor(labels, device=self.device)
        feat = (self.E(imgs, labels, generator=generator)
                if self.E is not None else None)
        pred, masks = self.repair(imgs, labels, feat, train=False, mask=mask,
                                  generator=generator)
        pred = pred.float()
        masked = imgs * masks
        pred_masked = pred * (1 - masks)
        return torch.stack([imgs, masked + pred_masked, masked, pred,
                            pred_masked], dim=1)
