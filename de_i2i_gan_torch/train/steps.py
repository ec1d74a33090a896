"""DefectGAN steps, counterpart of ``de_i2i_gan_tpu/train/steps.py``.

Serving: ``DefectGanSteps.generate``, eval-mode generation. The decoder's
style input follows ``style_norm_block_type``: SPADE takes the labels
alone; AdaIN a style code, taken from the input images by E when none is
given; SEAN (N, num_embeds, embed_nc) style embeddings, or with
``inference_stats`` (N, hidden_nc) noise that samples its running
statistics.

Training: ``d_step``, ``g_step`` and ``super_step`` (``num_critics`` D
updates, then one G update on the last sub-batch), the JAX package's loss
graph and schedule:

  * D step: G in eval mode without gradients makes the fakes in one fused
    2B forward (``fused_g_forward``), then DiffAugment and one batched 4B D
    call in train mode over [fake_df | fake_nm | real_df | real_bg] (D has
    no normalization, so batching is exact);
  * G step: the double cycle normal->defect->normal and defect->normal->
    defect as two fused 2B hops in train mode, BatchNorm statistics kept
    per direction (``bn_groups=2``); the frozen D, in eval mode, on the
    augmented 2B fakes; the AdaIN style extractor E updated by its own
    optimizer. SEAN tracks its running statistics (``use_running_stats``)
    and adds its distillation terms to the loss (``style_distill``).

Only the step that updates a network runs it in train mode, so spectral
norm moves G's u/v in the G step alone and D's in the D step alone. A
SEAN training run finalizes its running statistics between epochs with
``update_per_epoch``.

JAX threads an immutable state through pure functions; here the modules
hold the state (parameters, BatchNorm running statistics, spectral u/v,
SEAN statistics) and the steps update it in place. ``step`` counts D
updates, as ``state.step`` does. Random draws (noise injection,
DiffAugment) come from the ``generator`` a call is given, or torch's
default generator of the device.

Each step runs in a span of ``utils/profiling.py`` (``train.super_step``,
``train.d_step``, ``train.g_step``), each backward pass in
``train.backward``; the optimizers' updates are ``optim.step``.

On a CUDA device, without a process group or ``remat``, ``super_step``
replays its body as one CUDA graph from the second call of its first
repeated batch shape on (``train/graphed.py``; other shapes run eagerly):
the same kernels in the same order, launched at once; the optimizers then
keep their step count and learning rate on the device (Adam's
``capturable``).

D and the three optimizers are built at the first training call
(``init_training``), so a ``DefectGanSteps`` that only serves holds G and E
alone. With ``remat`` the G step's G forwards keep no activations and run
again in the backward pass (``train/remat.py``), with the same state and
noise, as ``jax.checkpoint`` does.
"""
from __future__ import annotations

import copy
from typing import Dict, Optional

import torch

from de_i2i_gan_torch.config import DefectGanConfig, TrainConfig
from de_i2i_gan_torch.losses.common import bce_logits, cal_loss, l1
from de_i2i_gan_torch.models.discriminator import DefectGanDiscriminator
from de_i2i_gan_torch.models.extractor import StyleExtractor
from de_i2i_gan_torch.models.generator import DefectGanGenerator
from de_i2i_gan_torch.nn.normalization import sean_update_stats
from de_i2i_gan_torch.ops.fused import batch_images_to_float
from de_i2i_gan_torch.train import graphed
from de_i2i_gan_torch.train.optim import ema_update, make_optimizer
from de_i2i_gan_torch.train.remat import remat
from de_i2i_gan_torch.utils import profiling
from de_i2i_gan_torch.utils.diffaug import diff_augment
from de_i2i_gan_torch.utils.labels import normal_labels

Batch = Dict[str, torch.Tensor]


def _cat(a: Optional[torch.Tensor], b: Optional[torch.Tensor]):
    return None if a is None else torch.cat([a, b], dim=0)


class DefectGanSteps:
    """Holds the generator ``G``, the AdaIN style extractor ``E`` (or None)
    and the EMA generator ``ema_G`` (when ``tcfg.ema_decay > 0``) on
    ``device``; after the first training call also the discriminator ``D``
    and the optimizers ``tx_D``, ``tx_G``, ``tx_E``."""

    REINIT_NETS = ("G", "D")  # redrawn for a non-default --init_type
    dp_group = None  # the ranks' group (parallel/mesh.py::make_parallel_step)

    def __init__(self, cfg: DefectGanConfig,
                 tcfg: Optional[TrainConfig] = None,
                 device: str | torch.device = "cuda",
                 iters_per_epoch: int = 1000, num_epochs: int = 100):
        self.cfg = cfg
        self.tcfg = tcfg if tcfg is not None else TrainConfig()
        self.device = torch.device(device)
        self.iters_per_epoch = iters_per_epoch
        self.num_epochs = num_epochs
        self.G = DefectGanGenerator(cfg).to(self.device).eval()
        self.E = (StyleExtractor(cfg).to(self.device).eval()
                  if cfg.style_norm_block_type == "adain" else None)
        self.ema_G = (copy.deepcopy(self.G) if self.tcfg.ema_decay > 0
                      else None)
        self.D = None
        self.tx_D = self.tx_G = self.tx_E = None
        self.step = 0  # D updates
        self._graph = graphed.SuperStepGraph()

    # ------------------------------------------------------------- serving
    @torch.no_grad()
    def generate(self, data: torch.Tensor, labels: torch.Tensor,
                 style_feat: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None,
                 use_ema: bool = False, inference_stats: bool = False):
        """Eval-mode generation. data: NHWC float images in [-1, 1];
        labels: (N, label_nc) one-hot; returns NHWC (out, prob).
        ``generator`` drives E's latent noise and the noise injection."""
        data = torch.as_tensor(data, device=self.device)
        labels = torch.as_tensor(labels, device=self.device)
        if style_feat is not None:
            style_feat = torch.as_tensor(style_feat, device=self.device)
        G = self.ema_G if (use_ema and self.ema_G is not None) else self.G
        if (self.cfg.style_norm_block_type == "adain" and style_feat is None
                and self.E is not None):
            style_feat = self.E(data, labels, generator=generator)
        return G(data, labels, style_feat, inference_stats=inference_stats,
                 generator=generator)

    # ------------------------------------------------------------ training
    def init_training(self) -> None:
        """Build D and the optimizers; a no-op once they exist."""
        if self.D is not None:
            return
        cfg, tcfg = self.cfg, self.tcfg
        if len(tcfg.loss_weight) != 5:
            raise ValueError("loss_weight must have 5 entries")
        # D runs in train mode inside d_step only
        self.D = DefectGanDiscriminator(cfg).to(self.device).eval()
        sched = (self.iters_per_epoch, self.num_epochs)
        self.tx_D = make_optimizer(tcfg, self.D.parameters(), tcfg.lr_d, *sched)
        self.tx_G = make_optimizer(tcfg, self.G.parameters(), tcfg.lr_g, *sched,
                                   update_every=tcfg.num_critics)
        if self.E is not None:
            self.tx_E = make_optimizer(tcfg, self.E.parameters(), tcfg.lr_g,
                                       *sched, update_every=tcfg.num_critics)

    def _batch(self, batch) -> Batch:
        return batch_images_to_float(
            {k: torch.as_tensor(v, device=self.device) for k, v in batch.items()})

    def _style_feats(self, batch: Batch, nm_labels: torch.Tensor,
                     generator: Optional[torch.Generator]):
        """(nm_feat, df_feat): none for SPADE; the batch's ``nm_embeds`` and
        ``df_embeds`` for SEAN; AdaIN style codes of the real images."""
        st = self.cfg.style_norm_block_type
        if st == "spade":
            return None, None
        if st == "sean":
            return batch.get("nm_embeds"), batch.get("df_embeds")
        return (self.E(batch["bg"], nm_labels, generator=generator),
                self.E(batch["df"], batch["df_labels"], generator=generator))

    def d_step(self, batch, generator: Optional[torch.Generator] = None
               ) -> Dict[str, torch.Tensor]:
        """One D update. batch: NHWC ``bg``, ``df`` and (B, label_nc)
        ``df_labels`` (SEAN: also (B, num_embeds, embed_nc) ``nm_embeds``
        and ``df_embeds``). Returns the loss terms as 0-d tensors."""
        with profiling.span("train.d_step"):
            self.init_training()
            cfg, tcfg = self.cfg, self.tcfg
            batch = self._batch(batch)
            bg, df, df_labels = batch["bg"], batch["df"], batch["df_labels"]
            nm_labels = normal_labels(df_labels)
            b = bg.shape[0]

            # fakes from the frozen generator, in eval mode
            self.G.eval()
            with torch.no_grad():
                nm_feat, df_feat = self._style_feats(batch, nm_labels, generator)
                if cfg.fused_g_forward:
                    fakes, _ = self.G(torch.cat([bg, df]),
                                      torch.cat([df_labels, nm_labels]),
                                      _cat(df_feat, nm_feat), generator=generator)
                    fake_df, fake_nm = fakes[:b], fakes[b:]
                else:
                    fake_df, _ = self.G(bg, df_labels, df_feat,
                                        generator=generator)
                    fake_nm, _ = self.G(df, nm_labels, nm_feat,
                                        generator=generator)

            quad = diff_augment(torch.cat([fake_df, fake_nm, df, bg]),
                                tcfg.diff_aug, generator)
            self.D.train()
            src, cls = self.D(quad)
            self.D.eval()
            fd_src, fn_src, rd_src, rn_src = src.split(b)
            rd_cls, rn_cls = cls[2 * b:3 * b], cls[3 * b:]
            gan_loss = (bce_logits(fd_src, torch.zeros_like(fd_src)) +
                        bce_logits(fn_src, torch.zeros_like(fn_src)) +
                        bce_logits(rd_src, torch.ones_like(rd_src)) +
                        bce_logits(rn_src, torch.ones_like(rn_src))) / 4.0
            clf_loss = (cal_loss(rd_cls, df_labels, tcfg.clf_loss_type) +
                        cal_loss(rn_cls, nm_labels, tcfg.clf_loss_type)) / 2.0
            d_loss = gan_loss + clf_loss * tcfg.loss_weight[0]
            with profiling.span("train.backward"):
                grads = torch.autograd.grad(d_loss, self.tx_D.params)
            self.tx_D.step(grads)
            self.step += 1
            return {"gan_D": gan_loss.detach(), "clf_D": clf_loss.detach()}

    def g_step(self, batch, generator: Optional[torch.Generator] = None
               ) -> Dict[str, torch.Tensor]:
        """One G (and E) update against the frozen D. Returns the loss terms
        as 0-d tensors (SEAN with ``style_distill``: also the means of the
        distillation terms, ``distill_latent`` and ``distill_embed``)."""
        with profiling.span("train.g_step"):
            self.init_training()
            cfg, tcfg = self.cfg, self.tcfg
            _, w_clf_g, w_rec, w_sd_cyc, w_sd_con = tcfg.loss_weight
            batch = self._batch(batch)
            bg, df, df_labels = batch["bg"], batch["df"], batch["df_labels"]
            nm_labels = normal_labels(df_labels)
            b = bg.shape[0]

            sean = cfg.style_norm_block_type == "sean"
            distill = [] if sean and cfg.style_distill else None
            g_kw = dict(track_stats=sean and cfg.use_running_stats,
                        distill=distill, generator=generator)
            self.G.train()
            nm_feat, df_feat = self._style_feats(batch, nm_labels, generator)
            if cfg.fused_g_forward:
                # both directions of each hop in one 2B call; BatchNorm keeps
                # its statistics per direction (bn_groups=2)
                h1_out, h1_p = self._g_train(torch.cat([bg, df]),
                                             torch.cat([df_labels, nm_labels]),
                                             _cat(df_feat, nm_feat), bn_groups=2,
                                             **g_kw)
                fake_df, fake_nm = h1_out[:b], h1_out[b:]
                p_df, p_nm = h1_p[:b], h1_p[b:]
                h2_out, h2_p = self._g_train(h1_out,
                                             torch.cat([nm_labels, df_labels]),
                                             _cat(nm_feat, df_feat), bn_groups=2,
                                             **g_kw)
                rec_nm, rec_df = h2_out[:b], h2_out[b:]
                p_rec_df, p_rec_nm = h2_p[:b], h2_p[b:]
            else:
                fake_df, p_df = self._g_train(bg, df_labels, df_feat, **g_kw)
                rec_nm, p_rec_df = self._g_train(fake_df, nm_labels, nm_feat,
                                                 **g_kw)
                fake_nm, p_nm = self._g_train(df, nm_labels, nm_feat, **g_kw)
                rec_df, p_rec_nm = self._g_train(fake_nm, df_labels, df_feat,
                                                 **g_kw)
            self.G.eval()

            # the frozen D, in eval mode, on the augmented fakes (one batched 2B
            # call); only G and E receive gradients
            src, cls = self.D(diff_augment(torch.cat([fake_df, fake_nm]),
                                           tcfg.diff_aug, generator))
            fd_src, fn_src = src[:b], src[b:]
            fd_cls, fn_cls = cls[:b], cls[b:]
            gan_loss = (bce_logits(fd_src, torch.ones_like(fd_src)) +
                        bce_logits(fn_src, torch.ones_like(fn_src))) / 2.0
            clf_loss = (cal_loss(fd_cls, df_labels, tcfg.clf_loss_type) +
                        cal_loss(fn_cls, nm_labels, tcfg.clf_loss_type)) / 2.0
            rec_loss = (l1(rec_df, df) + l1(rec_nm, bg)) / 2.0
            if cfg.cycle_gan:
                sd_cyc = sd_con = torch.zeros((), device=self.device)
            else:
                sd_cyc = (l1(p_df, p_rec_df) + l1(p_nm, p_rec_nm)) / 2.0
                zero = torch.zeros_like(p_df)
                sd_con = (l1(p_df, zero) + l1(p_nm, zero) +
                          l1(p_rec_df, zero) + l1(p_rec_nm, zero)) / 4.0
            g_loss = (gan_loss + clf_loss * w_clf_g + rec_loss * w_rec +
                      sd_cyc * w_sd_cyc + sd_con * w_sd_con)
            metrics = {"gan_G": gan_loss, "clf_G": clf_loss, "rec": rec_loss,
                       "sd_cyc": sd_cyc, "sd_con": sd_con}
            if distill:
                # every SEAN layer's terms of every forward, as the reference
                # backpropagates each: 0.1 * latent + embed
                latent = torch.stack([t[0] for t in distill])
                embed = torch.stack([t[1] for t in distill])
                g_loss = g_loss + 0.1 * latent.sum() + embed.sum()
                metrics["distill_latent"] = latent.mean()
                metrics["distill_embed"] = embed.mean()

            params = self.tx_G.params + (self.tx_E.params if self.E is not None
                                         else [])
            with profiling.span("train.backward"):
                grads = torch.autograd.grad(g_loss, params, allow_unused=True,
                                            materialize_grads=True)
            n_g = len(self.tx_G.params)
            self.tx_G.step(grads[:n_g])
            if self.E is not None:
                self.tx_E.step(grads[n_g:])
            if self.ema_G is not None:
                ema_update(self.ema_G.parameters(), self.G.parameters(),
                           tcfg.ema_decay)
                self._sync_ema_state()
            return {k: v.detach() for k, v in metrics.items()}

    def _g_train(self, *args, **kw):
        """A train-mode G forward of the G step; with ``cfg.remat`` its
        activations are recomputed in the backward pass."""
        if self.cfg.remat:
            return remat(self.G, *args, **kw)
        return self.G(*args, **kw)

    def _sync_ema_state(self) -> None:
        """generate(use_ema=True) reads G's state (BatchNorm running
        statistics, spectral u/v, SEAN statistics), as JAX does."""
        with torch.no_grad():
            for e, g in zip(self.ema_G.buffers(), self.G.buffers()):
                e.copy_(g)

    def super_step(self, batches, generator: Optional[torch.Generator] = None
                   ) -> Dict[str, torch.Tensor]:
        """``num_critics`` D updates, one per row of the leading axis of
        ``batches``, then one G update on the last row. Returns the D terms
        averaged over the critics and the G terms, as 0-d tensors. Where
        ``train/graphed.py`` finds the call eligible, it replays this body
        as a CUDA graph captured on an earlier call of the same shapes."""
        with profiling.span("train.super_step"):
            batches = {k: torch.as_tensor(v, device=self.device)
                       for k, v in batches.items()}
            if graphed.eligible(self, generator):
                metrics = self._graph(self, batches, generator)
                if metrics is not None:
                    return metrics
            graphed.count_eager()
            return self._super_step(batches, generator)

    def graph_ready(self) -> bool:
        """What ``graphed.eligible`` asks of the steps besides the call: no
        ``remat`` (its rerun saves and restores G's state on the host,
        which a replay cannot repeat), and Adam or AdamW (whose
        ``capturable`` form reads its step and learning rate on the
        device)."""
        return (not self.cfg.remat
                and self.tcfg.optimizer in graphed.GRAPHED_OPTIMIZERS)

    def graph_optimizers(self):
        """The optimizers a super-step updates, by name."""
        return [(n, getattr(self, f"tx_{n}")) for n in ("D", "G", "E")
                if getattr(self, f"tx_{n}") is not None]

    def graph_scalars(self):
        """Host floats the body reads besides the learning rates: none."""
        return []

    def _super_step(self, batches: Batch,
                    generator: Optional[torch.Generator]
                    ) -> Dict[str, torch.Tensor]:
        """The super-step's body, eager: what a graph captures."""
        rows = next(iter(batches.values())).shape[0]
        d_metrics = [self.d_step({k: v[i] for k, v in batches.items()},
                                 generator) for i in range(rows)]
        metrics = {k: torch.stack([m[k] for m in d_metrics]).mean()
                   for k in d_metrics[0]}
        metrics.update(self.g_step({k: v[-1] for k, v in batches.items()},
                                   generator))
        return metrics

    def update_per_epoch(self) -> None:
        """Between epochs (JAX ``DefectGanTrainer._update_per_epoch``):
        finalize SEAN's running statistics when they are tracked."""
        cfg = self.cfg
        if cfg.style_norm_block_type == "sean" and cfg.use_running_stats:
            sean_update_stats(self.G, group=self.dp_group)
            if self.ema_G is not None:
                self._sync_ema_state()
