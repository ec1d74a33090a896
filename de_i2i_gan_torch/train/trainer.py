"""The DefectGAN epoch trainer, counterpart of
``de_i2i_gan_tpu/train/trainer.py::DefectGanTrainer``.

Mirrors the reference trainer surface (trainers/defectgan_trainer.py:19-188,
trainers/base_trainer.py:12-131): epoch loop, running-mean postfix logging,
'latest' checkpoints + iter.txt every ``save_latest_freq`` iterations, epoch
checkpoints every ``save_ckpt_freq`` epochs, TensorBoard scalars.

Each step of the loop is one ``DefectGanSteps.super_step`` (``num_critics``
iterations) on a super-batch that ``device_prefetch`` has already put on the
device. The step's metrics stay on the device and are fetched every 4
super-steps in one host copy, where the NaN guard reads them. Random draws
(noise injection, DiffAugment, SEAN's embedding picks) come from one
``torch.Generator`` on the device, seeded from ``seed + 1``.

``MAETrainer`` is the MAE-GAN pretraining loop (trainers/mae_trainer.py)
over ``MAESteps.super_step`` on single-stream ``{imgs, labels}``
super-batches, with the same checkpoints; its run warm-starts DefectGAN
through ``load_model_name``. Like the JAX MAE loop it has no NaN guard.
The JAX trainers' data-parallel mesh waits for ROADMAP A.9; the pix2pix and
WGAN trainers for A.5 and A.6.
"""
from __future__ import annotations

import math
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional

import torch

from de_i2i_gan_torch.config import DefectGanConfig, MAEConfig, TrainConfig
from de_i2i_gan_torch.data.embeddings import attach_embeddings
from de_i2i_gan_torch.data.pipeline import DualStreamLoader, device_prefetch
from de_i2i_gan_torch.train.checkpoint import (
    latest_exists, load_checkpoint, read_iter_record, save_checkpoint)
from de_i2i_gan_torch.train.jax_import import init_weights
from de_i2i_gan_torch.train.mae_steps import MAESteps
from de_i2i_gan_torch.train.steps import DefectGanSteps
from de_i2i_gan_torch.utils.guards import NaNGuard, metrics_finite

DRAIN_EVERY = 4  # super-steps between metric fetches


class TBWriter:
    """Thin TensorBoard wrapper (SummaryWriter if available, else no-op)."""

    def __init__(self, log_dir: Optional[Path]):
        self._w = None
        if log_dir is not None:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._w = SummaryWriter(str(log_dir))
            except ImportError:
                pass

    def scalars(self, tag, d, step):
        if self._w:
            self._w.add_scalars(tag, {k: float(v) for k, v in d.items()}, step)

    def close(self):
        if self._w:
            self._w.close()


class DefectGanTrainer:
    def __init__(self, cfg: DefectGanConfig, tcfg: TrainConfig, *,
                 name: str = "exp", ckpt_dir: Path = Path("./ckpt"),
                 log_dir: Optional[Path] = Path("./logs"),
                 iters_per_epoch: int = 1000, num_epochs: int = -1,
                 continue_training: bool = False,
                 load_model_name: Optional[str] = None,
                 which_epoch: str = "latest",
                 save_latest_freq: int = 1000, save_ckpt_freq: int = 4,
                 seed: int = 123, embed_bank=None,
                 device: str | torch.device = "cuda"):
        self.cfg, self.tcfg = cfg, tcfg
        # SEAN style-embedding bank (--embed_path, defectgan_model.py:43-45)
        self.embed_bank = embed_bank
        self._guard = NaNGuard()
        self._pending: List[Dict[str, torch.Tensor]] = []
        self.name = name
        self.ckpt_dir = Path(ckpt_dir)
        self.log_dir = Path(log_dir) / name if log_dir else None
        self.save_latest_freq = save_latest_freq
        self.save_ckpt_freq = save_ckpt_freq

        # epoch/iteration reconciliation (base_trainer.py:45-47)
        if num_epochs == -1:
            num_epochs = math.ceil(tcfg.num_iters / max(iters_per_epoch, 1))
        self.num_epochs = num_epochs

        self.steps = DefectGanSteps(cfg, tcfg, device, iters_per_epoch,
                                    num_epochs)
        self.steps.init_training()
        init_weights(self.steps, seed)
        self.first_epoch, self.iters = 1, 0
        if continue_training and latest_exists(self.ckpt_dir, name):
            load_checkpoint(self.ckpt_dir, name, "latest", self.steps)
            self.first_epoch, self.iters = read_iter_record(self.ckpt_dir, name)
        elif load_model_name is not None:
            # cross-variant warm start
            load_checkpoint(self.ckpt_dir, load_model_name, which_epoch,
                            self.steps, strict=False)
        self.generator = torch.Generator(self.steps.device).manual_seed(seed + 1)

    def _drain_metrics(self, sums, counts):
        """One host copy of the pending metrics; the guard reads them. The
        detection lags by up to the window, so the guard snapshots only
        when the whole window was clean, and otherwise rolls the steps
        back to the last good snapshot."""
        if not self._pending:
            return
        rows = _fetch(self._pending)
        self._pending = []
        bad = next((m for m in rows if not metrics_finite(m)), None)
        if bad is None:
            for metrics in rows:
                for k, v in metrics.items():
                    sums[k] += v
                    counts[k] += 1
            self._guard.update(self.steps, rows[-1])
        else:
            self._guard.update(self.steps, bad)

    # ------------------------------------------------------------------ train
    def train(self, train_loader: DualStreamLoader, progress: bool = True):
        writer = TBWriter(self.log_dir)
        try:
            from tqdm import tqdm
        except ImportError:
            tqdm = None
        nc = self.tcfg.num_critics
        sean_bank = (self.embed_bank is not None and
                     self.cfg.style_norm_block_type == "sean")
        for epoch in range(self.first_epoch, self.num_epochs + 1):
            sums, counts = defaultdict(float), defaultdict(int)
            it = device_prefetch(train_loader, self.steps.device)
            bar = tqdm(it, total=len(train_loader), colour="MAGENTA",
                       desc=f"Epoch [{epoch}/{self.num_epochs}]") \
                if (progress and tqdm) else it
            for super_batch in bar:
                if sean_bank:
                    super_batch = attach_embeddings(
                        super_batch, self.embed_bank, self.cfg.num_embeds,
                        self.generator)
                self._pending.append(self.steps.super_step(super_batch,
                                                           self.generator))
                self.iters += nc
                if len(self._pending) >= DRAIN_EVERY:
                    self._drain_metrics(sums, counts)
                if progress and tqdm and counts:
                    bar.set_postfix({k: f"{sums[k] / counts[k]:.4f}"
                                     for k in ("gan_D", "gan_G", "rec")
                                     if counts.get(k)})
                if self.iters % self.save_latest_freq < nc:
                    save_checkpoint(self.ckpt_dir, self.name, "latest",
                                    self.steps, epoch=epoch, iters=self.iters)
            self._drain_metrics(sums, counts)
            # per-epoch bookkeeping
            means = {k: sums[k] / max(counts[k], 1) for k in sums}
            writer.scalars("Losses/gan",
                           {k: v for k, v in means.items() if "gan" in k},
                           epoch)
            writer.scalars("Losses/aux",
                           {k: v for k, v in means.items() if "gan" not in k},
                           epoch)
            if epoch % self.save_ckpt_freq == 0:
                save_checkpoint(self.ckpt_dir, self.name, epoch, self.steps,
                                epoch=epoch, iters=self.iters)
            # SEAN's running statistics; the LR schedules read the counts
            self.steps.update_per_epoch()
        # final 'latest' so short runs (< save_latest_freq iters) still leave
        # a loadable checkpoint for the test CLI
        save_checkpoint(self.ckpt_dir, self.name, "latest", self.steps,
                        epoch=self.num_epochs, iters=self.iters)
        writer.close()
        return self.steps

    # -------------------------------------------------------------- sampling
    def generate_grid(self, bg_images: torch.Tensor, labels: torch.Tensor,
                      img_only: bool = False):
        return _generate_grid_impl(self, bg_images, labels, img_only)


def _fetch(pending: List[Dict[str, torch.Tensor]]) -> List[Dict[str, float]]:
    """The pending metric dicts on the host, in one copy."""
    keys = list(pending[0])
    rows = torch.stack([torch.stack([m[k].float() for k in keys])
                        for m in pending]).cpu().tolist()
    return [dict(zip(keys, r)) for r in rows]


class MAETrainer:
    """MAE-GAN pretraining loop (trainers/mae_trainer.py:13-158): the epoch
    loop over ``device_prefetch`` of ``{imgs, labels}`` super-batches, one
    ``MAESteps.super_step`` each (``num_critics`` D updates and one G
    update); 'latest' checkpoints + iter.txt every ``save_latest_freq``
    iterations, epoch checkpoints every ``save_ckpt_freq`` epochs, a final
    'latest'; validation losses over ``val_loader`` (dict batches) each
    epoch; TensorBoard scalars. Metrics are fetched every ``DRAIN_EVERY``
    super-steps in one host copy."""

    def __init__(self, cfg: DefectGanConfig, mcfg: MAEConfig,
                 tcfg: TrainConfig, *, name: str = "mae_exp",
                 ckpt_dir: Path = Path("./ckpt"),
                 log_dir: Optional[Path] = Path("./logs"),
                 iters_per_epoch: int = 1000, num_epochs: int = 200,
                 continue_training: bool = False,
                 save_latest_freq: int = 300, save_ckpt_freq: int = 4,
                 seed: int = 123, device: str | torch.device = "cuda"):
        self.cfg, self.mcfg, self.tcfg = cfg, mcfg, tcfg
        self.name = name
        self.ckpt_dir = Path(ckpt_dir)
        self.log_dir = Path(log_dir) / name if log_dir else None
        self.save_latest_freq = save_latest_freq
        self.save_ckpt_freq = save_ckpt_freq
        if num_epochs == -1:
            num_epochs = math.ceil(tcfg.num_iters / max(iters_per_epoch, 1))
        self.num_epochs = num_epochs
        self.steps = MAESteps(cfg, mcfg, tcfg, device=device,
                              iters_per_epoch=iters_per_epoch,
                              num_epochs=num_epochs)
        self.steps.init_training()
        init_weights(self.steps, seed)
        self.first_epoch, self.iters = 1, 0
        if continue_training and latest_exists(self.ckpt_dir, name):
            load_checkpoint(self.ckpt_dir, name, "latest", self.steps)
            self.first_epoch, self.iters = read_iter_record(self.ckpt_dir, name)
        self.generator = torch.Generator(self.steps.device).manual_seed(seed + 1)

    def train(self, fusion_loader, val_loader=None, progress: bool = True):
        writer = TBWriter(self.log_dir)
        try:
            from tqdm import tqdm
        except ImportError:
            tqdm = None
        nc = self.tcfg.num_critics
        for epoch in range(self.first_epoch, self.num_epochs + 1):
            sums, counts = defaultdict(float), defaultdict(int)
            pending: List[Dict[str, torch.Tensor]] = []

            def drain():
                for metrics in _fetch(pending) if pending else []:
                    for k, v in metrics.items():
                        sums[k] += v
                        counts[k] += 1
                pending.clear()

            it = device_prefetch(fusion_loader, self.steps.device)
            bar = tqdm(it, total=len(fusion_loader), colour="MAGENTA",
                       desc=f"MAE [{epoch}/{self.num_epochs}]") \
                if (progress and tqdm) else it
            for super_batch in bar:
                pending.append(self.steps.super_step(super_batch,
                                                     self.generator))
                self.iters += nc
                if len(pending) >= DRAIN_EVERY:
                    drain()
                if progress and tqdm and counts:
                    bar.set_postfix({k: f"{sums[k] / counts[k]:.4f}"
                                     for k in ("rec", "gan_D", "gan_G")
                                     if counts.get(k)})
                if self.iters % self.save_latest_freq < nc:
                    save_checkpoint(self.ckpt_dir, self.name, "latest",
                                    self.steps, epoch=epoch, iters=self.iters)
            drain()
            writer.scalars("Losses/mae", {k: sums[k] / max(counts[k], 1)
                                          for k in sums}, epoch)
            if val_loader is not None:
                vals = _fetch([self.steps.eval_losses(batch, self.generator)
                               for batch in val_loader])
                writer.scalars("Losses/mae_val",
                               {k: sum(v[k] for v in vals) / len(vals)
                                for k in vals[0]}, epoch)
            if epoch % self.save_ckpt_freq == 0:
                save_checkpoint(self.ckpt_dir, self.name, epoch, self.steps,
                                epoch=epoch, iters=self.iters)
        # final 'latest' so short runs (< save_latest_freq iters) still leave
        # a loadable warm-start checkpoint (--load_model_name)
        save_checkpoint(self.ckpt_dir, self.name, "latest", self.steps,
                        epoch=self.num_epochs, iters=self.iters)
        writer.close()
        return self.steps


def _generate_grid_impl(trainer, bg_images, labels, img_only):
    """Per-background translation panels (defectgan_model.py:316-344):
    returns (n_bg, n_labels, H, W, 3) generated images plus probability maps
    for heat-map rendering on the host."""
    n_bg = bg_images.shape[0]
    n_lbl = labels.shape[0]
    rep_imgs = torch.repeat_interleave(bg_images, n_lbl, dim=0)
    rep_lbls = labels.repeat(n_bg, 1)
    feat = None
    if trainer.cfg.style_norm_block_type == "sean":
        feat = torch.zeros((rep_imgs.shape[0], trainer.cfg.num_embeds,
                            trainer.cfg.embed_nc), device=rep_imgs.device)
    out, prob = trainer.steps.generate(rep_imgs, rep_lbls, feat,
                                       generator=trainer.generator)
    out = out.reshape(n_bg, n_lbl, *out.shape[1:])
    prob = prob.reshape(n_bg, n_lbl, *prob.shape[1:])
    return out, prob
