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

``Pix2PixTrainer`` trains paired translation over ``Pix2PixSteps``: a
``super_step`` of ``iters_per_launch`` iterations a batch (``train_step``
when it is 1), the NaN guard, 'latest' every epoch and every
``save_latest_freq`` iterations, epoch checkpoints, and every
``save_img_freq`` epochs an input | fake | target panel of the first
batch's first 4 pairs by the EMA generator. ``WGanTrainer`` runs
``WGanSteps.super_step`` (``num_critics`` critic steps and one G step) and
writes a 4x4 grid of G's samples of a fixed noise every epoch. Images go to
TensorBoard when it is installed, and as PNGs (``utils/png.py``) into the
run's log directory.

Every trainer takes a ``mesh`` (``parallel/mesh.py``), as the JAX trainers
do: each process is then one rank of a group, feeds its own rows of the
per-host batch, and holds a replica of the state, broadcast from rank 0
after init or resume. Gradients, BatchNorm statistics and SEAN's running
styles are reduced over the ranks inside the steps
(``make_parallel_step``); the metrics of a drain are averaged over them in
one all-reduce before the NaN guard reads them, so every rank accepts or
rolls back together and the logged values are global-batch means. Each
rank's generator is seeded so that rank 0 draws what a single process
draws (``distributed.rank_seed``). Checkpoints, TensorBoard, PNGs, the
progress bar and validation run on rank 0, the others waiting at a
barrier; SEAN's running-style accumulators are summed onto rank 0 before
it writes.
"""
from __future__ import annotations

import math
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from de_i2i_gan_torch.config import (
    DefectGanConfig, MAEConfig, TrainConfig, WGanConfig)
from de_i2i_gan_torch.data.embeddings import attach_embeddings
from de_i2i_gan_torch.data.pipeline import DualStreamLoader, device_prefetch
from de_i2i_gan_torch.ops.fused import images_to_float
from de_i2i_gan_torch.parallel import distributed
from de_i2i_gan_torch.parallel.mesh import (
    make_parallel_step, reduce_metrics, replicate, sync_running_styles)
from de_i2i_gan_torch.train.checkpoint import (
    latest_exists, load_checkpoint, read_iter_record, save_checkpoint)
from de_i2i_gan_torch.train.jax_import import init_weights
from de_i2i_gan_torch.train.mae_steps import MAESteps
from de_i2i_gan_torch.train.pix2pix_steps import Pix2PixSteps
from de_i2i_gan_torch.train.steps import DefectGanSteps
from de_i2i_gan_torch.train.wgan_steps import WGanSteps
from de_i2i_gan_torch.utils.guards import NaNGuard, metrics_finite
from de_i2i_gan_torch.utils.png import write_png

DRAIN_EVERY = 4  # super-steps between metric fetches


class TBWriter:
    """Thin TensorBoard wrapper (SummaryWriter if available, else no-op);
    ``image`` also writes a PNG into ``log_dir``."""

    def __init__(self, log_dir: Optional[Path]):
        self._w = None
        self.log_dir = log_dir
        if log_dir is not None:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._w = SummaryWriter(str(log_dir))
            except ImportError:
                pass

    def scalars(self, tag, d, step):
        if self._w:
            self._w.add_scalars(tag, {k: float(v) for k, v in d.items()}, step)

    def image(self, tag: str, img_hwc: np.ndarray, step: int) -> None:
        """An (H, W, 3) image in [0, 1]: TensorBoard, and
        ``<log_dir>/<tag with / as _>_<step>.png``."""
        if self.log_dir is None:
            return
        if self._w:
            self._w.add_image(tag, img_hwc, step, dataformats="HWC")
        path = Path(self.log_dir) / f"{tag.replace('/', '_')}_{step}.png"
        path.parent.mkdir(parents=True, exist_ok=True)
        write_png(path, np.clip(img_hwc * 255.0, 0, 255).astype(np.uint8))

    def close(self):
        if self._w:
            self._w.close()


def _parallel(trainer, mesh, batch_size: int, seed: int) -> None:
    """A trainer's data-parallel wiring, after its steps are built and any
    checkpoint loaded: the group attached, rank 0's state on every rank,
    and the rank's generator."""
    trainer.mesh = mesh
    if mesh is not None:
        n_local = distributed.local_ranks()
        if batch_size % n_local:
            raise ValueError(f"per-host batch_size {batch_size} not divisible "
                             f"by {n_local} local mesh devices")
        make_parallel_step(trainer.steps)
        replicate(trainer.steps)
    trainer.generator = torch.Generator(trainer.steps.device).manual_seed(
        distributed.rank_seed(seed + 1))


def _save(trainer, tag, epoch: int, iters: int) -> None:
    """Rank 0 writes the checkpoint ``tag`` (every rank calls this)."""
    sync_running_styles(trainer.steps)
    if distributed.is_primary():
        save_checkpoint(trainer.ckpt_dir, trainer.name, tag, trainer.steps,
                        epoch=epoch, iters=iters)
    distributed.barrier()


def _primary_log_dir(log_dir: Optional[Path]) -> Optional[Path]:
    return log_dir if distributed.is_primary() else None


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
                 device: str | torch.device = "cuda", mesh=None):
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
        _parallel(self, mesh, tcfg.batch_size, seed)

    def _drain_metrics(self, sums, counts):
        """One host copy of the pending metrics; the guard reads them. The
        detection lags by up to the window, so the guard snapshots only
        when the whole window was clean, and otherwise rolls the steps
        back to the last good snapshot."""
        if not self._pending:
            return
        rows = _fetch(self._pending, self.mesh is not None)
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
    def train(self, train_loader: DualStreamLoader, val_fn=None,
              progress: bool = True):
        """Run the epochs; ``val_fn(steps, epoch)`` -> {metric: value} runs
        after each epoch checkpoint, its values logged under ``Metrics``."""
        writer = TBWriter(_primary_log_dir(self.log_dir))
        progress = progress and distributed.is_primary()
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
                    _save(self, "latest", epoch, self.iters)
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
                _save(self, epoch, epoch, self.iters)
                if val_fn is not None and distributed.is_primary():
                    writer.scalars("Metrics", val_fn(self.steps, epoch) or {},
                                   epoch)
                distributed.barrier()
            # SEAN's running statistics; the LR schedules read the counts
            self.steps.update_per_epoch()
        # final 'latest' so short runs (< save_latest_freq iters) still leave
        # a loadable checkpoint for the test CLI
        _save(self, "latest", self.num_epochs, self.iters)
        writer.close()
        return self.steps

    # -------------------------------------------------------------- sampling
    def generate_grid(self, bg_images: torch.Tensor, labels: torch.Tensor,
                      img_only: bool = False):
        return _generate_grid_impl(self, bg_images, labels, img_only)


def _fetch(pending: List[Dict[str, torch.Tensor]], reduce: bool = False
           ) -> List[Dict[str, float]]:
    """The pending metric dicts on the host, in one copy; with ``reduce``,
    averaged over the ranks first, in one all-reduce."""
    keys = list(pending[0])
    rows = [[m[k] for k in keys] for m in pending]
    stacked = reduce_metrics(rows) if reduce else torch.stack(
        [torch.stack([v.float() for v in r]) for r in rows])
    return [dict(zip(keys, r)) for r in stacked.cpu().tolist()]


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
                 seed: int = 123, device: str | torch.device = "cuda",
                 mesh=None):
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
        _parallel(self, mesh, tcfg.batch_size, seed)

    def train(self, fusion_loader, val_loader=None, progress: bool = True):
        writer = TBWriter(_primary_log_dir(self.log_dir))
        progress = progress and distributed.is_primary()
        try:
            from tqdm import tqdm
        except ImportError:
            tqdm = None
        nc = self.tcfg.num_critics
        for epoch in range(self.first_epoch, self.num_epochs + 1):
            sums, counts = defaultdict(float), defaultdict(int)
            pending: List[Dict[str, torch.Tensor]] = []

            def drain():
                for metrics in (_fetch(pending, self.mesh is not None)
                                if pending else []):
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
                    _save(self, "latest", epoch, self.iters)
            drain()
            writer.scalars("Losses/mae", {k: sums[k] / max(counts[k], 1)
                                          for k in sums}, epoch)
            if val_loader is not None and distributed.is_primary():
                vals = _fetch([self.steps.eval_losses(batch, self.generator)
                               for batch in val_loader])
                writer.scalars("Losses/mae_val",
                               {k: sum(v[k] for v in vals) / len(vals)
                                for k in vals[0]}, epoch)
            distributed.barrier()
            if epoch % self.save_ckpt_freq == 0:
                _save(self, epoch, epoch, self.iters)
        # final 'latest' so short runs (< save_latest_freq iters) still leave
        # a loadable warm-start checkpoint (--load_model_name)
        _save(self, "latest", self.num_epochs, self.iters)
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


def _tqdm():
    try:
        from tqdm import tqdm
    except ImportError:
        return None
    return tqdm


class Pix2PixTrainer:
    """Paired-i2i (pix2pix/pix2pixHD-style) loop over ``Pix2PixSteps``
    (JAX ``Pix2PixTrainer``): one ``super_step`` a batch of the loader's
    ``iters_per_launch`` iterations, metrics fetched every ``DRAIN_EVERY``
    batches where the NaN guard reads them, latest/epoch checkpoints,
    input | fake | target panels."""

    def __init__(self, cfg: DefectGanConfig, tcfg: TrainConfig, *,
                 name: str = "pix2pix_exp", ckpt_dir: Path = Path("./ckpt"),
                 log_dir: Optional[Path] = Path("./logs"),
                 num_d_scales: int = 2, n_layers_d: int = 3,
                 gan_kind: str = "lsgan", lambda_l1: float = 100.0,
                 lambda_fm: float = 10.0, iters_per_epoch: int = 1000,
                 num_epochs: int = 200, continue_training: bool = False,
                 save_latest_freq: int = 1000, save_ckpt_freq: int = 4,
                 save_img_freq: int = 4, seed: int = 123,
                 fused_prop: bool = False,
                 device: str | torch.device = "cuda", mesh=None):
        self.cfg, self.tcfg = cfg, tcfg
        self.name = name
        self.ckpt_dir = Path(ckpt_dir)
        self.log_dir = Path(log_dir) / name if log_dir else None
        self.save_latest_freq = save_latest_freq
        self.save_ckpt_freq = save_ckpt_freq
        self.save_img_freq = save_img_freq
        if num_epochs == -1:
            num_epochs = math.ceil(tcfg.num_iters / max(iters_per_epoch, 1))
        self.num_epochs = num_epochs
        self.steps = Pix2PixSteps(cfg, tcfg, num_d_scales=num_d_scales,
                                  gan_kind=gan_kind, lambda_l1=lambda_l1,
                                  lambda_fm=lambda_fm,
                                  iters_per_epoch=iters_per_epoch,
                                  num_epochs=num_epochs, n_layers_d=n_layers_d,
                                  fused_prop=fused_prop, device=device)
        init_weights(self.steps, seed)
        self._guard = NaNGuard()
        self._pending: List[Dict[str, torch.Tensor]] = []
        self.first_epoch, self.iters = 1, 0
        if continue_training and latest_exists(self.ckpt_dir, name):
            load_checkpoint(self.ckpt_dir, name, "latest", self.steps)
            self.first_epoch, self.iters = read_iter_record(self.ckpt_dir, name)
        _parallel(self, mesh, tcfg.batch_size, seed)

    _drain_metrics = DefectGanTrainer._drain_metrics

    @staticmethod
    def vis_batch(batch, ipl: int) -> Dict[str, torch.Tensor]:
        """The panels' pairs: the first 4 of a loader batch (its first
        iteration's), as [-1, 1] ``input`` and ``target``; a native
        ``pair`` batch is split."""
        vis = {k: images_to_float(v[0] if ipl > 1 else v)[:4]
               for k, v in batch.items()}
        if "pair" in vis:
            p = vis.pop("pair")
            vis["input"], vis["target"] = p[..., :3], p[..., 3:]
        return vis

    def panel(self, vis: Dict[str, torch.Tensor]) -> np.ndarray:
        """Rows of input | EMA fake | target, (4H, 3W, 3) in [-1, 1]."""
        fake = self.steps.generate(vis["input"], generator=self.generator)
        rows = torch.cat([vis["input"].float(), fake.float(),
                          vis["target"].float()], dim=2)
        return rows.reshape(-1, *rows.shape[2:]).cpu().numpy()

    def train(self, loader, val_loader=None, progress: bool = True):
        writer = TBWriter(_primary_log_dir(self.log_dir))
        tqdm = _tqdm() if progress and distributed.is_primary() else None
        ipl = getattr(loader, "iters_per_launch", 1)
        step_fn = self.steps.super_step if ipl > 1 else self.steps.train_step
        vis = None
        for epoch in range(self.first_epoch, self.num_epochs + 1):
            sums, counts = defaultdict(float), defaultdict(int)
            it = device_prefetch(loader, self.steps.device)
            bar = tqdm(it, total=len(loader), colour="MAGENTA",
                       desc=f"pix2pix [{epoch}/{self.num_epochs}]") \
                if tqdm else it
            for batch in bar:
                if vis is None:
                    vis = self.vis_batch(batch, ipl)
                self._pending.append(step_fn(batch, self.generator))
                self.iters += ipl
                if len(self._pending) >= DRAIN_EVERY:
                    self._drain_metrics(sums, counts)
                if tqdm and counts:
                    bar.set_postfix({k: f"{sums[k] / counts[k]:.4f}"
                                     for k in ("d_loss", "adv", "l1")
                                     if counts.get(k)})
                if self.iters % self.save_latest_freq < ipl:
                    _save(self, "latest", epoch, self.iters)
            self._drain_metrics(sums, counts)
            writer.scalars("Losses/pix2pix", {k: sums[k] / max(counts[k], 1)
                                              for k in sums}, epoch)
            if epoch % self.save_img_freq == 0 and vis is not None and \
                    distributed.is_primary():
                writer.image("Images/input_fake_target",
                             (self.panel(vis) + 1) / 2, epoch)
            _save(self, "latest", epoch, self.iters)
            if epoch % self.save_ckpt_freq == 0:
                _save(self, epoch, epoch, self.iters)
                if val_loader is not None and distributed.is_primary():
                    l1s = [(self.steps.generate(vb["input"]) - torch.as_tensor(
                        vb["target"], device=self.steps.device)).abs().mean()
                        for vb in val_loader]
                    writer.scalars("Metrics", {"val_l1": torch.stack(
                        l1s).mean().item()}, epoch)
                distributed.barrier()
        writer.close()
        return self.steps


class WGanTrainer:
    """WGAN loop (JAX ``WGanTrainer``; trainers/wgan_trainer.py): one
    ``WGanSteps.super_step`` a super-batch, metrics fetched every
    ``DRAIN_EVERY`` super-steps (no NaN guard, as in JAX), latest/epoch
    checkpoints, a 4x4 grid of G's samples of a fixed noise every epoch."""

    def __init__(self, cfg: WGanConfig, tcfg: TrainConfig, *,
                 name: str = "wgan_exp", ckpt_dir: Path = Path("./ckpt"),
                 log_dir: Optional[Path] = Path("./logs"),
                 iters_per_epoch: int = 1000, num_epochs: int = 120,
                 continue_training: bool = False,
                 save_latest_freq: int = 1000, save_ckpt_freq: int = 4,
                 seed: int = 123, device: str | torch.device = "cuda",
                 mesh=None):
        self.cfg, self.tcfg = cfg, tcfg
        self.name = name
        self.ckpt_dir = Path(ckpt_dir)
        self.log_dir = Path(log_dir) / name if log_dir else None
        self.save_latest_freq = save_latest_freq
        self.save_ckpt_freq = save_ckpt_freq
        self.num_epochs = num_epochs
        self.steps = WGanSteps(cfg, tcfg, iters_per_epoch, num_epochs,
                               device=device)
        init_weights(self.steps, seed)
        self.first_epoch, self.iters = 1, 0
        if continue_training and latest_exists(self.ckpt_dir, name):
            load_checkpoint(self.ckpt_dir, name, "latest", self.steps)
            self.first_epoch, self.iters = read_iter_record(self.ckpt_dir, name)
        _parallel(self, mesh, tcfg.batch_size, seed)
        self.fixed_noise = torch.randn(
            (16, cfg.noise_dim), generator=torch.Generator().manual_seed(seed + 2))

    def grid(self) -> np.ndarray:
        """G's samples of the fixed noise as a 4x4 grid, (4H, 4W, 3) in
        [-1, 1]."""
        sample = self.steps.sample(self.fixed_noise).float().cpu().numpy()
        h, w = sample.shape[1:3]
        return sample.reshape(4, 4, h, w, 3).transpose(0, 2, 1, 3, 4).reshape(
            4 * h, 4 * w, 3)

    def train(self, loader, progress: bool = True):
        writer = TBWriter(_primary_log_dir(self.log_dir))
        tqdm = _tqdm() if progress and distributed.is_primary() else None
        nc = self.cfg.num_critics
        for epoch in range(self.first_epoch, self.num_epochs + 1):
            sums, counts = defaultdict(float), defaultdict(int)
            pending: List[Dict[str, torch.Tensor]] = []

            def drain():
                for metrics in (_fetch(pending, self.mesh is not None)
                                if pending else []):
                    for k, v in metrics.items():
                        sums[k] += v
                        counts[k] += 1
                pending.clear()

            it = device_prefetch(loader, self.steps.device)
            bar = tqdm(it, total=len(loader), colour="MAGENTA",
                       desc=f"WGAN [{epoch}/{self.num_epochs}]") \
                if tqdm else it
            for super_batch in bar:
                pending.append(self.steps.super_step(super_batch,
                                                     self.generator))
                self.iters += nc
                if len(pending) >= DRAIN_EVERY:
                    drain()
                if self.iters % self.save_latest_freq < nc:
                    _save(self, "latest", epoch, self.iters)
            drain()
            writer.scalars("Losses/wgan", {k: sums[k] / max(counts[k], 1)
                                           for k in sums}, epoch)
            if distributed.is_primary():
                writer.image("Images/fixed_noise", (self.grid() + 1) / 2,
                             epoch)
            if epoch % self.save_ckpt_freq == 0:
                _save(self, epoch, epoch, self.iters)
        _save(self, "latest", self.num_epochs, self.iters)
        writer.close()
        return self.steps
