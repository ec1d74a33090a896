"""DefectGAN training entry point, counterpart of
``de_i2i_gan_tpu/cli/train_defectgan.py``.

Usage mirrors the reference (defectGAN/train_defectgan.py):

    python -m de_i2i_gan_torch.cli.train_defectgan \
        --name exp --data_dir ./data --dataset_name codebrim \
        --image_size 128 --batch_size 4 --style_norm_block_type adain

Wiring (train_defectgan.py:49-117): train transforms (resize 1.5x ->
random-resized-crop -> flips -> color jitter -> normalize), dual-stream
{defects, background} loaders with the background stream infinite,
iters_per_epoch from the defect loader, the trainer. Runs on CUDA device 0;
``--gpu_ids -1`` runs on the CPU. ``--continue_training`` resumes from
``<ckpt_dir>/<name>/latest_state.pt`` and ``iter.txt``;
``--load_model_name`` warm-starts from another run's checkpoint.
``--dataset_name synthetic`` trains on the procedural dataset (no files).
``--native_loader`` feeds u8 super-batches from the C++ runtime
(``runtime/native_loader.py``, built with g++ at first use) over a cache of
the untransformed images under ``--native_cache_dir``, by default
``<ckpt_dir>/native_cache/<name>``. ``--val_metrics fid is lpips`` evaluates
the generator on the validation split every ``--save_ckpt_freq`` epochs
(``metrics/evaluator.py``, nets drawn from a seed, so the numbers mean
nothing) into ``<ckpt_dir>/<name>/val_metrics_<epoch>.json``.

Data parallel (``parallel/``): ``--num_devices N`` or ``--gpu_ids a,b``
spawn one process a device (``--gpu_ids -1 --num_devices N``: N CPU ranks
over gloo), each a rank that trains on its shard of the data with its share
of ``--batch_size``; ``--data_parallel on`` insists, ``off`` refuses, and
``auto`` spreads when more than one device is visible and the batch divides
them. Under ``torchrun`` each process is one rank.
"""
from __future__ import annotations

import sys
from pathlib import Path


def build_datasets(opt, phase: str, transform):
    from de_i2i_gan_torch.data.datasets import find_dataset_using_name
    cls = find_dataset_using_name(opt.dataset_name)
    kw = {}
    if opt.dataset_name == "synthetic":
        return {
            dt: cls(image_size=opt.image_size, label_nc=opt.label_nc,
                    length=512 if phase == "train" else 64, data_type=dt,
                    seed=opt.seed)
            for dt in ("defects", "background")
        }, "bce"
    if opt.dataset_name in ("mtvec", "mvtec"):
        kw["dataset_data_type"] = opt.dataset_data_type
    datasets = {
        dt: cls(opt.data_dir, opt.dataset_name, phase, dt,
                transform=transform, seed=opt.seed, **kw)
        for dt in ("defects", "background")
    }
    return datasets, cls.clf_loss_type


def make_val_fn(opt, cfg, device):
    """The in-training validation (the reference's defectgan_trainer.py:
    124-136, ``_val_epoch``): FID / IS / LPIPS of the generator over the
    validation split, written to ``val_metrics_<epoch>.json``."""
    import json

    import torch

    from de_i2i_gan_torch.data.pipeline import DataLoader, InfiniteLoader
    from de_i2i_gan_torch.data.transforms import EvalTransform
    from de_i2i_gan_torch.metrics.evaluator import (
        Evaluator, defectgan_generator_fn)

    val_sets, _ = build_datasets(opt, "val", EvalTransform(opt.image_size))
    val_df = DataLoader(val_sets["defects"], opt.batch_size, seed=opt.seed)
    val_bg = InfiniteLoader(DataLoader(val_sets["background"], opt.batch_size,
                                       seed=opt.seed + 1))
    ev = Evaluator(dims=opt.dims, device=device)
    gen = torch.Generator(device).manual_seed(opt.seed)

    def val_fn(steps, epoch):
        out = ev.evaluate_generator(
            defectgan_generator_fn(steps, cfg, gen), val_bg, val_df,
            num_imgs=opt.num_imgs,
            npz_path=Path(opt.npz_path) if opt.npz_path else None,
            metrics=tuple(opt.val_metrics),
            num_lpips_images=opt.num_lpips_images)
        path = Path(opt.ckpt_dir) / opt.name / f"val_metrics_{epoch}.json"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(out))
        print({k: round(v, 4) for k, v in out.items()}, f"at epoch {epoch}")
        return out
    return val_fn


def main(argv=None):
    """Train; returns the trainer (over spawned ranks: each rank's
    ``parallel/mesh.py::state_digest``)."""
    from de_i2i_gan_torch.config.options import parse_for_ranks
    from de_i2i_gan_torch.parallel.mesh import mesh_from_flag, run

    opt = parse_for_ranks("defectgan_train", argv)
    mesh = mesh_from_flag(opt.data_parallel, opt.batch_size, opt.gpu_ids,
                          opt.num_devices)
    return run(train, mesh, opt)


def train(opt, mesh=None):
    """The run of ``opt`` on this process's device: every rank of ``mesh``
    trains on its shard of the data (``shard_for_process``), feeding its
    share of ``--batch_size``; the native feed caches each rank's shard
    under ``proc<rank>``."""
    from de_i2i_gan_torch.config.options import (
        device_of, to_defectgan_config, to_train_config)
    from de_i2i_gan_torch.data.datasets import shard_for_process
    from de_i2i_gan_torch.data.pipeline import DataLoader, DualStreamLoader
    from de_i2i_gan_torch.data.transforms import TrainTransform
    from de_i2i_gan_torch.parallel import distributed
    from de_i2i_gan_torch.train.trainer import DefectGanTrainer
    from de_i2i_gan_torch.utils.seed import fix_rand_seed

    fix_rand_seed(opt.seed)
    if mesh is not None and distributed.is_primary():
        print(f"data-parallel over {distributed.world_size()} devices")
    batch = opt.batch_size // distributed.local_ranks()  # this rank's rows
    transform = TrainTransform(opt.image_size)
    datasets, clf_loss_type = build_datasets(opt, "train", transform)
    if distributed.world_size() > 1:
        datasets = {k: shard_for_process(v) for k, v in datasets.items()}
    cfg = to_defectgan_config(opt)
    tcfg = to_train_config(opt, clf_loss_type)

    if opt.native_loader:
        from de_i2i_gan_torch.runtime.native_loader import make_native_dual_stream
        # cache the untransformed images; the C++ side owns crop, flips and
        # jitter and fills contiguous u8 super-batches in place
        raw, _ = build_datasets(opt, "train", None)
        root = Path(opt.native_cache_dir or (
            Path(opt.ckpt_dir) / "native_cache" / opt.name))
        if distributed.world_size() > 1:
            # each rank caches its own shard, in a directory of its own
            raw = {k: shard_for_process(v) for k, v in raw.items()}
            root = root / f"proc{distributed.rank()}"
        loader = make_native_dual_stream(
            raw["defects"], raw["background"], root, opt.image_size,
            batch, tcfg.num_critics, seed=opt.seed)
    else:
        df_loader = DataLoader(datasets["defects"], batch, seed=opt.seed)
        bg_loader = DataLoader(datasets["background"], batch,
                               seed=opt.seed + 1)
        loader = DualStreamLoader(df_loader, bg_loader, tcfg.num_critics)
    print(f"{len(datasets['defects'])} defect / "
          f"{len(datasets['background'])} background train images")

    embed_bank = None
    if cfg.style_norm_block_type == "sean" and opt.embed_path is not None \
            and cfg.sean_alpha != 0:
        from de_i2i_gan_torch.data.embeddings import EmbeddingBank
        p = str(opt.embed_path)
        embed_bank = (EmbeddingBank.load(opt.embed_path) if p.endswith(".npz")
                      else EmbeddingBank.from_torch_file(opt.embed_path,
                                                         cfg.label_nc))

    trainer = DefectGanTrainer(
        cfg, tcfg, name=opt.name, ckpt_dir=opt.ckpt_dir, log_dir=opt.log_dir,
        iters_per_epoch=len(loader) * tcfg.num_critics,
        num_epochs=opt.num_epochs,
        continue_training=opt.continue_training,
        load_model_name=opt.load_model_name, which_epoch=opt.which_epoch,
        save_latest_freq=opt.save_latest_freq,
        save_ckpt_freq=opt.save_ckpt_freq, seed=opt.seed,
        embed_bank=embed_bank,
        device=device_of(opt) if mesh is None else distributed.device(),
        mesh=mesh)
    val_fn = (make_val_fn(opt, cfg, trainer.steps.device)
              if opt.val_metrics and distributed.is_primary() else None)
    trainer.train(loader, val_fn=val_fn)
    if opt.native_loader:
        loader.close()  # every epoch has drained it: no thread is inside
    return trainer


if __name__ == "__main__":
    main(sys.argv[1:])
