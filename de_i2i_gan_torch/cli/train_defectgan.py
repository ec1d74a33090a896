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
``<ckpt_dir>/native_cache/<name>``.
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


def main(argv=None):
    """Train; returns the trainer."""
    from de_i2i_gan_torch.config.options import (
        Options, check_ported, device_of, to_defectgan_config, to_train_config)
    from de_i2i_gan_torch.data.pipeline import DataLoader, DualStreamLoader
    from de_i2i_gan_torch.data.transforms import TrainTransform
    from de_i2i_gan_torch.train.trainer import DefectGanTrainer
    from de_i2i_gan_torch.utils.seed import fix_rand_seed

    opt = Options("defectgan_train").parse(argv)
    check_ported(opt)
    fix_rand_seed(opt.seed)
    transform = TrainTransform(opt.image_size)
    datasets, clf_loss_type = build_datasets(opt, "train", transform)
    cfg = to_defectgan_config(opt)
    tcfg = to_train_config(opt, clf_loss_type)

    if opt.native_loader:
        from de_i2i_gan_torch.runtime.native_loader import make_native_dual_stream
        # cache the untransformed images; the C++ side owns crop, flips and
        # jitter and fills contiguous u8 super-batches in place
        raw, _ = build_datasets(opt, "train", None)
        root = opt.native_cache_dir or (
            Path(opt.ckpt_dir) / "native_cache" / opt.name)
        loader = make_native_dual_stream(
            raw["defects"], raw["background"], root, opt.image_size,
            opt.batch_size, tcfg.num_critics, seed=opt.seed)
    else:
        df_loader = DataLoader(datasets["defects"], opt.batch_size,
                               seed=opt.seed)
        bg_loader = DataLoader(datasets["background"], opt.batch_size,
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
        embed_bank=embed_bank, device=device_of(opt))
    trainer.train(loader)
    if opt.native_loader:
        loader.close()  # every epoch has drained it: no thread is inside
    return trainer


if __name__ == "__main__":
    main(sys.argv[1:])
