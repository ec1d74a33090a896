"""WGAN training entry point, counterpart of
``de_i2i_gan_tpu/cli/train_wgan.py`` (reference: defectGAN/train_wgan.py):

    python -m de_i2i_gan_torch.cli.train_wgan --name wgan_exp \
        --dataset_name synthetic --image_size 64 --batch_size 128

Weight clipping (``--clipping_limit``), ``--num_critics`` critic steps a G
step, RMSprop at 5e-5. ``--dataset_name synthetic`` trains on the
procedural backgrounds (no files). Runs on CUDA device 0; ``--gpu_ids -1``
runs on the CPU. ``--native_loader`` feeds u8 super-batches from the C++
runtime over a cache of the untransformed images under
``--native_cache_dir`` (default ``<ckpt_dir>/native_cache/<name>``, in
``train/``).
"""
from __future__ import annotations

import sys
from pathlib import Path


def main(argv=None):
    """Train; returns the trainer."""
    from de_i2i_gan_torch.config.options import (
        Options, check_ported, device_of, to_train_config, to_wgan_config)
    from de_i2i_gan_torch.data.datasets import find_dataset_using_name
    from de_i2i_gan_torch.data.pipeline import DataLoader, SuperBatchLoader
    from de_i2i_gan_torch.data.transforms import TrainTransform
    from de_i2i_gan_torch.train.trainer import WGanTrainer
    from de_i2i_gan_torch.utils.seed import fix_rand_seed

    opt = Options("wgan_train").parse(argv)
    check_ported(opt)
    fix_rand_seed(opt.seed)
    cls = find_dataset_using_name(opt.dataset_name)

    def dataset(transform):
        if opt.dataset_name == "synthetic":
            return cls(image_size=opt.image_size, label_nc=1, length=1024,
                       data_type="background", seed=opt.seed)
        return cls(opt.data_dir, opt.dataset_name, "train",
                   transform=transform, seed=opt.seed)

    cfg = to_wgan_config(opt)
    tcfg = to_train_config(opt)
    if opt.native_loader:
        from de_i2i_gan_torch.runtime.native_loader import make_native_super_batch
        # cache the untransformed images; the C++ side owns crop and flips
        root = opt.native_cache_dir or (
            Path(opt.ckpt_dir) / "native_cache" / opt.name)
        loader = make_native_super_batch(dataset(None), Path(root) / "train",
                                         opt.image_size, opt.batch_size,
                                         cfg.num_critics, seed=opt.seed)
    else:
        loader = SuperBatchLoader(
            DataLoader(dataset(TrainTransform(opt.image_size)), opt.batch_size,
                       seed=opt.seed), cfg.num_critics)

    trainer = WGanTrainer(cfg, tcfg, name=opt.name, ckpt_dir=opt.ckpt_dir,
                          log_dir=opt.log_dir,
                          iters_per_epoch=len(loader) * cfg.num_critics,
                          num_epochs=opt.num_epochs,
                          continue_training=opt.continue_training,
                          save_latest_freq=opt.save_latest_freq,
                          save_ckpt_freq=opt.save_ckpt_freq, seed=opt.seed,
                          device=device_of(opt))
    trainer.train(loader)
    if opt.native_loader:
        loader.close()  # every epoch has drained it: no thread is inside
    return trainer


if __name__ == "__main__":
    main(sys.argv[1:])
