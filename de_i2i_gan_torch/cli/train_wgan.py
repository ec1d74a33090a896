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
    """Train; returns the trainer (over spawned ranks: each rank's
    ``parallel/mesh.py::state_digest``)."""
    from de_i2i_gan_torch.config.options import parse_for_ranks
    from de_i2i_gan_torch.parallel.mesh import mesh_from_flag, run

    opt = parse_for_ranks("wgan_train", argv)
    mesh = mesh_from_flag(opt.data_parallel, opt.batch_size, opt.gpu_ids,
                          opt.num_devices)
    return run(train, mesh, opt)


def train(opt, mesh=None):
    """The run of ``opt`` on this process's device; every rank of ``mesh``
    on its shard of the images with its share of ``--batch_size``."""
    from de_i2i_gan_torch.config.options import (
        device_of, to_train_config, to_wgan_config)
    from de_i2i_gan_torch.data.datasets import (
        find_dataset_using_name, shard_for_process)
    from de_i2i_gan_torch.data.pipeline import DataLoader, SuperBatchLoader
    from de_i2i_gan_torch.data.transforms import TrainTransform
    from de_i2i_gan_torch.parallel import distributed
    from de_i2i_gan_torch.train.trainer import WGanTrainer
    from de_i2i_gan_torch.utils.seed import fix_rand_seed

    fix_rand_seed(opt.seed)
    batch = opt.batch_size // distributed.local_ranks()  # this rank's rows
    sharded = distributed.world_size() > 1
    cls = find_dataset_using_name(opt.dataset_name)

    def dataset(transform):
        if opt.dataset_name == "synthetic":
            ds = cls(image_size=opt.image_size, label_nc=1, length=1024,
                     data_type="background", seed=opt.seed)
        else:
            ds = cls(opt.data_dir, opt.dataset_name, "train",
                     transform=transform, seed=opt.seed)
        return shard_for_process(ds) if sharded else ds

    cfg = to_wgan_config(opt)
    tcfg = to_train_config(opt)
    if opt.native_loader:
        from de_i2i_gan_torch.runtime.native_loader import make_native_super_batch
        # cache the untransformed images; the C++ side owns crop and flips
        root = Path(opt.native_cache_dir or (
            Path(opt.ckpt_dir) / "native_cache" / opt.name))
        if sharded:
            root = root / f"proc{distributed.rank()}"
        loader = make_native_super_batch(dataset(None), root / "train",
                                         opt.image_size, batch,
                                         cfg.num_critics, seed=opt.seed)
    else:
        loader = SuperBatchLoader(
            DataLoader(dataset(TrainTransform(opt.image_size)), batch,
                       seed=opt.seed), cfg.num_critics)

    trainer = WGanTrainer(
        cfg, tcfg, name=opt.name, ckpt_dir=opt.ckpt_dir, log_dir=opt.log_dir,
        iters_per_epoch=len(loader) * cfg.num_critics,
        num_epochs=opt.num_epochs, continue_training=opt.continue_training,
        save_latest_freq=opt.save_latest_freq,
        save_ckpt_freq=opt.save_ckpt_freq, seed=opt.seed,
        device=device_of(opt) if mesh is None else distributed.device(),
        mesh=mesh)
    trainer.train(loader)
    if opt.native_loader:
        loader.close()  # every epoch has drained it: no thread is inside
    return trainer


if __name__ == "__main__":
    main(sys.argv[1:])
