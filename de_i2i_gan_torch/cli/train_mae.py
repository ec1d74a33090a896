"""MAE-GAN pretraining entry point, counterpart of
``de_i2i_gan_tpu/cli/train_mae.py`` (reference: defectGAN/train_mae.py).

    python -m de_i2i_gan_torch.cli.train_mae --name mae_exp \
        --dataset_name synthetic --image_size 128 --mask_ratio 0.75 \
        --patch_size 8 --mask_token_type position

Trains on the fusion stream (background and defect images) with the MAE
defaults (batch 32, AdamW (0.9, 0.95), cosine schedule, lr 1.5e-4,
loss_weight [10, 3, 1], one critic). The run's checkpoint warm-starts
DefectGAN training: ``train_defectgan --load_model_name <name>``. Runs on
CUDA device 0; ``--gpu_ids -1`` runs on the CPU. ``--native_loader`` feeds
u8 super-batches from the C++ runtime over a cache of the untransformed
images under ``--native_cache_dir`` (default
``<ckpt_dir>/native_cache/<name>``), in ``fusion/``.
"""
from __future__ import annotations

import sys
from pathlib import Path


def main(argv=None):
    """Train; returns the trainer (over spawned ranks: each rank's
    ``parallel/mesh.py::state_digest``)."""
    from de_i2i_gan_torch.config.options import parse_for_ranks
    from de_i2i_gan_torch.parallel.mesh import mesh_from_flag, run

    opt = parse_for_ranks("mae_train", argv)
    mesh = mesh_from_flag(opt.data_parallel, opt.batch_size, opt.gpu_ids,
                          opt.num_devices)
    return run(train, mesh, opt)


def train(opt, mesh=None):
    """The run of ``opt`` on this process's device; every rank of ``mesh``
    on its shard of the fusion set with its share of ``--batch_size``."""
    from de_i2i_gan_torch.config.options import (
        device_of, to_defectgan_config, to_mae_config, to_train_config)
    from de_i2i_gan_torch.data.datasets import (
        find_dataset_using_name, shard_for_process)
    from de_i2i_gan_torch.data.pipeline import DataLoader, SuperBatchLoader
    from de_i2i_gan_torch.data.transforms import TrainTransform
    from de_i2i_gan_torch.parallel import distributed
    from de_i2i_gan_torch.train.trainer import MAETrainer
    from de_i2i_gan_torch.utils.seed import fix_rand_seed

    fix_rand_seed(opt.seed)
    batch = opt.batch_size // distributed.local_ranks()  # this rank's rows
    sharded = distributed.world_size() > 1
    cls = find_dataset_using_name(opt.dataset_name)
    kw = ({"dataset_data_type": opt.dataset_data_type}
          if opt.dataset_name in ("mtvec", "mvtec") else {})

    def fusion(transform):
        if opt.dataset_name == "synthetic":
            ds = cls(image_size=opt.image_size, label_nc=opt.label_nc,
                     length=512, data_type="fusion", seed=opt.seed)
        else:
            ds = cls(opt.data_dir, opt.dataset_name, "train", "fusion",
                     transform=transform, seed=opt.seed, **kw)
        return shard_for_process(ds) if sharded else ds

    clf_loss_type = ("bce" if opt.dataset_name == "synthetic"
                     else cls.clf_loss_type)
    cfg = to_defectgan_config(opt)
    mcfg = to_mae_config(opt)
    tcfg = to_train_config(opt, clf_loss_type)
    if opt.native_loader:
        from de_i2i_gan_torch.runtime.native_loader import make_native_super_batch
        # cache the untransformed images; the C++ side owns crop and flips
        root = Path(opt.native_cache_dir or (
            Path(opt.ckpt_dir) / "native_cache" / opt.name))
        if sharded:
            root = root / f"proc{distributed.rank()}"
        loader = make_native_super_batch(fusion(None), root / "fusion",
                                         opt.image_size, batch,
                                         tcfg.num_critics, seed=opt.seed)
    else:
        loader = SuperBatchLoader(
            DataLoader(fusion(TrainTransform(opt.image_size)), batch,
                       seed=opt.seed), tcfg.num_critics)

    trainer = MAETrainer(
        cfg, mcfg, tcfg, name=opt.name, ckpt_dir=opt.ckpt_dir,
        log_dir=opt.log_dir, iters_per_epoch=len(loader) * tcfg.num_critics,
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
