"""Paired image-to-image (pix2pix / pix2pixHD-style) training entry point,
counterpart of ``de_i2i_gan_tpu/cli/train_pix2pix.py``, with the public
pix2pix flags:

    python -m de_i2i_gan_torch.cli.train_pix2pix \
        --name edges2photos --dataroot ./datasets/edges2photos \
        --load_size 286 --crop_size 256 --lambda_L1 100 \
        --netG resnet --netD multiscale --gan_mode lsgan

``--dataroot synthetic`` (or none) trains on the procedural paired dataset
(no files). The trainer runs ``--iters_per_launch`` iterations a super-step
(the alternating G/D ``train_step``, or FusedProp with ``--fused_prop``)
with an EMA generator. Runs on CUDA device 0; ``--gpu_ids -1`` runs on the
CPU. ``--continue_training`` resumes from ``<ckpt_dir>/<name>/``.
``--native_loader`` caches the unaugmented pairs at their full size as
6-channel samples under ``--native_cache_dir`` (default
``<ckpt_dir>/native_cache/<name>``, in ``pairs/``) and streams u8 pairs
from the C++ runtime, which takes one random crop and flip for both halves.
"""
from __future__ import annotations

import sys
from pathlib import Path


class _Subset:
    """First-N view of a paired dataset (--max_dataset_size)."""

    def __init__(self, dataset, n: int):
        self.dataset = dataset
        self._n = min(n, len(dataset))

    def __len__(self):
        return self._n

    def __getitem__(self, index: int):
        return self.dataset[index]


def build_dataset(opt, phase: str):
    from de_i2i_gan_torch.data.paired import AlignedDataset, SyntheticPairedDataset
    cap = getattr(opt, "max_dataset_size", 0) or 0
    if opt.dataroot is None or str(opt.dataroot) == "synthetic":
        n = 512 if phase == "train" else 64
        return SyntheticPairedDataset(
            image_size=opt.crop_size,
            length=min(n, cap) if cap else n, seed=opt.seed)
    ds = AlignedDataset(opt.dataroot, phase, load_size=opt.load_size,
                        crop_size=opt.crop_size, flip=not opt.no_flip,
                        direction=opt.direction, seed=opt.seed)
    return _Subset(ds, cap) if cap else ds


def main(argv=None):
    """Train; returns the trainer (over spawned ranks: each rank's
    ``parallel/mesh.py::state_digest``)."""
    from de_i2i_gan_torch.config.options import parse_for_ranks
    from de_i2i_gan_torch.parallel.mesh import mesh_from_flag, run

    opt = parse_for_ranks("pix2pix_train", argv)
    mesh = mesh_from_flag(opt.data_parallel, opt.batch_size, opt.gpu_ids,
                          opt.num_devices)
    return run(train, mesh, opt)


def train(opt, mesh=None):
    """The run of ``opt`` on this process's device; every rank of ``mesh``
    on its shard of the pairs with its share of ``--batch_size``."""
    from de_i2i_gan_torch.config.options import (
        device_of, to_pix2pix_config, to_train_config)
    from de_i2i_gan_torch.data.datasets import shard_for_process
    from de_i2i_gan_torch.data.paired import PairedLoader
    from de_i2i_gan_torch.parallel import distributed
    from de_i2i_gan_torch.train.trainer import Pix2PixTrainer
    from de_i2i_gan_torch.utils.seed import fix_rand_seed

    fix_rand_seed(opt.seed)
    batch = opt.batch_size // distributed.local_ranks()  # this rank's rows
    sharded = distributed.world_size() > 1
    cfg = to_pix2pix_config(opt)
    tcfg = to_train_config(opt)
    ipl = max(opt.iters_per_launch, 1)
    dataset = build_dataset(opt, "train")
    if sharded:
        dataset = shard_for_process(dataset)
    num_d = opt.num_D if opt.netD == "multiscale" else 1
    if opt.native_loader:
        from de_i2i_gan_torch.runtime.native_loader import make_paired_native_loader
        # cache the unaugmented pairs at load_size; the C++ side owns the
        # shared random crop and flip (aug_mode=2). The --max_dataset_size
        # view stays, so the cache and the epoch honor the cap.
        raw = build_dataset(opt, "train")
        inner = getattr(raw, "dataset", raw)
        if hasattr(inner, "load_size"):  # file-backed: no host-side aug
            inner.load_size = opt.load_size
            inner.crop_size = opt.load_size
            inner.flip = False
        root = Path(opt.native_cache_dir or (
            Path(opt.ckpt_dir) / "native_cache" / opt.name))
        if sharded:
            raw = shard_for_process(raw)
            root = root / f"proc{distributed.rank()}"
        loader = make_paired_native_loader(
            raw, root / "pairs", opt.crop_size, batch,
            load_size=opt.load_size, seed=opt.seed, iters_per_launch=ipl)
    else:
        loader = PairedLoader(dataset, batch, seed=opt.seed,
                              iters_per_launch=ipl)
    print(f"{len(dataset)} paired train images")

    trainer = Pix2PixTrainer(
        cfg, tcfg, name=opt.name, ckpt_dir=opt.ckpt_dir, log_dir=opt.log_dir,
        num_d_scales=num_d, n_layers_d=opt.n_layers_D,
        gan_kind=opt.gan_mode, lambda_l1=opt.lambda_L1,
        lambda_fm=opt.lambda_feat, iters_per_epoch=len(loader) * ipl,
        num_epochs=opt.num_epochs, continue_training=opt.continue_training,
        save_latest_freq=opt.save_latest_freq,
        save_ckpt_freq=opt.save_ckpt_freq, save_img_freq=opt.save_img_freq,
        seed=opt.seed, fused_prop=opt.fused_prop,
        device=device_of(opt) if mesh is None else distributed.device(),
        mesh=mesh)
    trainer.train(loader)
    if opt.native_loader:
        loader.close()  # every epoch has drained it: no thread is inside
    return trainer


if __name__ == "__main__":
    main(sys.argv[1:])
