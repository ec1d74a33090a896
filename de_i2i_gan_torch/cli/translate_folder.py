"""Batched folder inference, counterpart of
``de_i2i_gan_tpu/cli/translate_folder.py`` (BASELINE.json config #5:
batched 1024x1024 folder inference with spatial sharding).

Loads a DefectGAN checkpoint, runs the generator over every ``.png``,
``.jpg`` and ``.jpeg`` of a folder (sorted) at ``--image_size`` (the
generator is fully convolutional) in batches of ``--batch_size``, the last
padded with zeros, and writes the translated images as PNGs under their
input names. The generator runs in eval mode, its noise from a generator
seeded 0. Runs on CUDA device 0; ``--gpu_ids -1`` runs on the CPU.

    python -m de_i2i_gan_torch.cli.translate_folder --name exp \
        --input_dir imgs/ --output_dir out/ --image_size 1024 \
        --style_norm_block_type sean --target_label 2 [--spatial 2]

``--spatial S`` shards the image height over S ranks, one process a device
(``parallel/spatial.py``): the devices are ``--gpu_ids a,b`` (``0,0``: two
ranks sharing a card), else the first ``--num_devices`` cards, else every
visible card; ``--gpu_ids -1 --num_devices N`` gives N CPU ranks. The ranks
form ``N // S`` data groups; the batch is rounded up to a multiple of them,
as the JAX CLI rounds it. The CLI spawns the ranks
(``distributed.launch``), or runs as one of them under ``torchrun`` or in a
process that is a rank already. Every rank reads every batch, runs its band
of its data group's images, and rank 0 gathers the bands and writes the
PNGs (its ``main`` returns them; the others' return none). Fewer devices
than S raise, where the JAX CLI runs on one device.

SEAN without style features takes each label's latent code; SPADE needs no
style. AdaIN needs a style code, which a folder of images does not give:
it is refused (the JAX CLI fails inside AdaIN's shape check).
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

SUFFIXES = (".png", ".jpg", ".jpeg")


def main(argv=None) -> dict:
    """Translate the folder; returns the written paths (``written``)."""
    import torch.distributed as dist

    from de_i2i_gan_torch.config.options import Options, to_defectgan_config
    from de_i2i_gan_torch.parallel import distributed
    from de_i2i_gan_torch.parallel.mesh import visible_devices
    from de_i2i_gan_torch.parallel.spatial import check_height

    argv = sys.argv[1:] if argv is None else list(argv)  # for the ranks too
    p = argparse.ArgumentParser()
    p.add_argument("--input_dir", type=Path, required=True)
    p.add_argument("--output_dir", type=Path, required=True)
    p.add_argument("--target_label", type=int, default=1)
    p.add_argument("--spatial", type=int, default=1,
                   help="shard the image height over this many devices, one "
                        "rank each")
    known, rest = p.parse_known_args(argv)

    opt = Options("defectgan_test").parse(rest, save=False)
    cfg = to_defectgan_config(opt)
    if cfg.style_norm_block_type == "adain":
        raise ValueError(
            "translate_folder: AdaIN needs a style code for every image, and "
            "a folder gives none; export the generator (cli.export_model) "
            "and serve it with its style extractor instead")
    if known.spatial <= 1:
        return _translate(known, opt, cfg)
    devices = visible_devices("auto", opt.gpu_ids, opt.num_devices)
    if len(devices) < known.spatial or len(devices) % known.spatial:
        raise ValueError(
            f"--spatial {known.spatial} needs a multiple of {known.spatial} "
            f"devices, got {len(devices)} ({', '.join(devices)}): name them "
            "with --gpu_ids a,b (0,0 shares a card) or --num_devices")
    check_height(opt.image_size, known.spatial, cfg.num_scales)
    if distributed.under_torchrun() or dist.is_initialized():
        distributed.initialize(devices)
        return _translate(known, opt, cfg)
    return distributed.launch(main, devices, argv)[0]


def _translate(known, opt, cfg) -> dict:
    """The folder's batches through G, on this process's device or, with
    ``--spatial``, on this rank's band; rank 0 writes the PNGs."""
    import torch
    from PIL import Image

    from de_i2i_gan_torch.config import TrainConfig
    from de_i2i_gan_torch.config.options import device_of
    from de_i2i_gan_torch.data.transforms import EvalTransform
    from de_i2i_gan_torch.parallel import distributed
    from de_i2i_gan_torch.parallel.spatial import (
        make_height_shard, spatial_sharded_inference)
    from de_i2i_gan_torch.train.checkpoint import load_checkpoint
    from de_i2i_gan_torch.train.jax_import import init_weights
    from de_i2i_gan_torch.train.steps import DefectGanSteps
    from de_i2i_gan_torch.utils.png import write_png

    spatial = known.spatial > 1
    device = distributed.device() if spatial else device_of(opt)
    steps = DefectGanSteps(cfg, TrainConfig(), device=device)
    init_weights(steps, opt.seed)
    name = opt.load_model_name or opt.name
    load_checkpoint(opt.ckpt_dir, name, opt.which_epoch, steps, strict=False)

    tf = EvalTransform(opt.image_size)
    rng = np.random.default_rng(opt.seed)
    files = sorted(f for f in known.input_dir.iterdir()
                   if f.suffix.lower() in SUFFIXES)
    batch_size = max(1, opt.batch_size)
    if spatial:
        shard = make_height_shard(known.spatial)
        # the batch shards over the data groups: round it up to a multiple
        # of them (the tail padding below fills the extra rows)
        batch_size = -(-batch_size // shard.data_size) * shard.data_size
        fwd = spatial_sharded_inference(steps.G, shard)
    else:
        def fwd(imgs, labels, style_feat, generator):
            return steps.G(imgs, labels, style_feat, generator=generator)[0]
    writer = distributed.is_primary()
    if writer:
        known.output_dir.mkdir(parents=True, exist_ok=True)
    device = steps.device
    noise = torch.Generator(device).manual_seed(0)
    labels = torch.zeros((batch_size, cfg.label_nc), device=device)
    labels[:, known.target_label] = 1.0
    written = []
    with torch.no_grad():
        for i in range(0, len(files), batch_size):
            chunk = files[i:i + batch_size]
            imgs = np.stack([tf(Image.open(f), rng) for f in chunk])
            # the tail batch padded, so every batch has one shape
            pad = batch_size - len(chunk)
            if pad:
                imgs = np.concatenate(
                    [imgs, np.zeros((pad, *imgs.shape[1:]), imgs.dtype)])
            out = fwd(torch.as_tensor(imgs, device=device), labels, None,
                      noise)
            if not writer:
                continue
            out = out.float().cpu().numpy()
            for f, o in zip(chunk, out):
                path = known.output_dir / f.name
                write_png(path, np.clip((o + 1) * 127.5, 0, 255
                                        ).astype(np.uint8))
                written.append(path)
    if writer:
        print(f"translated {len(written)} images -> {known.output_dir}")
    return {"written": written}


if __name__ == "__main__":
    main(sys.argv[1:])
