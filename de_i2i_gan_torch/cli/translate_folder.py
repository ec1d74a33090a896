"""Batched folder inference, counterpart of
``de_i2i_gan_tpu/cli/translate_folder.py`` (BASELINE.json config #5:
batched 1024x1024 folder inference), on one device.

Loads a DefectGAN checkpoint, runs the generator over every ``.png``,
``.jpg`` and ``.jpeg`` of a folder (sorted) at ``--image_size`` (the
generator is fully convolutional) in batches of ``--batch_size``, the last
padded with zeros, and writes the translated images as PNGs under their
input names. The generator runs in eval mode, its noise from a generator
seeded 0. Runs on CUDA device 0; ``--gpu_ids -1`` runs on the CPU.

    python -m de_i2i_gan_torch.cli.translate_folder --name exp \
        --input_dir imgs/ --output_dir out/ --image_size 1024 \
        --style_norm_block_type sean --target_label 2

SEAN without style features takes each label's latent code; SPADE needs no
style. AdaIN needs a style code, which a folder of images does not give:
it is refused (the JAX CLI fails inside AdaIN's shape check). ``--spatial
> 1`` (the image height sharded over several devices) waits for ROADMAP
A.9.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

SUFFIXES = (".png", ".jpg", ".jpeg")


def main(argv=None) -> dict:
    """Translate the folder; returns the written paths (``written``)."""
    import torch
    from PIL import Image

    from de_i2i_gan_torch.config import TrainConfig
    from de_i2i_gan_torch.config.options import (
        Options, check_ported, device_of, to_defectgan_config)
    from de_i2i_gan_torch.data.transforms import EvalTransform
    from de_i2i_gan_torch.train.checkpoint import load_checkpoint
    from de_i2i_gan_torch.train.jax_import import init_weights
    from de_i2i_gan_torch.train.steps import DefectGanSteps
    from de_i2i_gan_torch.utils.png import write_png

    p = argparse.ArgumentParser()
    p.add_argument("--input_dir", type=Path, required=True)
    p.add_argument("--output_dir", type=Path, required=True)
    p.add_argument("--target_label", type=int, default=1)
    p.add_argument("--spatial", type=int, default=1,
                   help="shard the image height over this many devices "
                        "(ROADMAP A.9)")
    known, rest = p.parse_known_args(argv)
    if known.spatial > 1:
        raise NotImplementedError(
            "--spatial > 1 is not ported to the PyTorch package yet "
            "(ROADMAP A.9)")

    opt = Options("defectgan_test").parse(rest, save=False)
    check_ported(opt)
    cfg = to_defectgan_config(opt)
    if cfg.style_norm_block_type == "adain":
        raise ValueError(
            "translate_folder: AdaIN needs a style code for every image, and "
            "a folder gives none; export the generator (cli.export_model) "
            "and serve it with its style extractor instead")
    steps = DefectGanSteps(cfg, TrainConfig(), device=device_of(opt))
    init_weights(steps, opt.seed)
    name = opt.load_model_name or opt.name
    load_checkpoint(opt.ckpt_dir, name, opt.which_epoch, steps, strict=False)

    tf = EvalTransform(opt.image_size)
    rng = np.random.default_rng(opt.seed)
    files = sorted(f for f in known.input_dir.iterdir()
                   if f.suffix.lower() in SUFFIXES)
    known.output_dir.mkdir(parents=True, exist_ok=True)
    device = steps.device
    noise = torch.Generator(device).manual_seed(0)
    batch_size = max(1, opt.batch_size)
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
            out, _ = steps.G(torch.as_tensor(imgs, device=device), labels,
                             None, generator=noise)
            out = out.float().cpu().numpy()
            for f, o in zip(chunk, out):
                path = known.output_dir / f.name
                write_png(path, np.clip((o + 1) * 127.5, 0, 255
                                        ).astype(np.uint8))
                written.append(path)
    print(f"translated {len(written)} images -> {known.output_dir}")
    return {"written": written}


if __name__ == "__main__":
    main(sys.argv[1:])
