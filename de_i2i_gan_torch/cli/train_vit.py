"""ViT classifier training and the embedding dump, counterpart of
``de_i2i_gan_tpu/cli/train_vit.py`` (reference: defectGAN/train_vit.py).

    python -m de_i2i_gan_torch.cli.train_vit --name vit \
        --dataset_name synthetic --model_size base --vit_path /path/to/hf_vit

    # the offline SEAN embedding bank (DefectGAN's --embed_path):
    python -m de_i2i_gan_torch.cli.train_vit --name vit \
        --dataset_name synthetic --dump_embeddings out/embeds.npz

The frozen backbone is the HF checkpoint of ``--vit_path``, or one drawn
from ``--seed``; the linear head trains with AdamW on the cosine schedule.
Checkpoints go to ``<ckpt_dir>/<name>/{latest,<num_epochs>}_state.pt``.
Runs on CUDA device 0; ``--gpu_ids -1`` on the CPU.
"""
from __future__ import annotations

import sys
from pathlib import Path


def build_backbone(opt, device):
    """The frozen ViT: drawn from ``opt.seed`` on ``device``, then the HF
    weights of ``opt.vit_path`` when given."""
    import torch

    from de_i2i_gan_torch.models.vit import ViTEncoder, load_hf_vit_weights
    net = ViTEncoder(opt.model_size, device=device,
                     generator=torch.Generator(device).manual_seed(opt.seed))
    if opt.vit_path:
        load_hf_vit_weights(opt.vit_path, net)
    return net


def main(argv=None):
    """Train (or, with ``--dump_embeddings <path>``, write the bank);
    returns the ``ViTSteps``."""
    from de_i2i_gan_torch.cli.train_defectgan import build_datasets
    from de_i2i_gan_torch.config.options import (
        Options, device_of, to_train_config)
    from de_i2i_gan_torch.data.embeddings import EmbeddingBank
    from de_i2i_gan_torch.data.pipeline import DataLoader
    from de_i2i_gan_torch.data.transforms import TrainTransform
    from de_i2i_gan_torch.train.checkpoint import save_checkpoint
    from de_i2i_gan_torch.train.vit_steps import ViTSteps, dump_embeddings

    argv = list(sys.argv[1:] if argv is None else argv)
    dump_path = None
    if "--dump_embeddings" in argv:
        i = argv.index("--dump_embeddings")
        dump_path = Path(argv[i + 1])
        argv = argv[:i] + argv[i + 2:]

    opt = Options("vit_train").parse(argv)
    opt.label_nc = getattr(opt, "label_nc", 6)
    datasets, _ = build_datasets(
        opt, "train", TrainTransform(opt.image_size, jitter=False))
    tcfg = to_train_config(opt, "cce")
    device = device_of(opt)
    loader = DataLoader(datasets["defects"], opt.batch_size, seed=opt.seed)
    steps = ViTSteps(opt.label_nc, tcfg, opt.model_size,
                     iters_per_epoch=len(loader), num_epochs=opt.num_epochs,
                     backbone=build_backbone(opt, device), seed=opt.seed,
                     device=device)

    if dump_path is not None:
        bank = EmbeddingBank.from_dict(
            dump_embeddings(steps, iter(loader), opt.label_nc), opt.label_nc)
        dump_path.parent.mkdir(parents=True, exist_ok=True)
        bank.save(dump_path)
        print(f"wrote embedding bank ({sum(bank.counts)} embeddings, "
              f"{int((bank.counts > 0).sum())} label combos) to {dump_path}")
        return steps

    for epoch in range(1, max(opt.num_epochs, 1) + 1):
        accs = [float(steps.train_step(imgs, labels)["acc"])
                for imgs, labels, _ in loader]
        print(f"epoch {epoch}: acc {sum(accs) / max(len(accs), 1):.4f}")
        save_checkpoint(opt.ckpt_dir, opt.name, "latest", steps,
                        epoch=epoch, iters=epoch * len(loader))
    save_checkpoint(opt.ckpt_dir, opt.name, opt.num_epochs, steps)
    return steps


if __name__ == "__main__":
    main(sys.argv[1:])
