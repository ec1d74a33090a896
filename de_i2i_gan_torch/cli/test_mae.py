"""MAE pretraining evaluation, counterpart of
``de_i2i_gan_tpu/cli/test_mae.py`` (reference: defectGAN/test_mae.py):
validation losses and a repair grid from a pretrained checkpoint.

    python -m de_i2i_gan_torch.cli.test_mae --name mae_exp \
        --dataset_name synthetic --image_size 128

Loads ``<ckpt_dir>/<name>/<which_epoch>_state.pt`` (a filtered load, as the
JAX CLI does), prints the mean ``{rec, gan, clf}`` over the test defect
images, and writes ``<results_dir>/<name>/repair_grid.png``: one row per
image of the first batch (up to 4), panels [orig | combined | masked | pred
| pred-masked]. ``--gpu_ids -1`` runs on the CPU.
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch


def main(argv=None):
    """Evaluate; returns the mean losses and the grid's path."""
    from de_i2i_gan_torch.cli.test_defectgan import _save_image
    from de_i2i_gan_torch.cli.train_defectgan import build_datasets
    from de_i2i_gan_torch.config.options import (
        Options, device_of, to_defectgan_config, to_mae_config,
        to_train_config)
    from de_i2i_gan_torch.data.pipeline import DataLoader
    from de_i2i_gan_torch.data.transforms import EvalTransform
    from de_i2i_gan_torch.train.checkpoint import load_checkpoint
    from de_i2i_gan_torch.train.jax_import import init_weights
    from de_i2i_gan_torch.train.mae_steps import MAESteps

    opt = Options("mae_test").parse(argv)
    cfg = to_defectgan_config(opt)
    mcfg = to_mae_config(opt)
    datasets, clf = build_datasets(opt, "test", EvalTransform(opt.image_size))
    tcfg = to_train_config(opt, clf)

    steps = MAESteps(cfg, mcfg, tcfg, device=device_of(opt))
    steps.init_training()
    init_weights(steps, opt.seed)
    name = opt.load_model_name or opt.name
    load_checkpoint(opt.ckpt_dir, name, opt.which_epoch, steps, strict=False)

    loader = DataLoader(datasets["defects"], opt.batch_size, seed=opt.seed)
    results_dir = Path(opt.results_dir) / name
    results_dir.mkdir(parents=True, exist_ok=True)

    gen = torch.Generator(steps.device).manual_seed(opt.seed)
    evals = [steps.eval_losses({"imgs": imgs, "labels": labels}, gen)
             for imgs, labels, _ in loader]
    losses = {k: torch.stack([e[k] for e in evals]).mean().item()
              for k in evals[0]}
    print({k: round(v, 4) for k, v in losses.items()})

    # repair grids: [orig | combined | masked | pred | pred-masked]
    imgs, labels, _ = next(iter(loader))
    g = steps.repair_grid(imgs[:4], labels[:4], gen).cpu().numpy()
    rows = [np.concatenate(list(g[i]), axis=1) for i in range(g.shape[0])]
    path = results_dir / "repair_grid.png"
    _save_image(np.concatenate(rows, axis=0), path)
    print(f"wrote repair grid to {results_dir}")
    return {"losses": losses, "grid": path}


if __name__ == "__main__":
    main(sys.argv[1:])
