"""Paired-i2i inference entry point, counterpart of
``de_i2i_gan_tpu/cli/test_pix2pix.py`` (pix2pix test.py):

    python -m de_i2i_gan_torch.cli.test_pix2pix --name edges2photos \
        --dataroot ./datasets/edges2photos --save_img

Loads a ``Pix2PixTrainer`` checkpoint, translates the test split with the
EMA generator, writes input | fake | target PNG panels under
``--results_dir/<name>/`` (``--save_img`` or ``--save_img_grid``) and
``results.json`` with the mean ``l1`` and ``num_images``; ``--metrics fid``
adds the FID of the fakes against the targets (InceptionV3 drawn from a
seed: no pretrained weights are in the repository, so the number means
nothing). Runs on CUDA device 0; ``--gpu_ids -1`` runs on the CPU.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np


def main(argv=None):
    """Test; returns the results, with ``pngs`` the panels written."""
    from de_i2i_gan_torch.cli.train_pix2pix import build_dataset
    from de_i2i_gan_torch.config.options import (
        Options, check_ported, device_of, to_pix2pix_config, to_train_config)
    from de_i2i_gan_torch.data.paired import PairedLoader
    from de_i2i_gan_torch.train.checkpoint import load_checkpoint
    from de_i2i_gan_torch.train.jax_import import init_weights
    from de_i2i_gan_torch.train.pix2pix_steps import Pix2PixSteps
    from de_i2i_gan_torch.utils.png import write_png

    opt = Options("pix2pix_test").parse(argv, save=False)
    check_ported(opt)
    cfg = to_pix2pix_config(opt)
    tcfg = to_train_config(opt)
    num_d = opt.num_D if opt.netD == "multiscale" else 1
    steps = Pix2PixSteps(cfg, tcfg, num_d_scales=num_d,
                         gan_kind=opt.gan_mode, lambda_l1=opt.lambda_L1,
                         lambda_fm=opt.lambda_feat, n_layers_d=opt.n_layers_D,
                         device=device_of(opt))
    init_weights(steps, opt.seed)
    name = opt.load_model_name or opt.name
    load_checkpoint(opt.ckpt_dir, name, opt.which_epoch, steps, strict=False)

    loader = PairedLoader(build_dataset(opt, "test"), opt.batch_size,
                          shuffle=False, drop_last=False, seed=opt.seed)
    out_dir = Path(opt.results_dir) / name
    out_dir.mkdir(parents=True, exist_ok=True)
    evaluator = None
    if opt.metrics and "fid" in opt.metrics:
        from de_i2i_gan_torch.metrics.evaluator import Evaluator
        from de_i2i_gan_torch.metrics.fid import ActivationStats
        evaluator = Evaluator(dims=opt.dims, device=steps.device)
        fake_stats, real_stats = (ActivationStats(opt.dims),
                                  ActivationStats(opt.dims))
    l1_sum, n_imgs, pngs = 0.0, 0, []
    for batch in loader:
        y = batch["target"]
        fake_t = steps.generate(batch["input"])
        fake = fake_t.float().cpu().numpy()
        l1_sum += float(np.abs(fake - y).mean()) * fake.shape[0]
        n_imgs += fake.shape[0]
        if evaluator is not None:
            fake_stats.update(evaluator.features(fake_t).cpu().numpy())
            real_stats.update(evaluator.features(y).cpu().numpy())
        if opt.save_img or opt.save_img_grid:
            for i in range(fake.shape[0]):
                panel = np.concatenate([batch["input"][i], fake[i], y[i]],
                                       axis=1)
                path = out_dir / f"{len(pngs):05d}.png"
                write_png(path, np.clip((panel + 1) * 127.5, 0, 255
                                        ).astype(np.uint8))
                pngs.append(path)
    results = {"l1": l1_sum / max(n_imgs, 1), "num_images": n_imgs}
    if evaluator is not None and fake_stats.n > 1:
        from de_i2i_gan_torch.metrics.fid import frechet_distance
        results["fid"] = frechet_distance(*fake_stats.finalize(),
                                          *real_stats.finalize())
    (out_dir / "results.json").write_text(json.dumps(results, indent=1))
    print(json.dumps(results))
    return dict(results, pngs=pngs)


if __name__ == "__main__":
    main(sys.argv[1:])
