"""MVTec training wrappers, counterpart of
``de_i2i_gan_tpu/cli/train_mtvec.py`` (reference: defectGAN/train_mtvec.py
and pretrain_mtvec.py re-wire the DefectGAN and MAE trainers onto
MTVecDataset with cce classification).

    python -m de_i2i_gan_torch.cli.train_mtvec --dataset_data_type pill ...
    python -m de_i2i_gan_torch.cli.train_mtvec --pretrain --dataset_data_type pill
"""
from __future__ import annotations

import sys


def main(argv=None):
    """``--pretrain``: ``train_mae``; otherwise ``train_defectgan``; on the
    ``mtvec`` dataset. Returns the trainer."""
    argv = list(argv or [])
    pretrain = "--pretrain" in argv
    if pretrain:
        argv.remove("--pretrain")
    argv += ["--dataset_name", "mtvec"]
    if pretrain:
        from de_i2i_gan_torch.cli.train_mae import main as mae_main
        return mae_main(argv)
    from de_i2i_gan_torch.cli.train_defectgan import main as dg_main
    return dg_main(argv)


if __name__ == "__main__":
    main(sys.argv[1:])
