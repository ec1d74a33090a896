"""MVTec MAE pretraining entry, counterpart of
``de_i2i_gan_tpu/cli/pretrain_mtvec.py`` (reference:
defectGAN/pretrain_mtvec.py): ``train_mtvec --pretrain``."""
from __future__ import annotations

import sys

from de_i2i_gan_torch.cli.train_mtvec import main as _main


def main(argv=None):
    return _main(["--pretrain", *(argv or [])])


if __name__ == "__main__":
    main(sys.argv[1:])
