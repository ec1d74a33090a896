"""Result grids, a copy of ``de_i2i_gan_tpu/utils/visualize.py::make_grid``
(the reference's torchvision ``make_grid``). The ablation figures and the
embedding scatter of the JAX module need matplotlib and wait for ROADMAP
A.9."""
from __future__ import annotations

import numpy as np


def make_grid(images: np.ndarray, nrow: int, pad: int = 2) -> np.ndarray:
    """(N, H, W, C) in [-1,1] -> single (H', W', C) grid image in [0,1]
    (torchvision make_grid equivalent)."""
    n, h, w, c = images.shape
    ncol = nrow
    nrow_ = (n + ncol - 1) // ncol
    grid = np.ones((nrow_ * (h + pad) + pad, ncol * (w + pad) + pad, c),
                   np.float32)
    for i in range(n):
        r, col = divmod(i, ncol)
        y0 = pad + r * (h + pad)
        x0 = pad + col * (w + pad)
        grid[y0:y0 + h, x0:x0 + w] = (images[i] + 1.0) / 2.0
    return np.clip(grid, 0, 1)
