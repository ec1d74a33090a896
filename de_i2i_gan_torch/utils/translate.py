"""StarGAN v2 sample grids, counterpart of the first half of
``de_i2i_gan_tpu/utils/translate.py``.

Mirrors the reference's stargan-v2/core/utils.py:
  translate_and_reconstruct (:110-133)   src -> trg -> back panels
  translate_using_latent    (:136-156)   rows of latent-guided translations
  translate_using_reference (:159-174)   per-reference rows with src header
  debug_image               (:254-334)   periodic sample dumps

Every grid comes from the solver's EMA nets (``StarGANv2Solver.style`` and
``generate`` with ``use_ema``), as numpy in [0, 1]; ``debug_image`` writes
it as a PNG with ``utils/png.py``. The alpha-mix and layer-split grids and
the videos wait for ROADMAP A.9.
"""
from __future__ import annotations

from pathlib import Path
from typing import Sequence

import numpy as np
import torch

from de_i2i_gan_torch.utils.png import write_png
from de_i2i_gan_torch.utils.visualize import make_grid


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def translate_and_reconstruct(solver, x_src, y_src, x_ref, y_ref, s_ref=None):
    """[src | ref | fake | reconstruction] panels (utils.py:110-133)."""
    if solver.cfg.norm_type == "adain":
        s = solver.style({"x_ref": x_ref}, y_ref, latent=False, use_ema=True)
        s_back = solver.style({"x_ref": x_src}, y_src, latent=False,
                              use_ema=True)
    else:
        s = s_back = s_ref
    fake = solver.generate(x_src, s, y_ref)
    rec = solver.generate(fake, s_back, y_src)
    panels = np.concatenate([_np(torch.as_tensor(x_src)),
                             _np(torch.as_tensor(x_ref)), _np(fake), _np(rec)])
    return make_grid(panels, nrow=x_src.shape[0])


def translate_using_latent(solver, x_src, y_trg_list: Sequence[int], z_list):
    """Rows of latent-guided translations (utils.py:136-156); AdaIN only."""
    n = x_src.shape[0]
    rows = [_np(torch.as_tensor(x_src))]
    for y in y_trg_list:
        y_trg = torch.full((n,), int(y), dtype=torch.int64)
        for z in z_list:
            z = torch.as_tensor(z).expand(n, -1)
            s = solver.style({"z_ref": z}, y_trg, latent=True, use_ema=True)
            rows.append(_np(solver.generate(x_src, s, y_trg)))
    return make_grid(np.concatenate(rows, axis=0), nrow=n)


def translate_using_reference(solver, x_src, x_ref, y_ref, s_ref=None):
    """Grid: header row of sources, one row per reference (utils.py:159-174)."""
    n = x_src.shape[0]
    rows = [_np(torch.as_tensor(x_src))]
    for i in range(x_ref.shape[0]):
        y = torch.full((n,), int(y_ref[i]), dtype=torch.int64)
        if solver.cfg.norm_type == "adain":
            s = solver.style({"x_ref": x_ref[i:i + 1]}, y_ref[i:i + 1],
                             latent=False, use_ema=True)
        else:
            s = torch.as_tensor(s_ref[i:i + 1])
        s = s.expand(n, *s.shape[1:])
        rows.append(_np(solver.generate(x_src, s, y)))
    return make_grid(np.concatenate(rows, axis=0), nrow=n)


def debug_image(solver, inputs, step: int, sample_dir: Path) -> Path:
    """Periodic sample dump (utils.py:254-334): ``<step:06d>_cycle.png``."""
    sample_dir = Path(sample_dir)
    sample_dir.mkdir(parents=True, exist_ok=True)
    grid = translate_and_reconstruct(
        solver, inputs["x_src"], inputs["y_src"], inputs["x_ref"],
        inputs["y_ref"], s_ref=inputs.get("s_ref"))
    path = sample_dir / f"{step:06d}_cycle.png"
    write_png(path, np.clip(grid * 255, 0, 255).astype(np.uint8))
    return path
