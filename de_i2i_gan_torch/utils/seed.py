"""Determinism helpers, counterpart of ``de_i2i_gan_tpu/utils/seed.py``
(the reference's utils/util.py:21-36 ``fix_rand_seed`` and
``worker_init_fn``): pins the host-side randomness of the data pipeline
and torch's default generators. The steps and the trainer draw from
explicit ``torch.Generator`` objects besides."""
from __future__ import annotations

import random

import numpy as np
import torch


def fix_rand_seed(seed: int = 123) -> None:
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)  # the CPU's and every CUDA device's generator


def worker_rng(seed: int, worker_id: int) -> np.random.Generator:
    return np.random.default_rng(seed + worker_id)
