"""Procedural CODEBRIM-shaped synthetic data, a copy of
``de_i2i_gan_tpu/data/synthetic.py`` that gives the same arrays bit for bit:
textured 'concrete' backgrounds, and defect images = background + colored
blobs whose channels encode the active labels. No files, fully
deterministic."""
from __future__ import annotations

import numpy as np


class SyntheticDefectDataset:
    clf_loss_type = "bce"

    def __init__(self, image_size: int = 64, label_nc: int = 6,
                 length: int = 64, data_type: str = "defects",
                 seed: int = 123, transform=None, **_):
        self.size = image_size
        self.label_nc = label_nc
        self.length = length
        self.data_type = data_type
        self.seed = seed

    def __len__(self):
        return self.length

    def _background(self, rng: np.random.Generator) -> np.ndarray:
        s = self.size
        base = rng.uniform(-0.3, 0.3)
        noise = rng.normal(0.0, 0.08, (s, s, 1)).astype(np.float32)
        x = np.linspace(0, 4 * np.pi, s, dtype=np.float32)
        texture = 0.08 * np.sin(x)[None, :, None] * np.cos(x)[:, None, None]
        img = np.clip(base + noise + texture, -1, 1)
        return np.repeat(img, 3, axis=2).astype(np.float32)

    def __getitem__(self, index: int):
        rng = np.random.default_rng(self.seed * 100003 + index)
        img = self._background(rng)
        label = np.zeros(self.label_nc, np.float32)
        if self.data_type == "background" or (
                self.data_type == "fusion" and index % 2 == 0):
            label[0] = 1.0
        else:
            n_defects = rng.integers(1, 3)
            classes = rng.choice(np.arange(1, self.label_nc), n_defects,
                                 replace=False)
            s = self.size
            yy, xx = np.mgrid[0:s, 0:s].astype(np.float32)
            for c in classes:
                label[c] = 1.0
                cy, cx = rng.uniform(0.2 * s, 0.8 * s, 2)
                r = rng.uniform(0.08 * s, 0.25 * s)
                blob = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (r * r))
                color = np.zeros(3, np.float32)
                color[c % 3] = 1.0 if c < 3 else -1.0
                img = img * (1 - blob[..., None]) + color * blob[..., None]
        return np.clip(img, -1, 1).astype(np.float32), label, f"synthetic://{index}"
