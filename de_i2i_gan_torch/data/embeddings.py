"""SEAN style-embedding bank, counterpart of
``de_i2i_gan_tpu/data/embeddings.py``.

The reference trains SEAN-conditioned DefectGAN against a bank of frozen-ViT
CLS embeddings dumped offline per label combination (``--embed_path``,
defectGAN/models/defectgan_model.py:43-45, sampled per batch at :394-411
``_get_style_embeds``: ``num_embeds`` random picks per sample's label,
zeros when a label has no embeddings).

The bank is a fixed-size array (2**label_nc, capacity, embed_nc) with
per-label counts, so per-batch sampling is one gather on the device. Banks
load from:
  * the torch .pth dict {label_tuple: [tensors]} the reference dumps
  * a dict {label_tuple: [arrays]}
  * an .npz file written by ``save`` (the JAX package's layout)
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from de_i2i_gan_torch.nn.normalization import sean_label_index
from de_i2i_gan_torch.utils.labels import normal_labels


class EmbeddingBank:
    def __init__(self, label_nc: int, embed_nc: int, capacity: int = 1024):
        self.label_nc = label_nc
        self.embed_nc = embed_nc
        self.capacity = capacity
        self.bank = np.zeros((2 ** label_nc, capacity, embed_nc), np.float32)
        self.counts = np.zeros((2 ** label_nc,), np.int32)
        self._device = {}

    # ------------------------------------------------------------- building
    @staticmethod
    def _label_key_to_index(key) -> int:
        return int(sum(int(v) * (2 ** i) for i, v in enumerate(key)))

    def add(self, label_key, embed: np.ndarray) -> None:
        idx = self._label_key_to_index(label_key)
        c = self.counts[idx]
        if c < self.capacity:
            self.bank[idx, c] = embed
            self.counts[idx] += 1
        else:  # reservoir-ish: overwrite a random slot
            self.bank[idx, np.random.randint(self.capacity)] = embed
        self._device = {}

    @classmethod
    def from_dict(cls, d: Dict, label_nc: int,
                  capacity: int = 1024) -> "EmbeddingBank":
        embed_nc = len(next(iter(d.values()))[0])
        bank = cls(label_nc, embed_nc, capacity)
        for key, embeds in d.items():
            for e in embeds:
                bank.add(key, np.asarray(e, np.float32))
        return bank

    @classmethod
    def from_torch_file(cls, path: Path, label_nc: int,
                        capacity: int = 1024) -> "EmbeddingBank":
        """Load the reference's torch-saved embedding dict."""
        d = torch.load(path, map_location="cpu")
        d = {k: [np.asarray(e) for e in v] for k, v in d.items()}
        return cls.from_dict(d, label_nc, capacity)

    def save(self, path: Path) -> None:
        np.savez_compressed(path, bank=self.bank, counts=self.counts,
                            label_nc=self.label_nc)

    @classmethod
    def load(cls, path: Path) -> "EmbeddingBank":
        with np.load(path) as f:
            bank = cls(int(f["label_nc"]), f["bank"].shape[-1],
                       f["bank"].shape[1])
            bank.bank = f["bank"][:]
            bank.counts = f["counts"][:]
        return bank

    # ------------------------------------------------------------- sampling
    def _on(self, device: torch.device):
        if device not in self._device:
            self._device[device] = (torch.as_tensor(self.bank, device=device),
                                    torch.as_tensor(self.counts, device=device))
        return self._device[device]

    def sample(self, labels: torch.Tensor, num_embeds: int,
               generator: torch.Generator) -> torch.Tensor:
        """(N, label_nc) one-hot rows -> (N, num_embeds, embed_nc), on the
        labels' device, slots drawn from ``generator`` (on that device).

        Labels with an empty bank get zeros: SEAN's zero-embedding fallback
        then substitutes the latent code, as defectgan_model.py:404-406 does.
        """
        bank, counts = self._on(labels.device)
        idx = sean_label_index(labels)
        cnt = counts[idx]  # (N,)
        slots = torch.randint(0, 2 ** 30, (labels.shape[0], num_embeds),
                              generator=generator, device=labels.device)
        slots = slots % cnt.clamp_min(1)[:, None]
        picked = bank[idx[:, None], slots]  # (N, K, E)
        return torch.where((cnt > 0)[:, None, None], picked,
                           torch.zeros((), device=labels.device))


def attach_embeddings(batch: dict, bank: Optional[EmbeddingBank],
                      num_embeds: int, generator: torch.Generator) -> dict:
    """Add ``nm_embeds``/``df_embeds`` to a DefectGAN super-batch (leading
    num_critics axis handled), on the device of its ``df_labels``."""
    if bank is None:
        return batch
    df_labels = torch.as_tensor(batch["df_labels"])
    shape = df_labels.shape
    flat = df_labels.reshape(-1, shape[-1])
    df_e = bank.sample(flat, num_embeds, generator)
    nm_e = bank.sample(normal_labels(flat), num_embeds, generator)
    batch = dict(batch)
    batch["df_embeds"] = df_e.reshape(*shape[:-1], num_embeds, bank.embed_nc)
    batch["nm_embeds"] = nm_e.reshape(*shape[:-1], num_embeds, bank.embed_nc)
    return batch
