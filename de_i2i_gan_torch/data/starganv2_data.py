"""StarGAN v2 data pipeline, a copy of ``de_i2i_gan_tpu/data/starganv2_data.py``.

Mirrors the reference's stargan-v2/core/data_loader.py:
  DefaultDataset          (:34-51)  unlabeled folder
  ReferenceDataset        (:54-84)  paired random same-domain references
  _make_balanced_sampler  (:87-91)  inverse-frequency class balancing
  InputFetcher            (:180-244) infinite iterator + z sampling, yielding
                                     the batch the solver consumes
  RandomReferenceDataset  (:247-352) stacks num_embeds same-domain references
                                     per sample (SEAN style banks)

Domain labels are integer ids derived from subdirectory names. Batches are
NHWC numpy, the JAX package's bit for bit, z draws included.
``SEANInputFetcher`` adds the frozen ViT's embeddings of the reference
stacks (float32 numpy, made on the extractor's device); its draws of how
many references a stack gives come from a ``torch.Generator`` seeded from
the fetcher's numpy stream, so they are not the JAX package's.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, List

import numpy as np

from de_i2i_gan_torch.data.pipeline import DataLoader, InfiniteLoader


def list_domains(root: Path) -> List[str]:
    return sorted(p.name for p in Path(root).iterdir() if p.is_dir())


def _files(d: Path):
    return sorted(p for p in Path(d).iterdir()
                  if p.suffix.lower() in (".png", ".jpg", ".jpeg"))


class ImageFolderDataset:
    """Labeled domain-folder dataset (DefaultDataset + labels)."""

    def __init__(self, root: Path, transform=None, seed: int = 777):
        self.root = Path(root)
        self.domains = list_domains(root)
        self.samples = [(fn, idx) for idx, d in enumerate(self.domains)
                        for fn in _files(self.root / d)]
        self.transform = transform
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.samples)

    def labels(self) -> np.ndarray:
        return np.asarray([l for _, l in self.samples])

    def __getitem__(self, i):
        from PIL import Image
        fn, label = self.samples[i]
        img = Image.open(fn).convert("RGB")
        if self.transform is not None:
            img = self.transform(img, self._rng)
        return img, np.int32(label), str(fn)


class ReferenceDataset:
    """(x_ref, x_ref2, y): two random images of the same domain
    (data_loader.py:54-84)."""

    def __init__(self, root: Path, transform=None, seed: int = 777):
        self.base = ImageFolderDataset(root, transform, seed)
        rng = np.random.default_rng(seed)
        by_domain: Dict[int, List[int]] = {}
        for i, (_, l) in enumerate(self.base.samples):
            by_domain.setdefault(l, []).append(i)
        self.pairs = [(i, int(rng.choice(by_domain[l])), l)
                      for i, (_, l) in enumerate(self.base.samples)]

    def __len__(self):
        return len(self.pairs)

    def labels(self):
        return np.asarray([l for _, _, l in self.pairs])

    def __getitem__(self, i):
        a, b, label = self.pairs[i]
        img_a, _, fn = self.base[a]
        img_b, _, _ = self.base[b]
        return (img_a, img_b), np.int32(label), fn


class RandomReferenceDataset:
    """num_embeds random same-domain references per sample
    (data_loader.py:247-352)."""

    def __init__(self, root: Path, num_embeds: int, transform=None,
                 seed: int = 777):
        self.base = ImageFolderDataset(root, transform, seed)
        self.num_embeds = num_embeds
        self._rng = np.random.default_rng(seed)
        self.by_domain: Dict[int, List[int]] = {}
        for i, (_, l) in enumerate(self.base.samples):
            self.by_domain.setdefault(l, []).append(i)

    def __len__(self):
        return len(self.base)

    def labels(self):
        return self.base.labels()

    def __getitem__(self, i):
        fn, label = self.base.samples[i]
        idxs = self._rng.choice(self.by_domain[label], self.num_embeds)
        imgs = [self.base[int(j)][0] for j in idxs]
        return np.stack(imgs), np.int32(label), str(fn)


def balanced_indices(labels: np.ndarray, n: int,
                     rng: np.random.Generator) -> np.ndarray:
    """Inverse-frequency sampling with replacement (data_loader.py:87-91)."""
    _, counts = np.unique(labels, return_counts=True)
    freq = {c: 1.0 / counts[k] for k, c in
            enumerate(np.unique(labels))}
    w = np.asarray([freq[l] for l in labels])
    w = w / w.sum()
    return rng.choice(len(labels), size=n, replace=True, p=w)


class BalancedLoader(DataLoader):
    """Class-balanced shuffling loader."""

    def _indices(self) -> np.ndarray:
        rng = np.random.default_rng(self.seed + self._epoch)
        n = self.num_samples or len(self.dataset)
        return balanced_indices(self.dataset.labels(), n, rng)


class InputFetcher:
    """Infinite fetcher assembling the solver batch (data_loader.py:180-244):
    source images/labels, paired references, latent z draws; for SEAN,
    reference stacks ready for the frozen ViT."""

    def __init__(self, src_loader, ref_loader, latent_dim: int = 16,
                 norm_type: str = "adain", hidden_nc: int = 256,
                 seed: int = 777):
        self.src = InfiniteLoader(src_loader)
        self.ref = InfiniteLoader(ref_loader)
        self.latent_dim = latent_dim
        self.norm_type = norm_type
        self.hidden_nc = hidden_nc
        self._rng = np.random.default_rng(seed)

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        x_src, y_src, _ = next(self.src)
        refs, y_ref, _ = next(self.ref)
        x_ref, x_ref2 = refs if isinstance(refs, tuple) else (refs, refs)
        b = x_src.shape[0]
        batch = {
            "x_src": x_src, "y_src": y_src.astype(np.int32),
            "x_ref": x_ref[:b], "x_ref2": x_ref2[:b],
            "y_ref": y_ref[:b].astype(np.int32),
            "z_ref": self._rng.standard_normal(
                (b, self.latent_dim)).astype(np.float32),
            "z_ref2": self._rng.standard_normal(
                (b, self.latent_dim)).astype(np.float32),
            "z_src": self._rng.standard_normal(
                (b, self.latent_dim)).astype(np.float32),
        }
        return batch


class SEANInputFetcher:
    """The SEAN fetcher (JAX :169): wraps ``InputFetcher`` and attaches the
    frozen-ViT style embeddings the solver's SEAN path takes (get_style_code,
    utils.py:485-516: s_trg = feature_extractor(reference stacks); the cycle
    pass embeds x_src). Two independent stack draws give s_ref and s_ref2
    (the diversity loss); y_ref follows the stacks' labels. ``extractor``:
    a ``models/vit.py::FeatureExtractor`` or anything with its ``extract``.
    """

    def __init__(self, base_fetcher: InputFetcher, style_loader, extractor,
                 num_embeds: int = 5, seed: int = 777):
        self.base = base_fetcher
        self.style = InfiniteLoader(style_loader)
        self.extractor = extractor
        self.num_embeds = num_embeds
        self._rng = np.random.default_rng(seed)

    def __iter__(self):
        return self

    def _embed(self, x, num_embeds, generator=None) -> np.ndarray:
        e = self.extractor.extract(x, num_embeds, generator)
        return e.float().cpu().numpy()

    def __next__(self) -> Dict[str, np.ndarray]:
        import torch
        batch = next(self.base)
        b = batch["x_src"].shape[0]
        stacks, y, _ = next(self.style)      # (N, E, H, W, C)
        stacks2, _, _ = next(self.style)
        gen = torch.Generator(self.extractor.device).manual_seed(
            int(self._rng.integers(2 ** 31)))
        batch["y_ref"] = y[:b].astype(np.int32)
        batch["s_ref"] = self._embed(stacks[:b], self.num_embeds, gen)
        batch["s_ref2"] = self._embed(stacks2[:b], self.num_embeds, gen)
        batch["s_src"] = self._embed(batch["x_src"], 1)
        return batch


def _collate_ref(samples):
    a = np.stack([s[0][0] for s in samples])
    b = np.stack([s[0][1] for s in samples])
    labels = np.stack([s[1] for s in samples])
    return (a, b), labels, [s[2] for s in samples]


class ReferenceLoader(BalancedLoader):
    """Class-balanced loader over ReferenceDataset with pair collation."""

    def __iter__(self):
        idx = self._indices()
        self._epoch += 1
        nb = len(idx) // self.batch_size
        for bi in range(nb):
            chunk = idx[bi * self.batch_size:(bi + 1) * self.batch_size]
            yield _collate_ref([self.dataset[int(i)] for i in chunk])


def make_reference_loader(dataset: ReferenceDataset, batch_size: int,
                          seed: int = 777,
                          num_threads: int = 2) -> "ReferenceLoader":
    return ReferenceLoader(dataset, batch_size, seed=seed,
                           num_threads=num_threads)
