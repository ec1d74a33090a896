"""Paired (aligned) image-to-image datasets, the pix2pix data convention: a
copy of ``de_i2i_gan_tpu/data/paired.py`` that gives the same arrays bit
for bit.

An aligned sample is ONE image file containing input A and
target B concatenated side by side; train-time augmentation resizes both
halves to load_size, applies the SAME random crop to crop_size and the SAME
horizontal flip to both, then normalizes to [-1, 1].

``SyntheticPairedDataset`` is the procedural stand-in (photo = colored blobs
on a gradient; input = its edge map), used by the tests and the CLIs
(``--dataroot synthetic``): no files needed. ``write_aligned_folder`` writes
PNGs with the port's own writer (``utils/png.py``), so only reading an
aligned folder needs PIL.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, Iterator, Optional

import numpy as np

IMG_EXTS = {".jpg", ".jpeg", ".png", ".bmp", ".webp", ".tif", ".tiff"}


def _to_float(img: np.ndarray) -> np.ndarray:
    return img.astype(np.float32) / 127.5 - 1.0


def _resize(arr: np.ndarray, size: int) -> np.ndarray:
    """Bilinear resize HWC uint8/float via PIL (host-side decode path)."""
    from PIL import Image
    if arr.shape[0] == size and arr.shape[1] == size:
        return arr
    mode = "RGB" if arr.dtype == np.uint8 else None
    im = Image.fromarray(arr if arr.dtype == np.uint8
                         else np.clip((arr + 1) * 127.5, 0, 255).astype(np.uint8),
                         mode)
    out = np.asarray(im.resize((size, size), Image.BILINEAR))
    return out if arr.dtype == np.uint8 else _to_float(out)


class AlignedDataset:
    """pix2pix aligned dataset: dataroot/<phase>/*.jpg, each file = A|B."""

    def __init__(self, dataroot, phase: str = "train", load_size: int = 286,
                 crop_size: int = 256, flip: bool = True,
                 direction: str = "AtoB", seed: int = 123, **_):
        root = Path(dataroot) / phase
        self.paths = sorted(p for p in root.iterdir()
                            if p.suffix.lower() in IMG_EXTS)
        if not self.paths:
            raise FileNotFoundError(f"no images under {root}")
        self.load_size = load_size
        self.crop_size = crop_size
        self.flip = flip and phase == "train"
        self.direction = direction
        self.seed = seed
        self._epoch_salt = 0

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, index: int):
        from PIL import Image
        rng = np.random.default_rng(self.seed * 100003 + index
                                    + self._epoch_salt * 1_000_003)
        ab = np.asarray(Image.open(self.paths[index]).convert("RGB"))
        w = ab.shape[1] // 2
        a, b = ab[:, :w], ab[:, w:2 * w]
        if self.direction == "BtoA":
            a, b = b, a
        a = _resize(a, self.load_size)
        b = _resize(b, self.load_size)
        # identical crop offsets for both halves (pix2pix get_params)
        if self.load_size > self.crop_size:
            oy = int(rng.integers(0, self.load_size - self.crop_size + 1))
            ox = int(rng.integers(0, self.load_size - self.crop_size + 1))
            a = a[oy:oy + self.crop_size, ox:ox + self.crop_size]
            b = b[oy:oy + self.crop_size, ox:ox + self.crop_size]
        elif self.load_size < self.crop_size:
            a = _resize(a, self.crop_size)
            b = _resize(b, self.crop_size)
        if self.flip and rng.random() < 0.5:
            a, b = a[:, ::-1], b[:, ::-1]
        return (_to_float(np.ascontiguousarray(a)),
                _to_float(np.ascontiguousarray(b)),
                str(self.paths[index]))


class SyntheticPairedDataset:
    """Procedural edges2photos-shaped pairs: target = colored blobs over a
    smooth gradient background, input = Sobel-ish edge map of the target."""

    def __init__(self, image_size: int = 64, length: int = 64,
                 seed: int = 123, **_):
        self.size = image_size
        self.length = length
        self.seed = seed

    def __len__(self):
        return self.length

    def __getitem__(self, index: int):
        rng = np.random.default_rng(self.seed * 100003 + index)
        s = self.size
        yy, xx = np.mgrid[0:s, 0:s].astype(np.float32) / s
        photo = np.stack([0.6 * xx - 0.3, 0.6 * yy - 0.3,
                          0.3 * (xx + yy) - 0.3], axis=-1)
        for _ in range(int(rng.integers(2, 5))):
            cy, cx = rng.uniform(0.15, 0.85, 2)
            r = rng.uniform(0.08, 0.3)
            blob = np.exp(-(((yy - cy) ** 2 + (xx - cx) ** 2) / (r * r)))
            color = rng.uniform(-1, 1, 3).astype(np.float32)
            photo = photo * (1 - blob[..., None]) + color * blob[..., None]
        photo = np.clip(photo, -1, 1).astype(np.float32)
        lum = photo.mean(axis=-1)
        gy = np.abs(np.gradient(lum, axis=0))
        gx = np.abs(np.gradient(lum, axis=1))
        edges = np.clip((gx + gy) * 8.0, 0, 1) * 2.0 - 1.0
        edges = np.repeat(edges[..., None], 3, axis=2).astype(np.float32)
        return edges, photo, f"synthetic-paired://{index}"


def write_aligned_folder(dataset, out_dir, phase: str = "train") -> Path:
    """Dump a paired dataset as pix2pix aligned A|B png files (test helper
    and the bridge from synthetic data to the file-based CLI path)."""
    from de_i2i_gan_torch.utils.png import write_png
    d = Path(out_dir) / phase
    d.mkdir(parents=True, exist_ok=True)
    for i in range(len(dataset)):
        a, b, _ = dataset[i]
        ab = np.concatenate([a, b], axis=1)
        arr = np.clip((ab + 1) * 127.5, 0, 255).astype(np.uint8)
        write_png(d / f"{i:05d}.png", arr)
    return d.parent


class PairedLoader:
    """Shuffling prefetch loader yielding {'input', 'target'} numpy batches
    with an optional leading (iters_per_launch,) axis for the scan-based
    super step."""

    def __init__(self, dataset, batch_size: int, *, shuffle: bool = True,
                 drop_last: bool = True, seed: int = 123,
                 iters_per_launch: int = 1, prefetch: int = 4):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.iters_per_launch = iters_per_launch
        self.prefetch = prefetch
        self._epoch = 0

    def __len__(self):
        n = len(self.dataset) // self.batch_size if self.drop_last else \
            -(-len(self.dataset) // self.batch_size)
        return n // self.iters_per_launch if self.iters_per_launch > 1 else n

    def _batches(self) -> Iterator[Dict[str, np.ndarray]]:
        rng = np.random.default_rng(self.seed + self._epoch)
        idx = rng.permutation(len(self.dataset)) if self.shuffle \
            else np.arange(len(self.dataset))
        nb = len(idx) // self.batch_size if self.drop_last else \
            -(-len(idx) // self.batch_size)
        for b in range(nb):
            chunk = idx[b * self.batch_size:(b + 1) * self.batch_size]
            samples = [self.dataset[int(i)] for i in chunk]
            yield {"input": np.stack([s[0] for s in samples]),
                   "target": np.stack([s[1] for s in samples])}

    def __iter__(self):
        import queue
        import threading
        self._epoch += 1
        if hasattr(self.dataset, "_epoch_salt"):
            self.dataset._epoch_salt = self._epoch
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def produce():
            try:
                group = []
                for batch in self._batches():
                    if stop.is_set():
                        return
                    if self.iters_per_launch <= 1:
                        out_q.put(batch)
                        continue
                    group.append(batch)
                    if len(group) == self.iters_per_launch:
                        out_q.put({k: np.stack([g[k] for g in group])
                                   for k in group[0]})
                        group = []
            finally:
                out_q.put(None)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item = out_q.get()
                if item is None:
                    break
                yield item
        finally:
            stop.set()
