"""ctypes bindings and cache builder for the C++ data-loading runtime
(``runtime/dataloader.cc``), counterpart of
``de_i2i_gan_tpu/runtime/native_loader.py``.

Flow:
  1. ``build_cache(dataset, cache_dir)`` decodes every image once into a
     flat uint8 HWC cache plus a binary index. Sources larger than
     ``max_side`` are shrunk first (the reference resizes to 1.5x the crop
     size anyway, train_defectgan.py:58).
  2. ``NativeDataLoader`` drives the library: C++ threads mmap the cache and
     stream augmented NHWC batches (float32, or u8 for a quarter of the
     host-to-device bytes); Python makes one call per batch, with the
     interpreter lock released (``ctypes.CDLL``).
  3. ``NativeDualStreamLoader`` fills the (num_critics, B, S, S, 3) u8
     super-batches of the ``--native_loader`` DefectGAN feed in place,
     ``NativeSuperBatchLoader`` the single-stream ``{imgs, labels}`` ones of
     the MAE and WGAN feeds, and ``PairedNativeLoader`` pix2pix's u8
     ``{pair}`` batches (input and target on 6 channels, one crop and flip
     for both: ``aug_mode=2``); the trainer's ``device_prefetch`` copies
     them to the card and the step's ``batch_images_to_float`` normalizes
     (and splits) them there. ``EpochView`` gives the infinite stream an
     epoch's length (``make_native_loader``).

The library is built with g++ at first use into ``build/de_i2i_gan_torch/``
beside the package, named by a hash of the source, the flags and the host
(``-march=native`` builds for the CPU it runs on); importing this module
builds nothing. A build that fails raises with the compiler's
output: there is no fallback to the Python pipeline.
"""
from __future__ import annotations

import ctypes
import hashlib
import json
import os
import platform
import shutil
import struct
import subprocess
from pathlib import Path
from typing import Iterator, Optional, Tuple

import numpy as np

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "runtime" / "dataloader.cc"
BUILD_DIR = _PKG.parent / "build" / "de_i2i_gan_torch"
CXX = "g++"
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC")
_MAGIC = 0xD16D16D1

_lib = None  # the loaded library, once built


def _library_path() -> Path:
    """Build output named by a hash of the source, flags and host, so an
    edited source, or a tree copied to another machine, never loads a stale
    library."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    h.update(f"{platform.machine()} {platform.node()}".encode())
    return BUILD_DIR / f"libdig_loader_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``dataloader.cc`` with g++; raises if g++ is missing or fails."""
    compiler = shutil.which(CXX)
    if compiler is None:
        raise RuntimeError(f"{CXX} not found on PATH: the native loader "
                           "(--native_loader) cannot be built")
    out = _library_path()
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([compiler, *CXX_FLAGS, "-o", str(tmp), str(SOURCE),
                           "-lpthread"], capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{CXX} failed ({proc.returncode}) building the "
                           f"native loader:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent build never loads a torn file
    return out


def _load_lib():
    global _lib
    if _lib is None:
        path = _library_path()
        if not path.exists():
            path = build()
        lib = ctypes.CDLL(str(path))
        lib.dl_create.restype = ctypes.c_void_p
        lib.dl_create.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                  ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                  ctypes.c_uint64, ctypes.c_int,
                                  ctypes.c_float]
        lib.dl_next.restype = ctypes.c_int
        lib.dl_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
                                ctypes.POINTER(ctypes.c_float)]
        lib.dl_next_u8.restype = ctypes.c_int
        lib.dl_next_u8.argtypes = [ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_uint8),
                                   ctypes.POINTER(ctypes.c_float)]
        lib.dl_label_nc.restype = ctypes.c_int
        lib.dl_label_nc.argtypes = [ctypes.c_void_p]
        lib.dl_n_items.restype = ctypes.c_uint
        lib.dl_n_items.argtypes = [ctypes.c_void_p]
        lib.dl_destroy.restype = None
        lib.dl_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
    return _lib


def build_cache(dataset, cache_dir: Path, max_side: Optional[int] = None,
                channels: int = 3,
                value_range: Optional[str] = None) -> Tuple[Path, Path]:
    """Decode a map-style dataset (items: (image, label, path); images as
    PIL images, uint8 or float arrays) into the raw cache; returns the
    cache and index paths. The bytes are the JAX package's.

    ``value_range``: "pm1" (floats in [-1, 1]), "01" (floats in [0, 1]) or
    None (per-image guess from the minimum, which misreads a bright [-1, 1]
    image whose minimum is >= -0.01).

    An existing cache is reused only when its ``meta.json`` fingerprint
    (item count, channels, first item's shape, max_side, value_range)
    matches; otherwise it is rebuilt.
    """
    cache_dir = Path(cache_dir)
    cache_dir.mkdir(parents=True, exist_ok=True)
    cache_path = cache_dir / "images.u8"
    index_path = cache_dir / "index.bin"
    meta_path = cache_dir / "meta.json"
    img0, _, _ = dataset[0]
    fingerprint = {
        "version": 2,
        "n_items": len(dataset),
        "channels": channels,
        "max_side": max_side,
        "value_range": value_range or "auto",
        "first_item_shape": list(np.asarray(img0).shape),
    }
    if cache_path.exists() and index_path.exists():
        try:
            if json.loads(meta_path.read_text()) == fingerprint:
                return cache_path, index_path
        except (OSError, ValueError):
            pass  # no or unreadable fingerprint: rebuild
        print(f"[native_loader] cache at {cache_dir} does not match the "
              "requested dataset; rebuilding")
        meta_path.unlink(missing_ok=True)

    entries = []
    with cache_path.open("wb") as f:
        offset = 0
        for i in range(len(dataset)):
            img, label, _ = dataset[i]
            arr = np.asarray(img)
            if arr.dtype != np.uint8:
                a = arr.astype(np.float32)
                vr = value_range or ("pm1" if a.min() < -0.01 else "01")
                if vr == "pm1":
                    a = (a + 1.0) / 2.0
                arr = np.clip(a * 255.0, 0, 255).astype(np.uint8)
            if arr.ndim == 2:
                arr = np.repeat(arr[..., None], channels, axis=2)
            if max_side and max(arr.shape[:2]) > max_side:
                from PIL import Image
                im = Image.fromarray(arr)
                scale = max_side / max(arr.shape[:2])
                im = im.resize((max(1, round(im.width * scale)),
                                max(1, round(im.height * scale))))
                arr = np.asarray(im)
            h, w = arr.shape[:2]
            data = np.ascontiguousarray(arr[:, :, :channels]).tobytes()
            f.write(data)
            entries.append((offset, h, w, np.asarray(label, np.float32)))
            offset += len(data)

    label_nc = len(entries[0][3])
    with index_path.open("wb") as f:
        f.write(struct.pack("<IIII", _MAGIC, len(entries), label_nc, channels))
        for offset, h, w, label in entries:
            f.write(struct.pack("<Qii", offset, h, w))
            f.write(label.tobytes())
    meta_path.write_text(json.dumps(fingerprint))
    return cache_path, index_path


class NativeDataLoader:
    """Infinite augmented-batch stream from the C++ runtime. Augmentation
    modes (``aug_mode``, by default ``int(augment)``): 0 center crops; 1
    random resized crops, flips and color jitter (DefectGAN's training
    transform); 2 one random crop of ``crop_frac`` of the side and one
    horizontal flip for all channels of a sample (pix2pix's paired
    transform, no jitter). With one thread and one seed the batches are
    the JAX package's, bit for bit; with more, their order depends on which
    thread finishes first.
    """

    def __init__(self, cache_path: Path, index_path: Path, image_size: int,
                 batch_size: int, num_threads: int = 2, seed: int = 123,
                 augment: bool = True, channels: int = 3,
                 output_u8: bool = False, aug_mode: Optional[int] = None,
                 crop_frac: float = 256 / 286):
        lib = _load_lib()
        self._lib = lib
        mode = int(augment) if aug_mode is None else aug_mode
        # the crop fraction is fixed before the C++ threads start (the JAX
        # package sets it after, so its first batches may crop with the
        # default 256/286)
        self._handle = lib.dl_create(
            str(cache_path).encode(), str(index_path).encode(), image_size,
            batch_size, num_threads, seed, mode, float(crop_frac))
        if not self._handle:
            raise RuntimeError(f"the native loader could not open the cache "
                               f"{cache_path} / {index_path}")
        self.batch_size = batch_size
        self.image_size = image_size
        self.channels = channels
        self.output_u8 = output_u8
        self.label_nc = lib.dl_label_nc(self._handle)
        self.n_items = lib.dl_n_items(self._handle)
        self.dtype = np.uint8 if output_u8 else np.float32

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        s = self.image_size
        img = np.empty((self.batch_size, s, s, self.channels), self.dtype)
        lbl = np.empty((self.batch_size, self.label_nc), np.float32)
        self.next_into(img, lbl)
        return img, lbl, []

    def next_into(self, img_out: np.ndarray, lbl_out: np.ndarray) -> None:
        """Fill caller-provided C-contiguous buffers in place: the C++
        workers' batch is copied straight into them."""
        s = self.image_size
        want = ((self.batch_size, s, s, self.channels), self.dtype,
                (self.batch_size, self.label_nc))
        if ((img_out.shape, img_out.dtype, lbl_out.shape) != want
                or lbl_out.dtype != np.float32 or not img_out.flags.c_contiguous
                or not lbl_out.flags.c_contiguous):
            raise ValueError(f"buffers must be C-contiguous {want[0]} "
                             f"{np.dtype(want[1])} and {want[2]} float32")
        if self._handle is None:
            raise RuntimeError("the native loader is closed")
        lbl_ptr = lbl_out.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        if self.output_u8:
            rc = self._lib.dl_next_u8(
                self._handle,
                img_out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), lbl_ptr)
        else:
            rc = self._lib.dl_next(
                self._handle,
                img_out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), lbl_ptr)
        if rc != 0:
            raise StopIteration

    def close(self):
        """Stop and join the C++ threads. Not while another thread is
        inside ``next_into``."""
        if self._handle:
            self._lib.dl_destroy(self._handle)
            self._handle = None

    def __del__(self):
        if getattr(self, "_handle", None):
            self.close()


class EpochView:
    """A finite, ``data.pipeline.DataLoader``-shaped view of the infinite
    native stream: ``batches_per_epoch`` batches an iteration (default: the
    cache's items over the batch size)."""

    def __init__(self, loader: NativeDataLoader,
                 batches_per_epoch: Optional[int] = None):
        self.loader = loader
        self.batch_size = loader.batch_size
        self._n = batches_per_epoch or max(1, loader.n_items // loader.batch_size)

    def __len__(self):
        return self._n

    def __iter__(self) -> Iterator:
        for _ in range(self._n):
            yield next(self.loader)


class NativeDualStreamLoader:
    """Defect and background super-batches straight from the C++ runtime,
    the native counterpart of ``data.pipeline.DualStreamLoader`` (one
    defect batch per D sub-step, defectgan_trainer.py:96-109).

    Each super-batch is a fresh set of contiguous u8 arrays that the
    workers fill in place: no ``np.stack``, and no buffer is reused while
    a consumer may still hold it."""

    def __init__(self, df: NativeDataLoader, bg: NativeDataLoader,
                 num_critics: int):
        if not (df.output_u8 and bg.output_u8):
            raise ValueError("the super-batch feed is u8 only")
        self.df, self.bg = df, bg
        self.num_critics = num_critics

    def __len__(self):
        return max(1, self.df.n_items // self.df.batch_size // self.num_critics)

    def __iter__(self) -> Iterator:
        nc, b, s = self.num_critics, self.df.batch_size, self.df.image_size
        bg_lbl = np.empty((b, self.bg.label_nc), np.float32)
        for _ in range(len(self)):
            dfs = np.empty((nc, b, s, s, 3), np.uint8)
            bgs = np.empty((nc, b, s, s, 3), np.uint8)
            lbls = np.empty((nc, b, self.df.label_nc), np.float32)
            for j in range(nc):
                self.df.next_into(dfs[j], lbls[j])
                self.bg.next_into(bgs[j], bg_lbl)
            yield {"df": dfs, "bg": bgs, "df_labels": lbls}

    def close(self):
        self.df.close()
        self.bg.close()


def make_native_dual_stream(df_dataset, bg_dataset, cache_root: Path,
                            image_size: int, batch_size: int,
                            num_critics: int, seed: int = 123,
                            num_threads: int = 4,
                            value_range: Optional[str] = None
                            ) -> NativeDualStreamLoader:
    """Cache both streams (untransformed items: the C++ side does the random
    resized crop, flips and jitter) under ``cache_root``/{defects,background}
    and return the in-place super-batch loader (the ``--native_loader``
    DefectGAN feed)."""
    df_cache, df_index = build_cache(df_dataset, Path(cache_root) / "defects",
                                     max_side=image_size * 2,
                                     value_range=value_range)
    bg_cache, bg_index = build_cache(bg_dataset,
                                     Path(cache_root) / "background",
                                     max_side=image_size * 2,
                                     value_range=value_range)
    df = NativeDataLoader(df_cache, df_index, image_size, batch_size,
                          num_threads=num_threads, seed=seed, output_u8=True)
    bg = NativeDataLoader(bg_cache, bg_index, image_size, batch_size,
                          num_threads=num_threads, seed=seed + 1,
                          output_u8=True)
    return NativeDualStreamLoader(df, bg, num_critics)


class NativeSuperBatchLoader:
    """Single-stream ``{key, "labels"}`` super-batches with a leading
    (num_critics,) axis, filled in place: the native counterpart of
    ``data.pipeline.SuperBatchLoader`` (the MAE feed), the same fresh u8
    arrays a super-batch as ``NativeDualStreamLoader``."""

    def __init__(self, loader: NativeDataLoader, num_critics: int,
                 key: str = "imgs"):
        if not loader.output_u8:
            raise ValueError("the super-batch feed is u8 only")
        self.loader = loader
        self.num_critics = num_critics
        self.key = key

    def __len__(self):
        return max(1, self.loader.n_items // self.loader.batch_size
                   // self.num_critics)

    def __iter__(self) -> Iterator:
        ld = self.loader
        nc, b, s = self.num_critics, ld.batch_size, ld.image_size
        for _ in range(len(self)):
            imgs = np.empty((nc, b, s, s, ld.channels), np.uint8)
            lbls = np.empty((nc, b, ld.label_nc), np.float32)
            for j in range(nc):
                ld.next_into(imgs[j], lbls[j])
            yield {self.key: imgs, "labels": lbls}

    def close(self):
        self.loader.close()


def make_native_super_batch(dataset, cache_dir: Path, image_size: int,
                            batch_size: int, num_critics: int,
                            seed: int = 123, num_threads: int = 4,
                            key: str = "imgs",
                            value_range: Optional[str] = None
                            ) -> NativeSuperBatchLoader:
    """Cache one stream (untransformed items) under ``cache_dir`` and return
    the in-place super-batch loader (the ``--native_loader`` MAE feed)."""
    cache, index = build_cache(dataset, Path(cache_dir),
                               max_side=image_size * 2,
                               value_range=value_range)
    native = NativeDataLoader(cache, index, image_size, batch_size,
                              num_threads=num_threads, seed=seed,
                              output_u8=True)
    return NativeSuperBatchLoader(native, num_critics, key=key)


def make_native_loader(dataset, cache_dir: Path, image_size: int,
                       batch_size: int, seed: int = 123,
                       num_threads: int = 4, augment: bool = True,
                       max_side: Optional[int] = None,
                       output_u8: bool = True,
                       value_range: Optional[str] = None) -> EpochView:
    """Cache ``dataset`` (untransformed items: the C++ side does the random
    resized crop and flips) under ``cache_dir`` and return an epoch of
    ``len(dataset) // batch_size`` batches over the infinite stream, as
    ``(images, labels, [])`` tuples. ``max_side`` defaults to twice the
    crop; ``output_u8`` (default) ships u8 batches that the steps normalize
    on the device."""
    cache, index = build_cache(dataset, Path(cache_dir),
                               max_side=max_side or image_size * 2,
                               value_range=value_range)
    native = NativeDataLoader(cache, index, image_size, batch_size,
                              num_threads=num_threads, seed=seed,
                              augment=augment, output_u8=output_u8)
    return EpochView(native, batches_per_epoch=len(dataset) // batch_size)


class RawPairView:
    """A paired dataset (items: (input, target, path)) as (H, W, 6) samples
    for the native cache, input and target on the channels, so the C++
    side's crop window and flip apply to both halves alike."""

    def __init__(self, dataset):
        self.dataset = dataset

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, index: int):
        a, b, path = self.dataset[index]
        pair = np.concatenate([np.asarray(a), np.asarray(b)], axis=-1)
        return pair, np.zeros(1, np.float32), path


class PairedNativeLoader:
    """Paired u8 batches from the C++ runtime (``aug_mode=2``), the native
    counterpart of ``data.paired.PairedLoader``, with a leading
    (iters_per_launch,) axis when it is above 1: ``{"pair": u8[..., 6]}``,
    a fresh contiguous array a launch that the workers fill in place (one
    host-to-device copy); the steps split input and target on the device
    (``ops/fused.py::batch_images_to_float``)."""

    def __init__(self, loader: NativeDataLoader, n_pairs: int,
                 iters_per_launch: int = 1):
        if loader.channels != 6:
            raise ValueError("the paired cache has 6 channels")
        self.loader = loader
        self.iters_per_launch = iters_per_launch
        self.batch_size = loader.batch_size
        self._n = max(1, n_pairs // loader.batch_size
                      // max(iters_per_launch, 1))

    def __len__(self):
        return self._n

    def __iter__(self) -> Iterator:
        ipl = max(self.iters_per_launch, 1)
        ld = self.loader
        s = ld.image_size
        lbl = np.empty((ld.batch_size, ld.label_nc), np.float32)
        for _ in range(self._n):
            group = np.empty((ipl, ld.batch_size, s, s, 6), ld.dtype)
            for j in range(ipl):
                ld.next_into(group[j], lbl)
            yield {"pair": group[0] if ipl == 1 else group}

    def close(self):
        self.loader.close()


def make_paired_native_loader(dataset, cache_dir: Path, image_size: int,
                              batch_size: int, *, load_size: int = 286,
                              seed: int = 123, num_threads: int = 4,
                              iters_per_launch: int = 1,
                              augment: bool = True
                              ) -> PairedNativeLoader:
    """Cache a paired dataset (items: (input, target, path) in [-1, 1], no
    host-side augmentation) as 6-channel samples under ``cache_dir`` and
    stream augmented u8 pairs: ``crop_frac = image_size / load_size``
    reproduces pix2pix's resize(load_size) -> random crop(crop_size) on the
    cached pair."""
    cache, index = build_cache(RawPairView(dataset), Path(cache_dir),
                               channels=6, value_range="pm1")
    native = NativeDataLoader(
        cache, index, image_size, batch_size, num_threads=num_threads,
        seed=seed, channels=6, output_u8=True,
        aug_mode=2 if augment else 0,
        crop_frac=min(image_size / max(load_size, image_size), 1.0))
    return PairedNativeLoader(native, len(dataset),
                              iters_per_launch=iters_per_launch)
