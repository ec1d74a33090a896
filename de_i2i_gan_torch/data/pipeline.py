"""Input pipeline, counterpart of ``de_i2i_gan_tpu/data/pipeline.py``.

Threaded prefetching loaders, copies of the JAX package's (they replace
the reference's torch DataLoader with 4 worker processes,
defectGAN/train_defectgan.py:75-77, and its restart-on-exhaustion
iterator, loaders/infinite_loader.py:4-20):
  * a thread decodes/augments ahead into a bounded queue
  * batches are contiguous NHWC numpy arrays
  * ``DualStreamLoader`` packages the defect + infinite background streams
    into the (num_critics, B, ...) super-batches consumed by
    ``DefectGanSteps.super_step``

``device_prefetch`` moves super-batches to the card ahead of the step:
a producer thread copies each into pinned host buffers and issues
``non_blocking`` copies on a side CUDA stream, so the host fetch and the
copy of batch k+1 overlap the step on batch k. The C++ loader
(``--native_loader``, ``runtime/native_loader.py``) feeds it u8
super-batches, which the step normalizes on the device.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np
import torch


def _collate(samples):
    imgs = np.stack([s[0] for s in samples])
    labels = np.stack([s[1] for s in samples])
    paths = [s[2] for s in samples]
    return imgs, labels, paths


class DataLoader:
    """Shuffling, prefetching batch loader over a map-style dataset."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 drop_last: bool = True, seed: int = 123,
                 num_samples: Optional[int] = None, prefetch: int = 4,
                 num_threads: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.num_samples = num_samples
        self.prefetch = prefetch
        self.num_threads = num_threads
        self._epoch = 0

    def __len__(self):
        n = self.num_samples or len(self.dataset)
        n = min(n, len(self.dataset)) if not self.num_samples else n
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _indices(self) -> np.ndarray:
        n = len(self.dataset)
        rng = np.random.default_rng(self.seed + self._epoch)
        idx = rng.permutation(n) if self.shuffle else np.arange(n)
        if self.num_samples is not None:
            reps = max(1, -(-self.num_samples // n))
            idx = np.concatenate([idx] * reps)[:self.num_samples]
        return idx

    def __iter__(self) -> Iterator:
        idx = self._indices()
        self._epoch += 1
        nb = len(idx) // self.batch_size if self.drop_last else \
            (len(idx) + self.batch_size - 1) // self.batch_size
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def _put(item) -> bool:
            # bounded-timeout put so the producer notices an abandoned
            # consumer (generator closed/GC'd after a partial read, e.g. a
            # single next() for a fixed val batch) instead of blocking in
            # put() forever and leaking the thread + pinned batches
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                for b in range(nb):
                    if stop.is_set():
                        return
                    chunk = idx[b * self.batch_size:(b + 1) * self.batch_size]
                    if not _put(_collate([self.dataset[int(i)]
                                          for i in chunk])):
                        return
            finally:
                _put(None)

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


class InfiniteLoader:
    """Auto-restarting iterator (loaders/infinite_loader.py)."""

    def __init__(self, loader: DataLoader):
        self.loader = loader
        self._it = iter(loader)

    def __iter__(self):
        return self

    def __next__(self):
        try:
            return next(self._it)
        except StopIteration:
            self._it = iter(self.loader)
            return next(self._it)


class SuperBatchLoader:
    """Single-stream super-batches {'imgs', 'labels'} with leading
    (num_critics,) axis — the MAE / WGAN feeding shape."""

    def __init__(self, loader: DataLoader, num_critics: int,
                 key: str = "imgs"):
        self.loader = loader
        self.num_critics = num_critics
        self.key = key

    def __len__(self):
        return len(self.loader) // self.num_critics

    def __iter__(self):
        it = iter(self.loader)
        while True:
            imgs, labels = [], []
            try:
                for _ in range(self.num_critics):
                    im, lb, _ = next(it)
                    imgs.append(im)
                    labels.append(lb)
            except StopIteration:
                return
            yield {self.key: np.stack(imgs), "labels": np.stack(labels)}


def _host_tensors(batch: Dict) -> Dict[str, torch.Tensor]:
    """A host super-batch as CPU tensors sharing its arrays' memory."""
    return {k: torch.as_tensor(v) for k, v in batch.items()}


class _PinnedCopier:
    """Host super-batch -> device tensors: a ring of pinned host buffers and
    one side stream. A slot's buffers are refilled only after the copy that
    last read them has completed (its event)."""

    def __init__(self, device: torch.device, slots: int):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.slots = [({}, None) for _ in range(slots)]
        self.next = 0

    def __call__(self, batch: Dict):
        i = self.next % len(self.slots)
        self.next += 1
        pinned, done = self.slots[i]
        if done is not None:
            done.synchronize()
        out = {}
        with torch.cuda.stream(self.stream):
            for k, v in batch.items():
                host = torch.as_tensor(v)
                buf = pinned.get(k)
                if buf is None or buf.shape != host.shape or buf.dtype != host.dtype:
                    buf = pinned[k] = torch.empty(host.shape, dtype=host.dtype,
                                                  pin_memory=True)
                buf.copy_(host)
                # allocated on the side stream, read on the consumer's:
                # record_stream in ``receive`` keeps the allocator from
                # reusing the block before the consumer is done
                out[k] = buf.to(self.device, non_blocking=True)
            copied = torch.cuda.Event()
            copied.record(self.stream)
        self.slots[i] = (pinned, copied)
        return out, copied

    def receive(self, item) -> Dict[str, torch.Tensor]:
        """On the consumer's thread: its current stream waits for the copy."""
        batch, copied = item
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(copied)
        for t in batch.values():
            t.record_stream(stream)
        return batch


def device_prefetch(iterator, device="cuda", depth: int = 2):
    """Yield the dict super-batches of ``iterator`` as tensors on ``device``,
    ``depth`` ahead of the consumer (the port of the JAX package's
    ``device_prefetch``; no sharding: one device).

    A producer thread drives the loader. On a CUDA device it copies each
    batch into pinned host buffers and issues ``non_blocking`` copies on a
    side stream; the consumer's current stream waits on each batch's copy
    event before the batch is handed out. On the CPU it yields the same
    batches as tensors. A loader error reaches the consumer, raised where
    the batch would have been.
    """
    device = torch.device(device)
    if device.type == "cuda":
        copier = _PinnedCopier(device, depth + 2)
        to_device, consume = copier, copier.receive
    else:
        to_device, consume = _host_tensors, (lambda item: item)
    buf: "queue.Queue" = queue.Queue(maxsize=max(depth, 1))
    sentinel = object()
    err = []
    stop = threading.Event()

    def _put(item) -> bool:
        # bounded-timeout put so the producer can notice an abandoned
        # consumer (exception / break) and exit instead of blocking forever
        # and pinning the underlying loader's threads
        while not stop.is_set():
            try:
                buf.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def produce():
        try:
            for batch in iterator:
                if not _put(to_device(batch)):
                    return
        except BaseException as e:  # surface loader errors to the consumer
            err.append(e)
        finally:
            _put(sentinel)

    t = threading.Thread(target=produce, daemon=True)
    t.start()
    try:
        while True:
            item = buf.get()
            if item is sentinel:
                if err:
                    raise err[0]
                return
            yield consume(item)
    finally:
        stop.set()
        # drain so a producer mid-put unblocks promptly
        try:
            while True:
                buf.get_nowait()
        except queue.Empty:
            pass


class DualStreamLoader:
    """Defects + infinite background -> super-batches for super_step.

    Yields dict with leaves shaped (num_critics, B, ...): every D sub-step
    gets a fresh defect and background batch, matching the reference schedule
    (defectgan_trainer.py:96-109 consumes one defect batch per iteration).
    """

    def __init__(self, defect_loader: DataLoader, background_loader: DataLoader,
                 num_critics: int):
        self.defects = defect_loader
        self.background = InfiniteLoader(background_loader)
        self.num_critics = num_critics

    def __len__(self):
        return len(self.defects) // self.num_critics

    def __iter__(self):
        it = iter(self.defects)
        while True:
            dfs, bgs, lbls = [], [], []
            try:
                for _ in range(self.num_critics):
                    df_img, df_lbl, _ = next(it)
                    bg_img, _, _ = next(self.background)
                    dfs.append(df_img)
                    bgs.append(bg_img[:df_img.shape[0]])
                    lbls.append(df_lbl)
            except StopIteration:
                return
            yield {"df": np.stack(dfs), "bg": np.stack(bgs),
                   "df_labels": np.stack(lbls)}
