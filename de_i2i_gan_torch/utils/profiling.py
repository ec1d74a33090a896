"""Tracing and step timing, counterpart of ``de_i2i_gan_tpu/utils/profiling.py``:

- ``trace(log_dir)``: ``torch.profiler`` over a code region (the CPU, and
  the card when there is one), written as a Chrome trace
  ``<log_dir>/trace.json``
- ``StepTimer``: host clock a step with a warmup skip and the JAX
  function's summary (``mean_s``, ``p50_s``, ``p95_s``, ``n``); a timed
  region ends in ``torch.cuda.synchronize()`` where the JAX timer fetches a
  value, so the time covers the device's work
- ``start_trace_server``: JAX's live profiler endpoint has no PyTorch
  counterpart; it raises
"""
from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch


def start_trace_server(port: int = 9999) -> None:
    raise NotImplementedError(
        "start_trace_server: jax.profiler's live endpoint has no PyTorch "
        "counterpart; record a region with utils.profiling.trace instead")


@contextlib.contextmanager
def trace(log_dir: str | Path = "./logs/torch_trace"):
    """Profile the region (CPU, and CUDA when available) and write
    ``<log_dir>/trace.json``; yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(log_dir / "trace.json"))


class StepTimer:
    """``with timer:`` around each step; the first ``warmup`` are not
    kept. The region ends in a synchronize of the CUDA device when CUDA is
    in use, so the host clock covers the device's work."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self.times: List[float] = []
        self._t0: Optional[float] = None
        self._n = 0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        dt = time.perf_counter() - self._t0
        self._n += 1
        if self._n > self.warmup:
            self.times.append(dt)

    def summary(self) -> dict:
        if not self.times:
            return {}
        a = np.asarray(self.times)
        return {"mean_s": float(a.mean()), "p50_s": float(np.percentile(a, 50)),
                "p95_s": float(np.percentile(a, 95)), "n": len(a)}
