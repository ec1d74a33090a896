"""Failure detection and recovery, counterpart of
``de_i2i_gan_tpu/utils/guards.py`` (absent in the reference, whose only
fault tolerance is a NaN scrub in the generator forward).

- ``metrics_finite``: host check of a step's metric dict
- ``NaNGuard``: watches the training loop's step results; on a non-finite
  metric it (a) rolls the steps back to the last known-good snapshot
  (taken every ``snapshot_every`` accepted updates), (b) counts strikes
  and aborts after ``max_strikes`` consecutive failures, so a divergent
  run fails loudly.

The JAX guard takes and returns an immutable state; here the state lives in
a ``DefectGanSteps``. A snapshot is a detached copy, on the device, of the
``state_dict`` of G, E, D and ema_G, the optimizers' moments and counts,
and ``steps.step`` (``train/checkpoint.py::train_state``); a rollback loads
it back in place.
"""
from __future__ import annotations

import math
from typing import Any, Dict

from de_i2i_gan_torch.train.checkpoint import (
    clone_state, load_train_state, train_state)


def metrics_finite(metrics: Dict[str, Any]) -> bool:
    return all(math.isfinite(float(v)) for v in metrics.values())


class NaNGuard:
    def __init__(self, snapshot_every: int = 100, max_strikes: int = 3):
        self.snapshot_every = snapshot_every
        self.max_strikes = max_strikes
        self._snapshot = None
        self._strikes = 0
        self._step = 0
        self.restores = 0

    def update(self, steps, metrics: Dict[str, Any]) -> bool:
        """Whether the update that gave ``metrics`` is accepted; if not,
        ``steps`` now holds the last snapshot."""
        self._step += 1
        if metrics_finite(metrics):
            self._strikes = 0
            if self._snapshot is None or \
                    self._step % self.snapshot_every == 0:
                self._snapshot = clone_state(train_state(steps))
            return True
        self._strikes += 1
        self.restores += 1
        if self._strikes >= self.max_strikes:
            raise FloatingPointError(
                f"training diverged: {self._strikes} consecutive non-finite "
                f"steps (last metrics: { {k: float(v) for k, v in metrics.items()} })")
        if self._snapshot is not None:
            # copied in place: the snapshot stays intact for the next rollback
            load_train_state(steps, self._snapshot)
        return False
