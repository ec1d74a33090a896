"""The program's own spans and counters (``de_i2i_gan_torch/utils/
profiling.py``), as the per-layer metrics of training cells read them.

Spans record while a profiler runs, and in a run the only profiled region is
the traced window, so the registry holds that window's super-steps alone.
Each metric is a sum over the recorded spans of one name, over the count of
recorded ``train.super_step`` spans. Nothing to read (None): a serving run,
a program without the registry (a commit before it), a program that
recorded no spans, or a span or counter it did not record. The count of
super-steps recorded has to equal the summary's ``traced_steps``: a
mismatch means the spans record outside the window or miss part of it, and
raises.
"""
from __future__ import annotations

from typing import Callable, Optional

ROOT = "train.super_step"


def program_report() -> Optional[dict]:
    """The registry's report by span name, or None where the program has
    no registry or it recorded nothing."""
    try:
        from de_i2i_gan_torch.utils import profiling
    except ImportError:
        return None
    report = getattr(profiling, "report", None)
    if report is None:
        return None
    return report() or None


def per_step(summary: dict, value: Callable[[dict], Optional[float]]):
    """``value(report)`` over the recorded super-steps; see the module's
    docstring."""
    if summary["mode"] != "train":
        return None
    report = program_report()
    if report is None:
        return None
    steps = report.get(ROOT, {}).get("count", 0)
    if steps != summary["traced_steps"]:
        raise ValueError(f"{steps} {ROOT} spans recorded, "
                         f"{summary['traced_steps']} steps traced")
    v = value(report)
    return None if v is None else v / steps


def device_ms(name: str) -> Callable[[dict], Optional[float]]:
    """The summed device ms of the spans ``name``."""
    return lambda report: report.get(name, {}).get("device_ms")


def counter(name: str) -> Callable[[dict], Optional[float]]:
    """The summed change of the counter source ``name`` over the
    super-steps."""
    return lambda report: report[ROOT]["counters"].get(name)
