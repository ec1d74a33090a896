"""Reflect pad kernel launches a super-step, forward and backward: the
program's counter source ``pad.launches`` over the ``train.super_step``
spans. Nothing to read where the program has no such counter."""
from perfbench.lib import spans


def read(summary: dict):
    return spans.per_step(summary, spans.counter("pad.launches"))
