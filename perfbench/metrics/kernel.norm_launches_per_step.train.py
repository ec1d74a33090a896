"""Norm kernel launches a super-step, forward and backward: the program's
counter source ``norm.launches`` over the ``train.super_step`` spans."""
from perfbench.lib import spans


def read(summary: dict):
    return spans.per_step(summary, spans.counter("norm.launches"))
