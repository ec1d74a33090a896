"""Share of the traced window's super-steps that replayed a CUDA graph, in
%: the program's counter source ``train.graph_replays`` over the
``train.super_step`` spans. Nothing to read where the program has no such
counter."""
from perfbench.lib import spans


def read(summary: dict):
    share = spans.per_step(summary, spans.counter("train.graph_replays"))
    return None if share is None else 100.0 * share
