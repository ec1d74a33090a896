"""Share of the traced window's StarGAN v2 iterations that replayed a CUDA
graph, in %, as ``host.graph_replay_pct.train`` reads it: the program's
counter source ``train.graph_replays`` over the ``train.super_step`` spans.
Nothing to read where the program opens no ``train.super_step`` span in
its iteration (a commit before it) or has no such counter."""
from perfbench.lib import spans, spec


def read(summary: dict):
    if spans.ROOT not in (spans.program_report() or {}):
        return None
    return spec.metric_reader("host.graph_replay_pct.train")(summary)
