"""Device ms an iteration inside the program's ``sgv2.r1`` spans: the
``create_graph`` gradient of D's output on the real images that R1 takes, in
each of the two D updates (the backward through that gradient is in
``train.backward``). Nothing to read where the program opens no
``train.super_step`` span in its iteration (a commit before it)."""
from perfbench.lib import spans


def read(summary: dict):
    if spans.ROOT not in (spans.program_report() or {}):
        return None
    return spans.per_step(summary, spans.device_ms("sgv2.r1"))
