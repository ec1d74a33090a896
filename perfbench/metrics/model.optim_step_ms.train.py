"""Device ms a super-step inside the program's ``optim.step`` spans: the
optimizers' updates (D's 5, G's and E's), idle inside them included."""
from perfbench.lib import spans


def read(summary: dict):
    return spans.per_step(summary, spans.device_ms("optim.step"))
