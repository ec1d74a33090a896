"""Device ms a super-step inside the program's ``train.d_step`` spans: the
5 D updates, each the no-grad E and G forwards for the fakes, D's 4B
forward, the backward and Adam, idle inside them included."""
from perfbench.lib import spans


def read(summary: dict):
    return spans.per_step(summary, spans.device_ms("train.d_step"))
