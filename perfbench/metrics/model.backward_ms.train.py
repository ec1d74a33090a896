"""Device ms a super-step inside the program's ``train.backward`` spans: the
backward passes of the D and G updates (padding backward, dgrad and wgrad
convolutions), idle inside them included."""
from perfbench.lib import spans


def read(summary: dict):
    return spans.per_step(summary, spans.device_ms("train.backward"))
