"""Device ms a super-step inside the program's ``train.g_step`` span: the
G update, E and the two fused G hops, the frozen D, the backward and the
two Adams, idle inside it included."""
from perfbench.lib import spans


def read(summary: dict):
    return spans.per_step(summary, spans.device_ms("train.g_step"))
