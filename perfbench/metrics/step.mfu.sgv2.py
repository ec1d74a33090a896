"""The whole StarGAN v2 iteration's share of the chip's bf16 peak, as
``step.mfu.train`` reads it: the FLOPs of the reference's iteration (R1's
double backward included), times the iterations of the unprofiled window,
over its seconds."""
from perfbench.lib import spec


def read(summary: dict):
    return spec.metric_reader("step.mfu.train")(summary)
