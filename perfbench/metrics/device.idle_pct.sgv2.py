"""Share of the StarGAN v2 traced window in which no kernel, memcpy or
memset runs on the device, as ``device.idle_pct.train`` reads it."""
from perfbench.lib import spec


def read(summary: dict):
    return spec.metric_reader("device.idle_pct.train")(summary)
