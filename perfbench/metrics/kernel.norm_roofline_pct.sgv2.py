"""The norm kernels' share of their roofline in the StarGAN v2 iteration, as
``kernel.norm_roofline_pct.train`` reads it: the bound of the reference's 96
AdaIN norm calls (48 with a backward) over the device time of the kernels
named modulated_instance_norm_*."""
from perfbench.lib import spec


def read(summary: dict):
    return spec.metric_reader("kernel.norm_roofline_pct.train")(summary)
