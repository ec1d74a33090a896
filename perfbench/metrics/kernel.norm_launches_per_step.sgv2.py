"""Norm kernel launches a StarGAN v2 iteration, forward and backward, as
``kernel.norm_launches_per_step.train`` reads them: the program's counter
source ``norm.launches`` over the ``train.super_step`` spans. Nothing to
read where the program opens no ``train.super_step`` span in its iteration
(a commit before it)."""
from perfbench.lib import spans, spec


def read(summary: dict):
    if spans.ROOT not in (spans.program_report() or {}):
        return None
    return spec.metric_reader("kernel.norm_launches_per_step.train")(summary)
