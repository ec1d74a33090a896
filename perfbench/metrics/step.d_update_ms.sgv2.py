"""Device ms an iteration inside the program's ``train.d_step`` spans, as
``step.d_update_ms.train`` reads them: StarGAN v2's two D updates (latent
and reference), each with the no-grad fakes, R1's double backward and Adam,
idle inside them included. Nothing to read where the program opens no
``train.super_step`` span in its iteration (a commit before it)."""
from perfbench.lib import spans, spec


def read(summary: dict):
    if spans.ROOT not in (spans.program_report() or {}):
        return None
    return spec.metric_reader("step.d_update_ms.train")(summary)
