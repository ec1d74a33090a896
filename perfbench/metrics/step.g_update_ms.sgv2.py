"""Device ms an iteration inside the program's ``train.g_step`` spans, as
``step.g_update_ms.train`` reads them: StarGAN v2's two G updates, each with
the style or mapping pass, the second G pass for the diversity term, the
cycle pass, the backward and the Adams of G (and M and S on the latent
pass), idle inside them included. Nothing to read where the program opens no
``train.super_step`` span in its iteration (a commit before it)."""
from perfbench.lib import spans, spec


def read(summary: dict):
    if spans.ROOT not in (spans.program_report() or {}):
        return None
    return spec.metric_reader("step.g_update_ms.train")(summary)
