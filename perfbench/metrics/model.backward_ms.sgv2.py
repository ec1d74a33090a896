"""Device ms an iteration inside the program's ``train.backward`` spans, as
``model.backward_ms.train`` reads them: the four backward passes of StarGAN
v2's iteration, D's with R1's double backward, idle inside them included.
Nothing to read where the program opens no ``train.super_step`` span in its
iteration (a commit before it)."""
from perfbench.lib import spans, spec


def read(summary: dict):
    if spans.ROOT not in (spans.program_report() or {}):
        return None
    return spec.metric_reader("model.backward_ms.train")(summary)
