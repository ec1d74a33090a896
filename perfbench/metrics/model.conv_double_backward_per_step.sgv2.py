"""Second backward calls of the twice-differentiable convolution a StarGAN
v2 iteration (``nn/conv_grad.py``: each of D's convolutions in each of the
iteration's two R1 penalties): the program's counter source
``conv.double_backward`` over the ``train.super_step`` spans. Nothing to
read where the program has no such counter, or opens no
``train.super_step`` span in its iteration (a commit before either)."""
from perfbench.lib import spans


def read(summary: dict):
    if spans.ROOT not in (spans.program_report() or {}):
        return None
    return spans.per_step(summary, spans.counter("conv.double_backward"))
