"""StarGAN v2's D through the twice-differentiable convolution of
``nn/conv_grad.py`` on the card (``gpu`` marker; skips without one), at the
AFHQ widths (256², ``max_conv_dim`` 512), batch 2. This file imports torch
and the port only. On the card:

    python -m pytest tests/test_torch_conv_grad_gpu.py -m gpu --noconftest -q

D's gradients of its loss with R1 (``d_loss_fn``'s real half: the logits'
BCE plus the penalty), with the D forward inside
``conv_grad.differentiated_twice()`` against the same forward outside it
(aten's double backward), from one set of he_init weights and inputs:

  * float32, cuDNN deterministic and TF32 off: each leaf's gap (the norm of
    the difference over the larger of the leaf's norm and the median
    leaf's) under 1e-4;
  * bfloat16, as the benchmark's cell trains: under 0.075, the upper
    reading of the bf16 witness's ``grad_gap`` in StarGAN v2's check
    (PERF.md §2), against which both paths round alike.

A profiled R1 double backward in the scope launches no kernel of cuDNN's
indexed implicit GEMM (``implicit_gemm_indexed``), the engine aten's weight
term runs on, and the counter source ``conv.double_backward`` reads 18 a
penalty: D's 18 convolutions.
"""
import contextlib
import math

import pytest
import torch

from de_i2i_gan_torch.losses.common import bce_logits, r1_penalty
from de_i2i_gan_torch.models.starganv2 import StarGANv2Discriminator
from de_i2i_gan_torch.nn import conv_grad
from de_i2i_gan_torch.utils import profiling

pytestmark = pytest.mark.gpu

BATCH, IMG, DOMAINS = 2, 256, 3
CONVS = 18  # from_rgb, 3 + 3 + 3 + 2 + 2 + 2 in the blocks, conv4, head
F32_GAP, BF16_GAP = 1e-4, 0.075
INDEXED = "implicit_gemm_indexed"


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    saved = (torch.backends.cudnn.deterministic, torch.backends.cudnn.allow_tf32)
    yield
    torch.backends.cudnn.deterministic, torch.backends.cudnn.allow_tf32 = saved


def _disc(dtype):
    torch.manual_seed(0)
    d = StarGANv2Discriminator(IMG, DOMAINS, 512, dtype=dtype).cuda()
    with torch.no_grad():
        for p in d.parameters():
            if p.dim() >= 2:
                p.normal_(0.0, math.sqrt(2.0 / p[0].numel()))
    return d


def _inputs():
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.rand((BATCH, IMG, IMG, 3), generator=gen, device="cuda") * 2 - 1
    y = torch.randint(0, DOMAINS, (BATCH,), generator=gen, device="cuda")
    return x, y


def _grads(d, x, y, scope):
    x = x.detach().requires_grad_()
    with conv_grad.differentiated_twice() if scope else contextlib.nullcontext():
        out = d(x, y)
    loss = bce_logits(out, torch.ones_like(out)) + r1_penalty(out, x)
    return torch.autograd.grad(loss, list(d.parameters()))


def _worst_gap(ref, got):
    norms = [float(r.float().norm()) for r in ref]
    median = sorted(norms)[len(norms) // 2]
    return max(float((g.float() - r.float()).norm()) / max(n, median)
               for r, g, n in zip(ref, got, norms))


@pytest.mark.parametrize("dtype,limit", [(torch.float32, F32_GAP),
                                         (torch.bfloat16, BF16_GAP)],
                         ids=["float32", "bfloat16"])
def test_r1_gradients_match_aten(card, dtype, limit):
    torch.backends.cudnn.deterministic = dtype == torch.float32
    torch.backends.cudnn.allow_tf32 = False
    d = _disc(dtype)
    x, y = _inputs()
    ref = _grads(d, x, y, scope=False)
    got = _grads(d, x, y, scope=True)
    gap = _worst_gap(ref, got)
    print(f"{dtype}: worst leaf gap {gap:.3g}")
    assert gap < limit


def test_r1_double_backward_skips_the_indexed_engine(card):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    d = _disc(torch.bfloat16)
    x, y = _inputs()
    _grads(d, x, y, scope=True)  # cuDNN's first-use choices
    read = profiling.REGISTRY.sources["conv.double_backward"]
    before = read()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _grads(d, x, y, scope=True)
        torch.cuda.synchronize()
    assert read() - before == CONVS
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    assert kernels, "the profiler saw no device kernels"
    indexed = [e.key for e in kernels if INDEXED in e.key]
    assert not indexed, indexed
