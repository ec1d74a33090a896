"""The reflect pad kernels on the card (``gpu`` marker; skips without one).

This file imports torch, the port and ``chip_smoke.py``'s table of pads
only, so it also runs where flax (and with it the JAX package's models)
cannot be imported. On the card:

    python -m pytest tests/test_torch_pad_gpu.py -m gpu --noconftest -q

The forward is a copy, so it is held to ``F.pad`` (and, for pads at or
beyond the axis, which ``F.pad`` refuses, to the repeated-reflection
gathers of ``reflect_pad_ref``) bit for bit, at every pad shape of a
DefectGAN super-step at the benchmark cell's configuration
(``chip_smoke.PAD_CALLS``) and at ragged shapes. The backward is held to
the plain adjoint, the float32 sum of each element's terms rounded once
(``reflect_pad_bwd_ref``), within one ulp of the dtype plus twice the
float32 rounding of a sum of that many terms (the two sum in other
orders), and to itself bit for bit over two runs. A replayed super-step at the cell's
configuration counts 401 pad launches.
"""
import pytest
import torch
import torch.nn.functional as F

from de_i2i_gan_torch.nn.layers import pad_image
from de_i2i_gan_torch.ops.cuda import pad_kernels
from de_i2i_gan_torch.utils import profiling

from chip_smoke import PAD_CALLS

DTYPES = ["float32", "bfloat16"]
FWD_SHAPES = sorted({(s, p) for s, p, _, _ in PAD_CALLS})
BWD_SHAPES = sorted({(s, p) for s, p, bwd, _ in PAD_CALLS if bwd})
# odd widths (scalar loops), one-sided pads, pads at or beyond the axis
EDGE_SHAPES = [
    ((3, 5, 7, 9), (1, 1, 1, 1)), ((2, 3, 17, 13), (3, 3, 3, 3)),
    ((2, 4, 6, 10), (0, 2, 3, 0)), ((1, 2, 3, 4), (3, 3, 4, 5)),
    ((2, 3, 1, 1), (2, 2, 2, 2)), ((2, 2, 2, 2), (3, 0, 1, 4)),
    ((1, 3, 5, 16), (2, 2, 9, 17)), ((4, 8, 8, 8), (8, 7, 8, 7)),
]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _randn(shape, dtype, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def _padded(shape, pads):
    pt, pb, pl, pr = pads
    n, c, h, w = shape
    return (n, c, h + pt + pb, w + pl + pr)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
def test_forward_is_fpad_at_the_cell_shapes(dtype):
    """Bit for bit ``F.pad`` at every pad shape of the cell's super-step,
    through the wrapper and through ``pad_image``, one launch each."""
    _need_card()
    dt = getattr(torch, dtype)
    for i, (shape, pads) in enumerate(FWD_SHAPES):
        pt, pb, pl, pr = pads
        x = _randn(shape, dt, i)
        want = F.pad(x, (pl, pr, pt, pb), mode="reflect")
        before = pad_kernels.LAUNCHES
        y = pad_kernels.reflect_pad_fwd(x, pads)
        via_layer = pad_image(x, ((pt, pb), (pl, pr)), "reflect")
        torch.cuda.synchronize()
        assert pad_kernels.LAUNCHES == before + 2, shape
        assert torch.equal(y, want) and torch.equal(via_layer, want), shape
        del x, y, via_layer, want


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
def test_forward_at_ragged_and_wide_pads(dtype):
    """Odd widths, one-sided pads and pads at or beyond the axis, from an
    input that is not 16-byte aligned too: the plain version's gathers bit
    for bit."""
    _need_card()
    dt = getattr(torch, dtype)
    for i, (shape, pads) in enumerate(EDGE_SHAPES):
        x = _randn(shape, dt, 100 + i)
        want = pad_kernels.reflect_pad_ref(x, pads)
        assert torch.equal(pad_kernels.reflect_pad_fwd(x, pads), want), shape
        numel = x.numel()
        shifted = torch.empty(numel + 1, dtype=dt, device="cuda")[1:]
        shifted = shifted.view(shape).copy_(x)
        assert shifted.data_ptr() % 16 != 0
        assert torch.equal(pad_kernels.reflect_pad_fwd(shifted, pads), want)


def _bwd_band(dy, pads, h, w, dtype):
    """The plain adjoint, and how far the kernel may lie from it: one ulp of
    the dtype, plus each float32 sum's rounding, at most (terms - 1) ulps of
    the sum of the terms' magnitudes, twice (the two sum in other orders)."""
    ref = pad_kernels.reflect_pad_bwd_ref(dy, pads, h, w).float()
    size = pad_kernels.reflect_pad_bwd_ref(dy.float().abs(), pads, h, w)
    terms = pad_kernels.reflect_pad_bwd_ref(torch.ones_like(dy, dtype=torch.float32),
                                            pads, h, w)
    return ref, (torch.finfo(dtype).eps * ref.abs()
                 + 2 * terms * 2.0 ** -24 * size)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
def test_backward_is_the_adjoint_and_deterministic(dtype):
    """At the cell's backward shapes and the ragged and wide ones: within
    one ulp of the float32 sum rounded once (plus float32's ordering), and
    bit-identical over two runs."""
    _need_card()
    dt = getattr(torch, dtype)
    for i, (shape, pads) in enumerate(BWD_SHAPES + EDGE_SHAPES):
        h, w = shape[2:]
        dy = _randn(_padded(shape, pads), dt, 200 + i)
        before = pad_kernels.BWD_LAUNCHES
        dx = pad_kernels.reflect_pad_bwd(dy, pads, h, w)
        again = pad_kernels.reflect_pad_bwd(dy, pads, h, w)
        torch.cuda.synchronize()
        assert pad_kernels.BWD_LAUNCHES == before + 2
        assert dx.shape == shape and dx.dtype == dt
        ref, band = _bwd_band(dy, pads, h, w, dt)
        assert ((dx.float() - ref).abs() <= band).all(), shape
        assert torch.equal(dx, again), shape
        del dy, dx, again, ref, band


@pytest.mark.gpu
def test_autograd_and_double_backward_on_card():
    """Through a padded convolution in float32, cuDNN deterministic and
    without TF32: the gradient (the backward kernel) and the gradient of a
    gradient norm (the forward kernel again) against the same through
    ``F.pad``'s autograd on the card, within float32 rounding (the two pad
    backwards sum each element's few terms in other orders)."""
    _need_card()
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(2, 4, 9, 12, generator=gen)
    wt = torch.randn(3, 4, 3, 3, generator=gen)
    pads = (2, 1, 3, 2)
    pt, pb, pl, pr = pads
    out = {}
    saved = (torch.backends.cudnn.deterministic, torch.backends.cudnn.allow_tf32)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.allow_tf32 = True, False
    try:
        for name, pad in (("op", lambda t: pad_kernels.reflect_pad(t, pads)),
                          ("library", lambda t: F.pad(t, (pl, pr, pt, pb),
                                                      mode="reflect"))):
            xd = x.cuda().requires_grad_()
            wd = wt.cuda().requires_grad_()
            y = F.conv2d(pad(xd), wd)
            (gx,) = torch.autograd.grad(y.square().sum(), xd, create_graph=True)
            gx.square().sum().backward()
            out[name] = (gx.detach(), xd.grad, wd.grad)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.allow_tf32 = saved
    for got, want in zip(out["op"], out["library"]):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
def test_opcheck_on_card(dtype):
    """Both ops' schema, fake and autograd registrations against their CUDA
    implementations."""
    _need_card()
    dt = getattr(torch, dtype)
    fwd = torch.ops.de_i2i_gan_torch.reflect_pad2d.default
    bwd = torch.ops.de_i2i_gan_torch.reflect_pad2d_bwd.default
    for shape, pads in [((2, 16, 64, 64), (1, 1, 1, 1)), ((1, 2, 3, 4), (3, 3, 4, 5))]:
        x = _randn(shape, dt, 7)
        torch.library.opcheck(fwd, (x, list(pads)))
        torch.library.opcheck(fwd, (x.clone().requires_grad_(), list(pads)))
        dy = _randn(_padded(shape, pads), dt, 8)
        torch.library.opcheck(bwd, (dy, list(pads), *shape[2:]))


@pytest.mark.gpu
def test_replayed_super_step_counts_401_pad_launches():
    """A DefectGAN super-step at the cell's configuration: 307 forward and
    94 backward pad launches eager, and as many on ``pad.launches`` for
    each replay of its CUDA graph."""
    _need_card()
    from de_i2i_gan_torch.config import DefectGanConfig, TrainConfig
    from de_i2i_gan_torch.train import graphed
    from de_i2i_gan_torch.train.steps import DefectGanSteps

    cfg = DefectGanConfig(image_size=256, label_nc=6, ngf=64, ndf=64,
                          num_scales=2, num_res=6, num_layers=5, hidden_nc=128,
                          style_norm_block_type="adain", use_pallas=True,
                          sean_alpha=None, compute_dtype="bfloat16",
                          fused_g_forward=True)
    steps = DefectGanSteps(cfg, TrainConfig(batch_size=8, num_critics=5),
                           device="cuda")
    steps.init_training()
    gen = torch.Generator(device="cuda").manual_seed(0)
    shape = (5, 8, 256, 256, 3)
    batch = {"bg": torch.rand(shape, generator=gen, device="cuda") * 2 - 1,
             "df": torch.rand(shape, generator=gen, device="cuda") * 2 - 1,
             "df_labels": torch.eye(6, device="cuda")[torch.randint(
                 0, 6, shape[:2], generator=gen, device="cuda")]}
    read = profiling.REGISTRY.sources["pad.launches"]
    per_step, replays = [], graphed.REPLAYS
    for _ in range(3):  # eager; captured and replayed; replayed
        counts = (pad_kernels.LAUNCHES, pad_kernels.BWD_LAUNCHES, read())
        steps.super_step(batch)
        torch.cuda.synchronize()
        per_step.append((pad_kernels.LAUNCHES - counts[0],
                         pad_kernels.BWD_LAUNCHES - counts[1], read() - counts[2]))
    assert graphed.REPLAYS - replays == 2
    assert per_step == [(307, 94, 401)] * 3
    assert sum(n for *_, n in PAD_CALLS) == 307
    assert sum(n for _, _, bwd, n in PAD_CALLS if bwd) == 94
