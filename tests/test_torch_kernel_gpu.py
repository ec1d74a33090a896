"""The port's CUDA kernel on the card (``gpu`` marker; skips without one).

This file imports torch and the port only, so it also runs where flax (and
with it the JAX package's models) cannot be imported. On the card:

    python -m pytest tests/test_torch_kernel_gpu.py -m gpu --noconftest -q

The kernel is held against its plain version (which the CPU tests hold
against the JAX package). Tolerances: float32 within 2e-5 (the JAX kernel
suite's); bfloat16 y within atol 3e-2 + rtol 1.6e-2 (one bf16 ulp at
|y| < 16); mean and inv are f32. End to end in f32, 5e-4 (DESIGN.md §7).
"""
import pytest
import torch

from de_i2i_gan_torch.config import DefectGanConfig
from de_i2i_gan_torch.ops import fused
from de_i2i_gan_torch.ops.cuda import norm_kernels
from de_i2i_gan_torch.train.jax_import import init_weights
from de_i2i_gan_torch.train.steps import DefectGanSteps

TOL = 2e-5
BF16_ATOL, BF16_RTOL = 3e-2, 1.6e-2
ACTS = [None, "relu", "leaky_relu"]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_plain_on_card(dtype):
    """A decoder shape (vector path) and a ragged shape (scalar path)."""
    _need_card()
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for shape in [(8, 256, 64, 64), (3, 5, 7, 9)]:
        n, c = shape[:2]
        x = (torch.randn(shape, generator=gen, device="cuda") * 2 + 1).to(dt)
        g = torch.randn((n, c), generator=gen, device="cuda") * 0.5
        b = torch.randn((n, c), generator=gen, device="cuda") * 0.5
        for act in ACTS:
            before = norm_kernels.LAUNCHES
            y, mean, inv = norm_kernels.modulated_instance_norm_fwd(x, g, b, act)
            torch.cuda.synchronize()
            assert norm_kernels.LAUNCHES == before + 1
            ry, rmean, rinv = fused.modulated_instance_norm_ref(x, g, b, act)
            assert y.dtype == dt
            tol = (dict(atol=TOL, rtol=TOL) if dt == torch.float32
                   else dict(atol=BF16_ATOL, rtol=BF16_RTOL))
            torch.testing.assert_close(y.float(), ry.float(), **tol)
            torch.testing.assert_close(mean, rmean, atol=TOL, rtol=TOL)
            torch.testing.assert_close(inv, rinv, atol=TOL, rtol=TOL)


@pytest.mark.gpu
def test_kernel_wrapper_raises_on_bad_input():
    _need_card()
    x = torch.zeros(2, 4, 8, 8, device="cuda")
    g = torch.zeros(2, 4, device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        norm_kernels.modulated_instance_norm_fwd(x.transpose(2, 3), g, g)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        norm_kernels.modulated_instance_norm_fwd(x.half(), g, g)
    with pytest.raises(ValueError, match="gamma"):
        norm_kernels.modulated_instance_norm_fwd(x, g[:1], g)


@pytest.mark.gpu
def test_generate_on_card_goes_through_kernel():
    """Tiny AdaIN config, f32: every decoder norm launches the kernel once,
    and the plain path (use_pallas=False) agrees within 5e-4."""
    _need_card()
    cfg = DefectGanConfig(image_size=32, label_nc=4, ngf=8, ndf=8, num_res=2,
                          hidden_nc=16, num_layers=2,
                          style_norm_block_type="adain", use_pallas=True)
    steps = DefectGanSteps(cfg)
    init_weights(steps, 0)
    plain = DefectGanSteps(cfg.replace(use_pallas=False))
    init_weights(plain, 0)
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.rand((2, 32, 32, 3), generator=gen, device="cuda") * 2 - 1
    labels = torch.eye(4, device="cuda")[:2]
    before = norm_kernels.LAUNCHES
    out, prob = steps.generate(x, labels)
    # num_res // 2 NormResBlocks x 2 norms + num_scales NormConvBlocks
    assert norm_kernels.LAUNCHES - before == 2 * (cfg.num_res // 2) + cfg.num_scales
    before = norm_kernels.LAUNCHES
    pout, pprob = plain.generate(x, labels)
    assert norm_kernels.LAUNCHES == before
    torch.testing.assert_close(out, pout, atol=5e-4, rtol=5e-4)
    torch.testing.assert_close(prob, pprob, atol=5e-4, rtol=5e-4)
