"""The port's modulated instance norm against the JAX package's.

On the CPU the port runs its plain version (the CUDA kernel needs a card),
held here against the XLA oracle ``_xla_modulated_instance_norm``, the
Pallas kernel in interpret mode and that kernel's mean/inv residuals, the way
``tests/test_pallas_kernels.py`` runs them. Tolerances are that suite's:
float32 atol=rtol=2e-5, bfloat16 atol 3e-2. The kernel itself is held
against the plain version on the card by the ``gpu``-marked
``tests/test_torch_kernel_gpu.py`` and by ``chip_smoke.py``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from de_i2i_gan_tpu.ops import fused as jfused
from de_i2i_gan_tpu.ops.pallas.norm_kernels import (
    _fwd_call, pallas_modulated_instance_norm)
from de_i2i_gan_torch.ops import fused
from de_i2i_gan_torch.ops.cuda import norm_kernels

torch.set_num_threads(1)

TOL = 2e-5
BF16_ATOL = 3e-2
ACTS = [None, "relu", "leaky_relu"]
# (2, 8, 8, 128): the JAX suite's shape; (1, 64, 64, 128): HW=4096 takes the
# TPU kernel's two-chunk loop
SHAPES = [(2, 8, 8, 128), (1, 64, 64, 128)]


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    n, c = shape[0], shape[-1]
    x = (rng.normal(0, 1, shape) * 2.0 + 1.0).astype(np.float32)
    g = (rng.normal(0, 1, (n, c)) * 0.5).astype(np.float32)
    b = (rng.normal(0, 1, (n, c)) * 0.5).astype(np.float32)
    return x, g, b


def _no_kernel():
    raise AssertionError("the kernel library was built or loaded")


def _port(x, g, b, act, dtype=torch.float32):
    """The port on NHWC numpy inputs; returns NHWC y, (N, C) mean and inv."""
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
    y, mean, inv = fused.modulated_instance_norm_ref(
        xt.to(dtype), torch.from_numpy(g), torch.from_numpy(b), act)
    return y.float().numpy().transpose(0, 2, 3, 1), mean.numpy(), inv.numpy()


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_xla(shape, act):
    x, g, b = _inputs(shape)
    ref = jfused._xla_modulated_instance_norm(jnp.asarray(x), jnp.asarray(g),
                                              jnp.asarray(b), act, 1e-5)
    y, _, _ = _port(x, g, b, act)
    np.testing.assert_allclose(y, np.asarray(ref), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_pallas_interpret(shape, act):
    x, g, b = _inputs(shape, seed=1)
    ref = pallas_modulated_instance_norm(jnp.asarray(x), jnp.asarray(g),
                                         jnp.asarray(b), act, 1e-5, True)
    y, _, _ = _port(x, g, b, act)
    np.testing.assert_allclose(y, np.asarray(ref), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_residuals_match_pallas_interpret(shape):
    x, g, b = _inputs(shape, seed=2)
    _, mean, inv = _fwd_call(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b),
                             None, 1e-5, True)
    _, pmean, pinv = _port(x, g, b, None)
    n, c = shape[0], shape[-1]
    np.testing.assert_allclose(pmean, np.asarray(mean).reshape(n, c),
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(pinv, np.asarray(inv).reshape(n, c),
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("act", ACTS)
def test_plain_bf16_matches_xla_and_pallas(act):
    x, g, b = _inputs(SHAPES[0], seed=3)
    xb = jnp.asarray(x, jnp.bfloat16)
    refs = (jfused._xla_modulated_instance_norm(xb, jnp.asarray(g),
                                                jnp.asarray(b), act, 1e-5),
            pallas_modulated_instance_norm(xb, jnp.asarray(g), jnp.asarray(b),
                                           act, 1e-5, True))
    xr = np.asarray(xb, np.float32)  # the same bf16 values on both sides
    y, _, _ = _port(xr, g, b, act, torch.bfloat16)
    for ref in refs:
        assert ref.dtype == jnp.bfloat16
        np.testing.assert_allclose(y, np.asarray(ref, np.float32),
                                   atol=BF16_ATOL)


def test_plain_takes_any_hw_and_c():
    """No 128-lane or 2048-row divisibility (the XLA oracle takes any shape)."""
    x, g, b = _inputs((3, 5, 7, 12), seed=4)
    ref = jfused._xla_modulated_instance_norm(jnp.asarray(x), jnp.asarray(g),
                                              jnp.asarray(b), "leaky_relu",
                                              1e-5)
    y, _, _ = _port(x, g, b, "leaky_relu")
    np.testing.assert_allclose(y, np.asarray(ref), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_cpu_tensor_runs_plain_version_without_launch(use_kernel, monkeypatch):
    monkeypatch.setattr(norm_kernels, "LAUNCHES", 0)
    monkeypatch.setattr(norm_kernels, "_kernel", _no_kernel)
    x, g, b = _inputs((2, 4, 4, 8), seed=5)
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
    y = fused.modulated_instance_norm(xt, torch.from_numpy(g),
                                      torch.from_numpy(b), "relu",
                                      use_kernel=use_kernel)
    ref, _, _ = fused.modulated_instance_norm_ref(
        xt, torch.from_numpy(g), torch.from_numpy(b), "relu")
    assert torch.equal(y, ref)
    assert norm_kernels.LAUNCHES == 0


def test_kernel_wrapper_refuses_cpu_tensors(monkeypatch):
    monkeypatch.setattr(norm_kernels, "_kernel", _no_kernel)
    x = torch.zeros(1, 2, 4, 4)
    with pytest.raises(ValueError, match="CUDA tensors"):
        norm_kernels.modulated_instance_norm_fwd(x, torch.zeros(1, 2),
                                                 torch.zeros(1, 2))


def test_unknown_activation_raises():
    x = torch.zeros(1, 2, 4, 4)
    with pytest.raises(ValueError, match="gelu"):
        fused.modulated_instance_norm(x, torch.zeros(1, 2), torch.zeros(1, 2),
                                      "gelu")


def test_images_to_float_matches_jax():
    rng = np.random.default_rng(6)
    u8 = rng.integers(0, 256, (2, 4, 4, 6), dtype=np.uint8)
    batch = {"pair": u8, "bg": u8[..., :3], "df_labels": np.eye(2, 4,
                                                                 dtype=np.float32)}
    ref = jfused.batch_images_to_float({k: jnp.asarray(v)
                                        for k, v in batch.items()})
    got = fused.batch_images_to_float({k: torch.from_numpy(v)
                                       for k, v in batch.items()})
    assert sorted(got) == sorted(ref) == ["bg", "df_labels", "input", "target"]
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   atol=1e-6)
    f = torch.rand(2, 3)
    assert fused.images_to_float(f) is f
