"""The PyTorch port's serving path against the JAX package, end to end.

Both packages start from one JAX train state (``init_state`` with biases,
BatchNorm affine parameters and running statistics moved off their init
values by a seeded numpy draw) carried into the port through
``train/jax_import.py``. Tolerance: forward 5e-4 (DESIGN.md §7) in float32;
bfloat16 within two bf16 ulps at magnitude 1 (1.6e-2), since both packages
round to bf16 at the same places and differ by the rounding of single ops.
``tests/test_torch_kernel_gpu.py`` runs the same path on the card through
the CUDA kernel.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from de_i2i_gan_tpu.config import DefectGanConfig as JaxConfig
from de_i2i_gan_tpu.config import TrainConfig as JaxTrainConfig
from de_i2i_gan_tpu.models.extractor import StyleExtractor as JaxExtractor
from de_i2i_gan_tpu.models.generator import DefectGanGenerator as JaxGenerator
from de_i2i_gan_tpu.train.steps import DefectGanSteps as JaxSteps
from de_i2i_gan_torch.config import DefectGanConfig, TrainConfig
from de_i2i_gan_torch.models.extractor import StyleExtractor
from de_i2i_gan_torch.models.generator import DefectGanGenerator
from de_i2i_gan_torch.train.jax_import import (
    init_weights, load_jax_generator, load_jax_module)
from de_i2i_gan_torch.train.steps import DefectGanSteps

torch.set_num_threads(1)

TINY = dict(image_size=32, label_nc=4, ngf=8, ndf=8, num_res=2, hidden_nc=16,
            num_layers=2, style_norm_block_type="adain", use_pallas=True)
TOL = 5e-4
BF16_TOL = 1.6e-2


def perturb(tree, rng):
    """Biases, BN scales and running stats off their init values."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = perturb(v, rng)
            continue
        v = np.asarray(v, np.float32)
        if k in ("bias", "mean", "scale"):
            v = v + rng.normal(0, 0.1, v.shape).astype(np.float32)
        elif k == "var":
            v = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        out[k] = v
    return out


def _inputs(seed=1, n=2):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (n, 32, 32, 3)).astype(np.float32)
    labels = np.eye(4, dtype=np.float32)[rng.integers(0, 4, n)]
    return x, labels


def _close(port, ref, tol=TOL):
    np.testing.assert_allclose(port.float().numpy(), np.asarray(ref, np.float32),
                               atol=tol, rtol=tol)


@pytest.fixture(scope="module")
def pair():
    """(jax steps, jax state, port steps) from one JAX init."""
    jsteps = JaxSteps(JaxConfig(**TINY), JaxTrainConfig())
    state = jsteps.init_state(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    g_params = perturb(jax.device_get(state.G.params), rng)
    g_stats = perturb(jax.device_get(state.G.state["batch_stats"]), rng)
    e_params = perturb(jax.device_get(state.E.params), rng)
    ema = perturb(g_params, rng)  # an EMA that differs from G
    state = state.replace(
        G=state.G.replace(params=g_params,
                          state={**state.G.state, "batch_stats": g_stats}),
        E=state.E.replace(params=e_params), ema_G=ema)
    steps = DefectGanSteps(DefectGanConfig(**TINY),
                           TrainConfig(ema_decay=0.999), device="cpu")
    load_jax_generator(steps, g_params, {"batch_stats": g_stats}, e_params, ema)
    return jsteps, state, steps


@pytest.mark.parametrize("use_ema", [False, True])
def test_generate_matches_jax(pair, use_ema):
    jsteps, state, steps = pair
    x, labels = _inputs()
    jout, jprob = jsteps.generate(state, jnp.asarray(x), jnp.asarray(labels),
                                  use_ema=use_ema)
    out, prob = steps.generate(torch.from_numpy(x), torch.from_numpy(labels),
                               use_ema=use_ema)
    assert out.shape == (2, 32, 32, 3) and prob.shape == (2, 32, 32, 1)
    _close(out, jout)
    _close(prob, jprob)


def test_style_extractor_matches_jax(pair):
    jsteps, state, steps = pair
    x, labels = _inputs(seed=2)
    ref = jsteps.E.apply({"params": state.E.params}, jnp.asarray(x),
                         jnp.asarray(labels))
    with torch.no_grad():
        got = steps.E(torch.from_numpy(x), torch.from_numpy(labels))
    assert got.shape == (2, 16)
    _close(got, ref)


def test_generate_with_explicit_style_matches_jax(pair):
    jsteps, state, steps = pair
    x, labels = _inputs(seed=3)
    style = np.random.default_rng(3).normal(0, 1, (2, 16)).astype(np.float32)
    jout, jprob = jsteps.generate(state, jnp.asarray(x), jnp.asarray(labels),
                                  jnp.asarray(style))
    out, prob = steps.generate(torch.from_numpy(x), torch.from_numpy(labels),
                               torch.from_numpy(style))
    _close(out, jout)
    _close(prob, jprob)


def test_generate_bf16_matches_jax_bf16(pair):
    _, state, _ = pair
    cfg = dict(TINY, compute_dtype="bfloat16")
    jsteps = JaxSteps(JaxConfig(**cfg), JaxTrainConfig())
    steps = DefectGanSteps(DefectGanConfig(**cfg), device="cpu")
    load_jax_generator(steps, state.G.params, state.G.state, state.E.params)
    x, labels = _inputs(seed=4)
    jout, jprob = jsteps.generate(state, jnp.asarray(x), jnp.asarray(labels))
    out, prob = steps.generate(torch.from_numpy(x), torch.from_numpy(labels))
    assert out.dtype == torch.bfloat16 and prob.dtype == torch.bfloat16
    _close(out, jout, BF16_TOL)
    _close(prob, jprob, BF16_TOL)


def test_latent_style_extractor_matches_jax(monkeypatch):
    """sean_alpha == 0: the noise is drawn from an explicit torch.Generator;
    the JAX side is handed the same draw."""
    jcfg = JaxConfig(**TINY, sean_alpha=0.0)
    jnet = JaxExtractor(jcfg)
    x, labels = _inputs(seed=5)
    key = jax.random.PRNGKey(5)
    params = perturb(jax.device_get(
        jnet.init({"params": key, "latent": key}, jnp.asarray(x),
                  jnp.asarray(labels))["params"]), np.random.default_rng(5))
    net = StyleExtractor(DefectGanConfig(**TINY, sean_alpha=0.0)).eval()
    load_jax_module(net, params)

    noise = torch.randn((2, 16 - 4), generator=torch.Generator().manual_seed(9))
    monkeypatch.setattr(jax.random, "normal",
                        lambda k, shape, dtype: jnp.asarray(noise.numpy(), dtype))
    ref = jnet.apply({"params": params}, jnp.asarray(x), jnp.asarray(labels),
                     rngs={"latent": key})
    with torch.no_grad():
        got = net(torch.from_numpy(x), torch.from_numpy(labels),
                  generator=torch.Generator().manual_seed(9))
    assert got.shape == (2, 16)
    _close(got, ref)


@pytest.mark.parametrize("switch", ["skip_conn", "cycle_gan"])
def test_generator_variants_match_jax(switch):
    cfg = dict(TINY, **{switch: True})
    jnet = JaxGenerator(JaxConfig(**cfg))
    x, labels = _inputs(seed=6)
    style = np.random.default_rng(6).normal(0, 1, (2, 16)).astype(np.float32)
    key = jax.random.PRNGKey(6)
    variables = jnet.init({"params": key, "noise": key, "latent": key},
                          jnp.asarray(x), jnp.asarray(labels),
                          jnp.asarray(style))
    rng = np.random.default_rng(6)
    params = perturb(jax.device_get(variables["params"]), rng)
    stats = perturb(jax.device_get(variables["batch_stats"]), rng)
    jout, jprob = jnet.apply({"params": params, "batch_stats": stats},
                             jnp.asarray(x), jnp.asarray(labels),
                             jnp.asarray(style), rngs={"noise": key,
                                                       "latent": key})
    net = DefectGanGenerator(DefectGanConfig(**cfg)).eval()
    load_jax_module(net, params, {"batch_stats": stats})
    with torch.no_grad():
        out, prob = net(torch.from_numpy(x), torch.from_numpy(labels),
                        torch.from_numpy(style))
    _close(out, jout)
    _close(prob, jprob)


def test_load_is_strict(pair):
    _, state, _ = pair
    steps = DefectGanSteps(DefectGanConfig(**TINY), device="cpu")
    g_params = dict(state.G.params)
    stem = g_params.pop("stem")
    with pytest.raises(KeyError, match="stem/conv/kernel"):
        load_jax_generator(steps, g_params, state.G.state, state.E.params)
    g_params["stem"] = stem
    g_params["extra"] = {"kernel": np.zeros((1,), np.float32)}
    with pytest.raises(KeyError, match="extra/kernel"):
        load_jax_generator(steps, g_params, state.G.state, state.E.params)
    with pytest.raises(ValueError, match="ema_params"):
        load_jax_generator(steps, state.G.params, state.G.state,
                           state.E.params, state.ema_G)


def test_init_weights_distribution_and_determinism():
    cfg = DefectGanConfig(**dict(TINY, ngf=32))
    a = DefectGanSteps(cfg, device="cpu")
    b = DefectGanSteps(cfg, device="cpu")
    init_weights(a, 7)
    init_weights(b, 7)
    for (ka, va), (kb, vb) in zip(a.G.state_dict().items(),
                                  b.G.state_dict().items()):
        assert ka == kb and torch.equal(va, vb), ka
    w = a.G.dec_res_0.conv_0.weight
    assert abs(w.std().item() - 0.02) < 1e-3 and abs(w.mean().item()) < 1e-3
    assert torch.count_nonzero(a.G.dec_res_0.norm_0.adain.mlp_gamma.bias) == 0
    assert torch.equal(a.G.stem.norm.running_var, torch.ones(32))
    assert torch.equal(a.G.stem.norm.weight, torch.ones(32))
