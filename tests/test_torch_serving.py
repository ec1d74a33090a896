"""The port's serving export (``serving.py``) of DefectGAN on the CPU
(StarGAN v2's: ``tests/test_torch_serving_sgv2.py``): every exporter
round-trips through ``save_exported`` / ``load_exported`` and serves
batches 1 and 3 from one artifact (a symbolic batch from 1 up); each
artifact equals the port's eager forward within 2e-5 (the JAX export CLI's
round-trip bound) and JAX's ``generate``, ``S.apply`` or ``M.apply`` on the
same weights within 5e-4 (DESIGN.md section 7), on configurations that
draw no noise. With ``add_noise`` the in-graph noise is keyed on the seed
input: the same seed repeats, another differs. Weights come from one JAX
init carried into the port (``train/jax_import.py``), with the biases,
scales and statistics moved off their init values; tiny config, float32.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from de_i2i_gan_tpu.config import DefectGanConfig as JaxConfig
from de_i2i_gan_tpu.config import TrainConfig as JaxTrainConfig
from de_i2i_gan_tpu.train.steps import DefectGanSteps as JaxSteps
from de_i2i_gan_torch import serving
from de_i2i_gan_torch.config import DefectGanConfig, TrainConfig
from de_i2i_gan_torch.train.jax_import import load_jax_generator
from de_i2i_gan_torch.train.steps import DefectGanSteps

torch.set_num_threads(1)

EAGER_TOL = 2e-5
JAX_TOL = 5e-4
TINY = dict(image_size=32, label_nc=4, ngf=8, ndf=8, num_res=2, hidden_nc=16,
            num_layers=2, embed_nc=12, num_embeds=2)


def perturb(tree, rng):
    """Biases, scales and running statistics off their init values."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = perturb(v, rng)
            continue
        v = np.asarray(v, np.float32)
        if k in ("bias", "mean", "scale"):
            v = v + rng.normal(0, 0.1, v.shape).astype(np.float32)
        elif k in ("var", "std"):
            v = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        out[k] = v
    return out


@functools.lru_cache(maxsize=None)
def defectgan(style):
    """(jax steps, jax state, port steps) from one JAX init."""
    cfg = dict(TINY, style_norm_block_type=style)
    jsteps = JaxSteps(JaxConfig(**cfg), JaxTrainConfig())
    state = jsteps.init_state(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    g_params = perturb(jax.device_get(state.G.params), rng)
    g_state = perturb(jax.device_get(state.G.state), rng)
    e_params = (perturb(jax.device_get(state.E.params), rng)
                if state.E is not None else None)
    state = state.replace(G=state.G.replace(params=g_params, state=g_state))
    if e_params is not None:
        state = state.replace(E=state.E.replace(params=e_params))
    steps = DefectGanSteps(DefectGanConfig(**cfg), TrainConfig(), device="cpu")
    load_jax_generator(steps, g_params, g_state, e_params)
    return jsteps, state, steps


def _roundtrip(program, tmp_path, name):
    return serving.load_exported(serving.save_exported(
        program, tmp_path / f"{name}.pt2")).module()


def _dg_args(steps, batch, seed):
    gen = torch.Generator().manual_seed(seed)
    args = serving.defectgan_example_args(steps, batch, seed, gen)
    if steps.cfg.style_norm_block_type == "sean":
        args[2] = torch.randn(args[2].shape, generator=gen)
    return args


@pytest.mark.parametrize("style", ["spade", "sean", "adain"])
def test_defectgan_export_round_trip(style, tmp_path):
    """Batches 1 and 3 from one artifact: the eager forward within 2e-5,
    JAX's generate within 5e-4; SEAN with style features and AdaIN with
    its extractor's style."""
    jsteps, state, steps = defectgan(style)
    program = serving.export_defectgan_generator(steps)
    served = _roundtrip(program, tmp_path, style)
    live = serving.defectgan_serving_module(steps)
    for batch in (1, 3):
        args = _dg_args(steps, batch, 10 + batch)
        with torch.no_grad():
            out, prob = served(*args)
            want = live(*args)
        assert out.shape == (batch, 32, 32, 3) and prob.shape == (batch, 32, 32, 1)
        for got, ref in zip((out, prob), want):
            torch.testing.assert_close(got, ref, atol=EAGER_TOL, rtol=EAGER_TOL)
    # JAX's generate at the last batch (one compile)
    feat = jnp.asarray(args[2].numpy()) if style == "sean" else None
    jout, jprob = jax.jit(jsteps.generate)(
        state, jnp.asarray(args[0].numpy()), jnp.asarray(args[1].numpy()), feat)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout),
                               atol=JAX_TOL, rtol=JAX_TOL)
    np.testing.assert_allclose(prob.numpy(), np.asarray(jprob),
                               atol=JAX_TOL, rtol=JAX_TOL)


def test_defectgan_export_seed_input_varies_noise(tmp_path):
    """add_noise: the seed keys the in-graph noise. The same seed gives the
    same output, another seed another one; the eager serving module draws
    the same noise."""
    cfg = DefectGanConfig(**dict(TINY, style_norm_block_type="spade",
                                 add_noise=True))
    steps = DefectGanSteps(cfg, TrainConfig(), device="cpu")
    with torch.no_grad():
        for m in steps.G.modules():
            if type(m).__name__ == "NoiseInjection":
                m.weight.fill_(0.5)
    served = _roundtrip(serving.export_defectgan_generator(steps), tmp_path,
                        "noise")
    args = _dg_args(steps, 2, 1)
    with torch.no_grad():
        a, b = served(*args)[0], served(*args)[0]
        args[-1] = torch.tensor(2)
        c = served(*args)[0]
        live = serving.defectgan_serving_module(steps)(*args)[0]
    assert torch.equal(a, b)
    assert (a - c).abs().max() > 1e-2
    torch.testing.assert_close(c, live, atol=EAGER_TOL, rtol=EAGER_TOL)


def test_seeded_noise_is_standard_normal():
    noise = serving.SeededNoise(torch.tensor(5))
    z = noise.normal((4, 1, 64, 64), torch.float32, "cpu")
    w = noise.normal((4, 1, 64, 64), torch.float32, "cpu")
    assert abs(float(z.mean())) < 0.05 and abs(float(z.std()) - 1) < 0.05
    assert not torch.equal(z, w)  # each draw has its own key
    again = serving.SeededNoise(torch.tensor(5)).normal(
        (4, 1, 64, 64), torch.float32, "cpu")
    assert torch.equal(z, again)


def test_cpu_graph_holds_no_kernel_op():
    """On the CPU the graph holds the plain version's aten ops (the op
    nodes are the card's; tests/test_torch_kernel_gpu.py counts them)."""
    _, _, steps = defectgan("sean")
    assert serving.kernel_nodes(serving.export_defectgan_generator(steps)) == 0
