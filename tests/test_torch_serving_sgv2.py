"""The port's StarGAN v2 serving export (``serving.py``) on the CPU: the
generator (AdaIN and SEAN), the style encoder and the mapping network
round-trip through ``save_exported`` / ``load_exported`` and serve batches
1 and 3 from one artifact; each equals the port's eager forward within
2e-5 and JAX's ``generate``, ``S.apply`` or ``M.apply`` on the same weights
within 5e-4 (DESIGN.md section 7); ``w_hpf > 0`` is refused. The solvers
are ``tests/test_torch_starganv2.py``'s (one perturbed JAX init carried
into the port), float32.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from de_i2i_gan_torch import serving
from de_i2i_gan_torch.train.solver import StarGANv2Config, StarGANv2Solver
from tests.test_torch_serving import EAGER_TOL, JAX_TOL, _roundtrip
from tests.test_torch_starganv2 import (
    CFG as SGV2_CFG, EMBED, LATENT, NUM_EMBEDS, STYLE, domains, solvers)

torch.set_num_threads(1)


def _sgv2_args(batch, seed, sean=False):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (batch, 64, 64, 3)).astype(np.float32)
    s = rng.normal(0, 1, (batch, NUM_EMBEDS, EMBED) if sean
                   else (batch, STYLE)).astype(np.float32)
    return x, s, domains(seed + 1, batch)


@pytest.mark.parametrize("case", ["adain", "sean"])
def test_sgv2_generator_export_round_trip(case, tmp_path):
    jsolver, state, port = solvers(case)
    served = _roundtrip(serving.export_sgv2_generator(port), tmp_path, case)
    for batch in (1, 3):
        x, s, y = _sgv2_args(batch, 20 + batch, sean=case == "sean")
        args = [torch.from_numpy(a) for a in (x, s, y.astype(np.int64))]
        with torch.no_grad():
            got = served(*args)
        want = port.generate(*args)
        assert got.shape == (batch, 64, 64, 3)
        torch.testing.assert_close(got, want, atol=EAGER_TOL, rtol=EAGER_TOL)
    jout = jax.jit(jsolver.generate)(state, jnp.asarray(x), jnp.asarray(s),
                                     jnp.asarray(y))
    np.testing.assert_allclose(got.numpy(), np.asarray(jout),
                               atol=JAX_TOL, rtol=JAX_TOL)


@pytest.mark.parametrize("net", ["style_encoder", "mapping"])
def test_sgv2_companion_export_round_trip(net, tmp_path):
    jsolver, state, port = solvers("adain")
    export = getattr(serving, f"export_sgv2_{net}")
    served = _roundtrip(export(port), tmp_path, net)
    jnet, live = ((jsolver.M, port.ema_M) if net == "mapping"
                  else (jsolver.S, port.ema_S))
    params = state.ema_M if net == "mapping" else state.ema_S
    for batch in (1, 3):
        rng = np.random.default_rng(30 + batch)
        y = domains(31 + batch, batch)
        a = (rng.normal(0, 1, (batch, LATENT)) if net == "mapping"
             else rng.uniform(-1, 1, (batch, 64, 64, 3))).astype(np.float32)
        args = (torch.from_numpy(a), torch.from_numpy(y.astype(np.int64)))
        with torch.no_grad():
            got, want = served(*args), live(*args)
        assert got.shape == (batch, STYLE)
        torch.testing.assert_close(got, want, atol=EAGER_TOL, rtol=EAGER_TOL)
    ref = jax.jit(jnet.apply)({"params": params}, jnp.asarray(a),
                              jnp.asarray(y))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               atol=JAX_TOL, rtol=JAX_TOL)


def test_sgv2_w_hpf_refused():
    port = StarGANv2Solver(StarGANv2Config(**dict(SGV2_CFG, w_hpf=1.0)),
                           device="cpu")
    with pytest.raises(ValueError, match="w_hpf > 0 needs in-graph FAN masks"):
        serving.export_sgv2_generator(port)
