"""One whole StarGAN v2 AdaIN ``train_step`` in both packages, from one JAX
``SolverState`` continued: the perturbed weights of
``tests/test_torch_starganv2_train.py`` and a drawn Adam state (count 3,
moments from a seed) for G, D, M and S, carried into the port by
``load_jax_starganv2``; and the solver's Adam against optax's chain.

Adam with beta1 = 0 moves a weight by lr * g / (sqrt(nu_hat) + eps). From a
fresh state (nu = 0) that is about lr * sign(g) whatever the gradient's
size, so an element whose gradient lies within rounding of zero moves
either way, and every pass after it sees nets that differ there. From a
continued state (nu > 0) the update is a smooth function of the gradient,
so the whole step can be held element for element; the fresh first update
is held on its own, the solver's optimizer against the optax chain on the
same gradients.

Compared after the step (the D latent, D reference, G latent, G reference
passes, then the EMA updates):
  * every metric under the JAX names, rtol 2e-4;
  * each net's update (after - before) per tensor within a band of its L2
    norm (``STEP_REL``: 1e-3 for D, 1e-2 for M and S, 2e-2 for G, each with
    its measured reason), plus 1e-9 * sqrt(numel);
  * Adam's moments (torch ``exp_avg``/``exp_avg_sq``, optax ``mu``/``nu``)
    with the same bands, and every count: G and D advance twice, M and S
    once (the latent pass alone updates them);
  * the EMA nets (beta 0.999) within 1e-6, and ``step``.
"""
import functools

import numpy as np
import optax
import pytest
import torch

import jax

from tests.test_torch_starganv2_train import (
    G_GRAD_REL, GRAD_REL, JaxConfig, JaxSolver, close_losses, config, jv,
    jax_batch, make_batch, perturbed_state, port_params, port_solver,
    torch_batch)
from de_i2i_gan_torch.train.optim import make_solver_optimizer

torch.set_num_threads(1)

UPDATE_ATOL = 1e-9
# per net, the band for its update and moments after the whole step: D's
# passes see only D's own smooth drift (measured 6.7e-5 and 4.2e-4 at seeds
# 0 and 1); M and S are updated by the latent G pass, whose gradients take
# G_GRAD_REL (measured 5.8e-4..1.1e-3); G's reference pass runs on a G and
# a D that the earlier updates moved by about 1e-7 of their weights apart,
# and its gradient moves by 2.5e-3 for weight noise of 1e-7 (the port alone:
# L1 near-ties in the diversity and cycle terms, the cycle's ill-conditioned
# second pass): measured 8.4e-3 and 8.9e-3 at seeds 0 and 1
STEP_REL = {"D": GRAD_REL, "M": G_GRAD_REL, "S": G_GRAD_REL, "G": 2e-2}
EMA_ATOL = 1e-6
NETS = ("G", "D", "M", "S")
ADAM_COUNT = 3


def continued(state, seed):
    """``state`` with every net's Adam state drawn: count ADAM_COUNT, mu
    normal(0, 1e-3), nu uniform(0.5, 2) * 1e-2 (so the step moves a weight
    by about lr * g / 0.5: small against the weights, which keeps the two
    packages' nets close for the passes after each update)."""
    rng = np.random.default_rng(seed)

    def draw(tree, fn):
        return jax.tree_util.tree_map(
            lambda a: fn(np.shape(a)).astype(np.float32), tree)

    rep = {}
    for name in NETS:
        net = getattr(state, name)
        if net is None:
            continue
        decay, adam, scale = net.opt_state
        adam = adam._replace(
            count=np.asarray(ADAM_COUNT, np.int32),
            mu=draw(adam.mu, lambda s: rng.normal(0, 1e-3, s)),
            nu=draw(adam.nu, lambda s: rng.uniform(0.5, 2, s) * 1e-2))
        rep[name] = net.replace(opt_state=(decay, adam, scale))
    return state.replace(**rep)


@functools.lru_cache(maxsize=None)
def step_run(norm_type, seed=0, **kw):
    """(state before, JAX state after, JAX metrics, port solver, port
    metrics) of one train_step from one continued state."""
    cfg = config(norm_type, **kw)
    jsolver = JaxSolver(JaxConfig(**cfg))
    state = continued(perturbed_state(jsolver, seed), seed + 1)
    batch = make_batch(seed + 2, sean=norm_type == "sean")
    after, jmetrics = jax.jit(jsolver.train_step)(
        jv(state), jax_batch(batch), jax.random.PRNGKey(seed + 3))
    port = port_solver(cfg, state)
    metrics = port.train_step(torch_batch(batch))
    return state, jax.device_get(after), jax.device_get(jmetrics), port, metrics


def close_tensors(got, ref, rel, atol, label):
    """Per tensor: ||got - ref|| <= rel ||ref|| + atol sqrt(numel)."""
    diff = np.linalg.norm(got - ref)
    band = rel * np.linalg.norm(ref) + atol * ref.size ** 0.5
    assert diff <= band, f"{label}: |d| {diff:.3e} > {band:.3e}"


def check_step(state, after, jmetrics, port, metrics, nets=NETS, passes=2):
    """``passes``: the step's updates of G and D (AdaIN 2, SEAN 1)."""
    close_losses(metrics, jmetrics)
    for name in nets:
        module = getattr(port, name)
        rel = STEP_REL[name]
        before = port_params(module, getattr(state, name).params)
        ref_after = port_params(module, getattr(after, name).params)
        for key, (tensor, ref) in ref_after.items():
            start = before[key][1]
            close_tensors(tensor.detach().numpy() - start, ref - start, rel,
                          UPDATE_ATOL, f"{name} {key} update")
        adam = getattr(after, name).opt_state[1]
        tx = getattr(port, f"tx_{name}")
        for moment, tree in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
            for key, (tensor, ref) in port_params(module, tree).items():
                close_tensors(tx.opt.state[tensor][moment].numpy(), ref, rel,
                              UPDATE_ATOL, f"{name} {key} {moment}")
        want = ADAM_COUNT + (passes if name in ("G", "D") else 1)
        assert int(adam.count) == tx.count == want, name
        assert all(tx.opt.state[p]["step"].item() == want for p in tx.params)
        if name == "D":
            continue
        ema = getattr(port, f"ema_{name}")
        for key, (tensor, ref) in port_params(
                ema, getattr(after, f"ema_{name}")).items():
            np.testing.assert_allclose(tensor.numpy(), ref, rtol=0,
                                       atol=EMA_ATOL, err_msg=f"ema_{name} {key}")
    assert port.step == int(after.step) == int(state.step) + 1
    assert all(p.grad is None for n in nets
               for p in getattr(port, n).parameters())


def test_adain_train_step_matches_jax():
    """The four passes, the EMA of G, M and S, the counts and the step."""
    check_step(*step_run("adain"))


def test_adain_train_step_metric_names():
    _, _, jmetrics, _, metrics = step_run("adain")
    assert sorted(metrics) == sorted(jmetrics) == sorted(
        [f"D/{p}_{k}" for p in ("latent", "ref") for k in ("real", "fake", "reg")]
        + [f"G/{p}_{k}" for p in ("latent", "ref")
           for k in ("adv", "sty", "ds", "cyc")] + ["G/lambda_ds"])
    np.testing.assert_allclose(metrics["G/lambda_ds"].item(), 0.9, rtol=1e-6)


@pytest.mark.parametrize("lr,betas,wd", [(1e-4, (0.0, 0.99), 1e-4),
                                         (1e-6, (0.0, 0.99), 1e-4),
                                         (2e-4, (0.5, 0.999), 0.0)])
def test_solver_adam_matches_the_optax_chain(lr, betas, wd):
    """``make_solver_optimizer`` against ``add_decayed_weights`` ->
    ``scale_by_adam`` -> ``scale(-lr)`` over three updates from count 0 on
    the same gradients, some of them near zero (the first update is about
    lr * sign(g)): coupled L2, not AdamW's decoupled decay. Within 2 float32
    ulps of the weights."""
    rng = np.random.default_rng(11)
    p0 = rng.normal(0, 0.1, (64, 33)).astype(np.float32)
    grads = [(rng.normal(0, 1e-2, p0.shape) *
              rng.choice([1.0, 1e-6], p0.shape)).astype(np.float32)
             for _ in range(3)]
    tx = optax.chain(optax.add_decayed_weights(wd),
                     optax.scale_by_adam(b1=betas[0], b2=betas[1]),
                     optax.scale(-lr))
    jp = jax.numpy.asarray(p0)
    opt = tx.init(jp)
    param = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    port = make_solver_optimizer([param], lr, betas, wd)
    for g in grads:
        upd, opt = tx.update(jax.numpy.asarray(g), opt, jp)
        jp = optax.apply_updates(jp, upd)
        port.step([torch.from_numpy(g)])
    np.testing.assert_allclose(param.detach().numpy(), np.asarray(jp), rtol=0,
                               atol=2 * np.spacing(np.float32(0.5)))
    assert port.count == 3 and port.schedule(7) == lr
