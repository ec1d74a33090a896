"""pix2pix steps of the port against the JAX package on the CPU: ``d_step``,
``g_step``, ``train_step`` (with and without spectral norm, and with the
U-Net generator of ``--netG unet``, ``skip_conn``),
``fused_train_step`` and a 2-iteration ``super_step`` under SGD, and
``train_step`` / ``fused_train_step`` from a continued Adam state.

State, batches and sizes are ``tests/test_torch_pix2pix.py``'s. The JAX
steps run under ``jax.jit``. Compared, with the tolerances of the JAX
suite's gradient checks (``tests/test_torch_train_step.py``):
  * the loss terms, rtol 2e-4;
  * G's and D's gradients as (after - before) / lr under SGD, per tensor,
    rtol 2e-4 and atol 1e-5 (a super-step's sums its two iterations);
  * the EMA generator after the step, atol 1e-6 (it moves by 1e-3 of G's
    step);
  * after Adam (0.5, 0.999) from a continued state (count 3, mu normal(0,
    1e-3), nu uniform(0.5, 2) * 1e-2: an update is not lr * sign(g), which
    would hide a wrong gradient): the parameters, atol 1e-6 (float32 ulps
    of the weights), and the counts carried on;
  * G's BatchNorm statistics and spectral u/v, 1e-4.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_pix2pix import (
    ADAM, SGD, jax_state, jax_steps, pairs, port_steps, port_tree)

torch.set_num_threads(1)

LOSS_RTOL = 2e-4
GRAD_RTOL, GRAD_ATOL = 2e-4, 1e-5
EMA_ATOL = ADAM_ATOL = 1e-6
STATS_TOL = 1e-4
ADAM_COUNT = 3


def continued(state, seed):
    """``state`` with every Adam state drawn: counts ADAM_COUNT, mu
    normal(0, 1e-3), nu uniform(0.5, 2) * 1e-2."""
    rng = np.random.default_rng(seed)

    def draw(tree, fn):
        return jax.tree_util.tree_map(
            lambda a: fn(np.shape(a)).astype(np.float32), tree)

    rep = {}
    for name in ("G", "D"):
        net = getattr(state, name)
        parts = []
        for part in net.opt_state:  # scale_by_adam, the schedule, scale
            if "mu" in part._fields:
                part = part._replace(
                    count=np.asarray(ADAM_COUNT, np.int32),
                    mu=draw(part.mu, lambda s: rng.normal(0, 1e-3, s)),
                    nu=draw(part.nu, lambda s: rng.uniform(0.5, 2, s) * 1e-2))
            elif "count" in part._fields:
                part = part._replace(count=np.asarray(ADAM_COUNT, np.int32))
            parts.append(part)
        rep[name] = net.replace(opt_state=tuple(parts))
    return state.replace(**rep)


@functools.lru_cache(maxsize=None)
def run_pair(kind, opt="sgd", variant=""):
    """(state, JAX state after, JAX metrics, port steps after, port
    metrics) of one step ``kind`` from one state; ``variant`` "spectral"
    or "unet" changes the generator."""
    tcfg = SGD if opt == "sgd" else ADAM
    cfg_kw = {"": None, "spectral": dict(use_spectral=True),
              "unet": dict(skip_conn=True)}[variant]
    fused = kind == "fused_train_step"
    jsteps = jax_steps(tcfg, cfg_kw, fused_prop=fused)
    state = jax_state(jsteps, 1)
    if opt == "adam":
        state = continued(state, 2)
    batch = pairs(3, (2,) if kind == "super_step" else ())
    after, jm = jax.jit(getattr(jsteps, kind))(
        state, {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.PRNGKey(5))
    port = port_steps(tcfg, cfg_kw, state, fused_prop=fused)
    m = getattr(port, kind)({k: torch.from_numpy(v) for k, v in batch.items()})
    return state, jax.device_get(after), jax.device_get(jm), port, m


def close_metrics(metrics, jmetrics):
    assert sorted(metrics) == sorted(jmetrics)
    for k, v in jmetrics.items():
        np.testing.assert_allclose(metrics[k].item(), float(v), rtol=LOSS_RTOL,
                                   atol=1e-7, err_msg=k)


def close_deltas(module, before_tree, after_tree, lr):
    before = port_tree(module, before_tree)
    moved = 0
    for key, (tensor, ref_after) in port_tree(module, after_tree).items():
        start = before[key][1]
        ref = (ref_after - start) / lr
        np.testing.assert_allclose((tensor.detach().numpy() - start) / lr, ref,
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=key)
        moved += bool(np.any(ref != 0))
    assert moved > 0


def close_state(port, after):
    """G's BatchNorm statistics and spectral u/v; the EMA generator."""
    for coll in ("batch_stats", "spectral"):
        if coll in after.G.state:
            for key, (tensor, ref) in port_tree(port.G, after.G.state[coll],
                                                coll).items():
                np.testing.assert_allclose(tensor.numpy(), ref, atol=STATS_TOL,
                                           err_msg=key)
    for key, (tensor, ref) in port_tree(port.ema_G, after.ema_G).items():
        np.testing.assert_allclose(tensor.detach().numpy(), ref,
                                   atol=EMA_ATOL, err_msg=key)


def test_d_step_matches_jax():
    state, after, jm, port, m = run_pair("d_step")
    close_metrics(m, jm)
    close_deltas(port.D, state.D.params, after.D.params, SGD["lr"][0])
    for key, (tensor, ref) in port_tree(port.G, state.G.params).items():
        np.testing.assert_array_equal(tensor.detach().numpy(), ref)
    assert port.step == int(after.step) == 1


def test_g_step_matches_jax():
    state, after, jm, port, m = run_pair("g_step")
    close_metrics(m, jm)
    close_deltas(port.G, state.G.params, after.G.params, SGD["lr"][1])
    close_state(port, after)
    for key, (tensor, ref) in port_tree(port.D, state.D.params).items():
        np.testing.assert_array_equal(tensor.detach().numpy(), ref)


@pytest.mark.parametrize("kind,variant", [
    ("train_step", ""), ("train_step", "spectral"), ("train_step", "unet"),
    ("fused_train_step", ""), ("super_step", "")])
def test_steps_match_jax_under_sgd(kind, variant):
    """train_step: D's update on the detached fake, G's from the same fake
    against the updated D; FusedProp: both from the nets before the update;
    super_step: train_step over 2 iterations."""
    state, after, jm, port, m = run_pair(kind, "sgd", variant)
    close_metrics(m, jm)
    close_deltas(port.G, state.G.params, after.G.params, SGD["lr"][1])
    close_deltas(port.D, state.D.params, after.D.params, SGD["lr"][0])
    close_state(port, after)
    n = 2 if kind == "super_step" else 1
    assert port.step == int(after.step) == n
    assert port.tx_G.count == port.tx_D.count == n


@pytest.mark.parametrize("kind", ["train_step", "fused_train_step"])
def test_steps_match_jax_from_continued_adam(kind):
    state, after, jm, port, m = run_pair(kind, "adam")
    close_metrics(m, jm)
    for name in ("G", "D"):
        for key, (tensor, ref) in port_tree(getattr(port, name),
                                            getattr(after, name).params).items():
            np.testing.assert_allclose(tensor.detach().numpy(), ref,
                                       atol=ADAM_ATOL, err_msg=f"{name} {key}")
        assert getattr(port, f"tx_{name}").count == ADAM_COUNT + 1
    close_state(port, after)
