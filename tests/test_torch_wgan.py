"""WGAN of the port against the JAX package on the CPU: the pools, both
nets, the clipping and gradient-penalty critic steps, the G step and the
super-step, and ``load_jax_wgan_state``.

The size is the tiny config of ``tests/test_mae_wgan.py`` (32², ``ngf=ndf=8``,
2 layers, noise 16, 2 critics), batch 4, float32. The state comes from the
JAX ``WGanSteps.init_state`` with BatchNorm's parameters and statistics and
the biases moved off their init values by a seeded numpy draw
(``tests/test_torch_train_step.py::perturb``), carried into the port by
``train/jax_import.py::load_jax_wgan_state``. The JAX steps run under
``jax.jit``; the port's take the JAX draws (the noise z and the penalty's
eps, split from the same keys as the JAX steps split them).

Compared:
  * ``max_pool`` and ``adaptive_avg_pool``: 1e-6 (the same float32 maxima
    and a mean in another order);
  * ``WGanGenerator`` and ``WGanDiscriminator`` forwards, eval and train
    mode, and the running statistics a train forward leaves: 5e-4
    (DESIGN.md section 7);
  * one D step (clipping, and the penalty with weight 10), one G step and
    one super-step, under SGD as (after - before) / lr, the gradient, per
    tensor: rtol 2e-4 and atol 1e-5 (the JAX suite's gradient check), and
    the metrics rtol 2e-4 (atol 1e-7: the Wasserstein terms are ~1e-4);
  * one super-step under RMSprop (decay 0.99, eps 1e-8) from a continued
    state (count 3, nu drawn from uniform(0.5, 2) * 1e-4, so that an update
    is not lr * sign(g)): the parameters after, atol 1e-6 (float32 ulps of
    the weights), the moments nu rtol 2e-5 (their fresh 1% is g², g held
    to rtol 2e-4 above; the penalty's double backward moves g by ~3e-6);
    the BatchNorm statistics 1e-4.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from de_i2i_gan_tpu.config import TrainConfig as JaxTrainConfig
from de_i2i_gan_tpu.config import WGanConfig as JaxWGanConfig
from de_i2i_gan_tpu.models.discriminator import WGanDiscriminator as JaxD
from de_i2i_gan_tpu.models.generator import WGanGenerator as JaxG
from de_i2i_gan_tpu.nn import layers as jlayers
from de_i2i_gan_tpu.train.wgan_steps import WGanSteps as JaxWGanSteps
from de_i2i_gan_torch.config import TrainConfig, WGanConfig
from de_i2i_gan_torch.models.discriminator import WGanDiscriminator
from de_i2i_gan_torch.models.generator import WGanGenerator
from de_i2i_gan_torch.nn import layers
from de_i2i_gan_torch.train.jax_import import (
    _flatten, _targets, load_jax_module, load_jax_wgan_state)
from de_i2i_gan_torch.train.wgan_steps import WGanSteps, clip_tree
from tests.test_torch_train_step import perturb

torch.set_num_threads(1)

TOL = 5e-4
LOSS_RTOL = 2e-4
GRAD_RTOL, GRAD_ATOL = 2e-4, 1e-5
RMS_ATOL = 1e-6
STATS_TOL = 1e-4
CFG = dict(image_size=32, noise_dim=16, ngf=8, ndf=8, num_layers=2,
           num_critics=2)
BATCH, CRITICS, GP = 4, 2, 10.0
SGD = dict(batch_size=BATCH, num_critics=CRITICS, lr=(2e-2, 1e-2),
           optimizer="sgd")
RMS = dict(batch_size=BATCH, num_critics=CRITICS, lr=(5e-5,),
           optimizer="rmsprop")


def jax_state(jsteps, seed=0):
    """The JAX init state, biases, BN parameters and statistics moved."""
    state = jsteps.init_state(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed + 7)
    rep = {}
    for name in ("G", "D"):
        net = getattr(state, name)
        rep[name] = net.replace(
            params=perturb(jax.device_get(net.params), rng),
            state={"batch_stats": perturb(jax.device_get(
                net.state["batch_stats"]), rng)})
    return state.replace(**rep)


def continued(state, seed):
    """Every RMSprop state drawn: nu uniform(0.5, 2) * 1e-4, counts 3."""
    rng = np.random.default_rng(seed)
    rep = {}
    for name in ("G", "D"):
        net = getattr(state, name)
        parts = []
        for part in net.opt_state:  # scale_by_rms, the schedule, scale
            if "nu" in part._fields:
                part = part._replace(nu=jax.tree_util.tree_map(
                    lambda a: (rng.uniform(0.5, 2, np.shape(a)) * 1e-4
                               ).astype(np.float32), part.nu))
            elif "count" in part._fields:
                part = part._replace(count=np.asarray(3, np.int32))
            parts.append(part)
        rep[name] = net.replace(opt_state=tuple(parts))
    return state.replace(**rep)


def port_steps(tcfg, gp=0.0, state=None):
    steps = WGanSteps(WGanConfig(**CFG), TrainConfig(**tcfg), iters_per_epoch=10,
                      num_epochs=2, gp_weight=gp, device="cpu")
    if state is not None:
        load_jax_wgan_state(steps, jax.device_get(state))
    return steps


def jax_steps(tcfg, gp=0.0):
    return JaxWGanSteps(JaxWGanConfig(**CFG), JaxTrainConfig(**tcfg),
                        iters_per_epoch=10, num_epochs=2, gp_weight=gp)


def d_draws(key):
    """The noise and eps ``WGanSteps.d_step`` draws from ``key``."""
    k_z, k_eps = jax.random.split(key)
    return (np.array(jax.random.normal(k_z, (BATCH, CFG["noise_dim"]))),
            np.array(jax.random.uniform(k_eps, (BATCH, 1, 1, 1))))


def super_draws(key):
    """(z (critics + 1, B, noise), eps (critics, B, 1, 1, 1)) of the JAX
    super-step: a split a critic step, then one for the G step."""
    zs, epss = [], []
    for _ in range(CRITICS):
        key, k = jax.random.split(key)
        z, eps = d_draws(k)
        zs.append(z)
        epss.append(eps)
    key, k = jax.random.split(key)
    zs.append(np.array(jax.random.normal(k, (BATCH, CFG["noise_dim"]))))
    return torch.from_numpy(np.stack(zs)), torch.from_numpy(np.stack(epss))


def images(seed, lead=()):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, (*lead, BATCH, 32, 32, 3)).astype(np.float32)


def port_tree(module, tree, coll="params"):
    """port key -> (port tensor, flax array in the port's layout)."""
    flat = _flatten(jax.device_get(tree))
    return {key: (tensor, to_port(flat[path]))
            for key, tensor, c, path, to_port in _targets(module) if c == coll}


def assert_deltas(module, before_tree, after_tree, lr):
    before = port_tree(module, before_tree)
    for key, (tensor, ref_after) in port_tree(module, after_tree).items():
        start = before[key][1]
        np.testing.assert_allclose((tensor.detach().numpy() - start) / lr,
                                   (ref_after - start) / lr, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=key)


def assert_stats(module, stats_tree):
    for key, (tensor, ref) in port_tree(module, stats_tree, "batch_stats").items():
        np.testing.assert_allclose(tensor.numpy(), ref, atol=STATS_TOL,
                                   err_msg=key)


def assert_metrics(metrics, jmetrics):
    assert sorted(metrics) == sorted(jmetrics)
    for k, v in jmetrics.items():
        np.testing.assert_allclose(metrics[k].item(), float(v), rtol=LOSS_RTOL,
                                   atol=1e-7, err_msg=k)


# ------------------------------------------------------------------- layers


def test_pools_match_jax():
    x = np.random.default_rng(0).normal(size=(2, 9, 9, 5)).astype(np.float32)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = layers.max_pool(xt, 3, 2, 1).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, np.asarray(jlayers.max_pool(x, 3, 2, 1)),
                               atol=1e-6)
    # a negative border: the padding must be -inf, not 0
    neg = -np.abs(x)
    got = layers.max_pool(torch.from_numpy(neg).permute(0, 3, 1, 2), 3, 2, 1)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(jlayers.max_pool(neg, 3, 2, 1)),
                               atol=1e-6)
    np.testing.assert_allclose(layers.adaptive_avg_pool(xt).numpy(),
                               np.asarray(jlayers.adaptive_avg_pool(x)),
                               atol=1e-6)


# --------------------------------------------------------------------- nets


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("net", ["G", "D"])
def test_nets_match_flax(net, train):
    rng = np.random.default_rng(3)
    if net == "G":
        x = rng.normal(size=(BATCH, CFG["noise_dim"])).astype(np.float32)
        jnet, port = JaxG(JaxWGanConfig(**CFG)), WGanGenerator(WGanConfig(**CFG))
    else:
        x = images(4)
        jnet = JaxD(JaxWGanConfig(**CFG))
        port = WGanDiscriminator(WGanConfig(**CFG))
    v = jax.device_get(jnet.init(jax.random.PRNGKey(1), jnp.asarray(x),
                                 train=True))
    params = perturb(v["params"], rng)
    stats = perturb(v["batch_stats"], rng)
    want, mut = jnet.apply({"params": params, "batch_stats": stats},
                           jnp.asarray(x), train=train, mutable=["batch_stats"])
    load_jax_module(port, params, {"batch_stats": stats})
    port.train(train)
    got = port(torch.from_numpy(x))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=TOL)
    assert_stats(port, mut["batch_stats"])


# -------------------------------------------------------------------- steps


@functools.lru_cache(maxsize=None)
def run_step(kind, gp=0.0):
    """(state, JAX state after, JAX metrics, port steps after, port metrics)
    of one ``d_step`` / ``g_step`` under SGD from one state."""
    jsteps = jax_steps(SGD, gp)
    state = jax_state(jsteps)
    batch = {"imgs": images(5)}
    key = jax.random.PRNGKey(2)
    after, jm = jax.jit(getattr(jsteps, kind))(
        state, {"imgs": jnp.asarray(batch["imgs"])}, key)
    port = port_steps(SGD, gp, state)
    tb = {"imgs": torch.from_numpy(batch["imgs"])}
    if kind == "d_step":
        z, eps = d_draws(key)
        m = port.d_step(tb, z=torch.from_numpy(z), eps=torch.from_numpy(eps))
    else:
        z = np.array(jax.random.normal(key, (BATCH, CFG["noise_dim"])))
        m = port.g_step(tb, z=torch.from_numpy(z))
    return state, jax.device_get(after), jax.device_get(jm), port, m


@pytest.mark.parametrize("gp", [0.0, GP], ids=["clipping", "gp"])
def test_d_step_matches_jax(gp):
    state, after, jm, port, m = run_step("d_step", gp)
    assert_metrics(m, jm)
    assert_deltas(port.D, state.D.params, after.D.params, SGD["lr"][0])
    assert_stats(port.D, after.D.state["batch_stats"])
    assert port.step == int(after.step) == 1
    # G is untouched by a critic step
    for key, (tensor, ref) in port_tree(port.G, state.G.params).items():
        np.testing.assert_array_equal(tensor.detach().numpy(), ref, err_msg=key)


def test_clipping_covers_batchnorm_and_not_its_statistics():
    """BatchNorm's scale starts near 1: the step clips it to 0.03 before the
    update (so it ends within lr * |g| of 0.03), as every other parameter;
    the running statistics are not clipped."""
    state, after, _, port, _ = run_step("d_step", 0.0)
    limit = CFG.get("clipping_limit", 0.03)
    scale = port.D.stem.norm.weight.detach().numpy()
    ref = port_tree(port.D, after.D.params)["stem.norm.weight"][1]
    assert np.all(np.abs(scale - limit) < 1e-2) and np.allclose(scale, ref,
                                                               atol=1e-6)
    var = port.D.stem.norm.running_var.numpy()
    assert var.min() > 0.1  # drawn from uniform(0.5, 1.5), lerped to batch var
    probe = [torch.full((3,), 2.0), torch.full((2,), -5.0)]
    clip_tree(probe, 0.03)
    assert torch.equal(probe[0], torch.full((3,), 0.03))
    assert torch.equal(probe[1], torch.full((2,), -0.03))


def test_g_step_matches_jax():
    state, after, jm, port, m = run_step("g_step")
    assert_metrics(m, jm)
    assert_deltas(port.G, state.G.params, after.G.params, SGD["lr"][0])
    assert_stats(port.G, after.G.state["batch_stats"])
    # the critic's statistics stay: G's loss runs D in eval mode
    assert_stats(port.D, state.D.state["batch_stats"])


@functools.lru_cache(maxsize=None)
def run_super(opt, gp):
    tcfg = SGD if opt == "sgd" else RMS
    jsteps = jax_steps(tcfg, gp)
    state = jax_state(jsteps, 1)
    if opt == "rmsprop":
        state = continued(state, 9)
    batches = images(6, (CRITICS,))
    key = jax.random.PRNGKey(4)
    after, jm = jax.jit(jsteps.super_step)(state, {"imgs": jnp.asarray(batches)},
                                           key)
    port = port_steps(tcfg, gp, state)
    z, eps = super_draws(key)
    m = port.super_step({"imgs": torch.from_numpy(batches)}, z=z, eps=eps)
    return state, jax.device_get(after), jax.device_get(jm), port, m


@pytest.mark.parametrize("gp", [0.0, GP], ids=["clipping", "gp"])
def test_super_step_sgd_matches_jax(gp):
    state, after, jm, port, m = run_super("sgd", gp)
    assert_metrics(m, jm)
    assert_deltas(port.G, state.G.params, after.G.params, SGD["lr"][0])
    assert_deltas(port.D, state.D.params, after.D.params, SGD["lr"][0])
    for net in ("G", "D"):
        assert_stats(getattr(port, net), getattr(after, net).state["batch_stats"])
    assert port.step == CRITICS and port.tx_G.count == 1
    assert port.tx_D.count == CRITICS


@pytest.mark.parametrize("gp", [0.0, GP], ids=["clipping", "gp"])
def test_super_step_rmsprop_matches_jax(gp):
    state, after, jm, port, m = run_super("rmsprop", gp)
    assert_metrics(m, jm)
    for net in ("G", "D"):
        module = getattr(port, net)
        for key, (tensor, ref) in port_tree(
                module, getattr(after, net).params).items():
            np.testing.assert_allclose(tensor.detach().numpy(), ref,
                                       atol=RMS_ATOL, err_msg=f"{net} {key}")
        tx = getattr(port, f"tx_{net}")
        nu = port_tree(module, getattr(after, net).opt_state[0].nu)
        for key, (tensor, ref) in nu.items():
            np.testing.assert_allclose(tx.opt.state[tensor]["nu"].numpy(), ref,
                                       rtol=2e-5, atol=1e-12, err_msg=key)
        assert tx.count == int(getattr(after, net).opt_state[1].count)


# ----------------------------------------------------------------- loading


def test_load_jax_wgan_state_is_strict():
    jsteps = jax_steps(RMS)
    state = jax.device_get(jax_state(jsteps))
    params = dict(state.D.params)
    params.pop("critic")
    with pytest.raises(KeyError):
        port_steps(RMS, state=state.replace(D=state.D.replace(params=params)))
    extra = {**state.G.params, "extra": {"kernel": np.zeros((1, 1))}}
    with pytest.raises(KeyError):
        port_steps(RMS, state=state.replace(G=state.G.replace(params=extra)))
    # and a full state loads: every tensor equal
    port = port_steps(RMS, state=state)
    for net in ("G", "D"):
        for key, (tensor, ref) in port_tree(getattr(port, net),
                                            getattr(state, net).params).items():
            np.testing.assert_array_equal(tensor.detach().numpy(), ref)
