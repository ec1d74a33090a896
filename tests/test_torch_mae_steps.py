"""One MAE-GAN ``super_step`` in both packages, from one state, for each
decoder; ``split_training``, ``eval_losses`` and ``repair_grid``.

The state, batches and fed masks are ``tests/test_torch_mae.py``'s (the
tiny config of ``tests/test_mae_wgan.py``, 2 critics, batch 2, float32;
SEAN takes the batch's embeddings). The JAX package's ``MAESteps`` runs under
``jax.jit`` with its ``generate_shifted_mask`` patched to the fed mask; the
port's ``MAESteps`` starts from the same state through
``load_jax_mae_state``. Compared, with the tolerances of the JAX suite's
gradient checks (``tests/test_torch_train_step.py``):
  * the loss terms, rtol 2e-4;
  * the gradients of G (with the mask token), E and D as (after - before) /
    lr under SGD, rtol 2e-4 and atol 1e-5 (D's delta sums its two critic
    steps);
  * the parameters after AdamW (0.9, 0.95, weight decay 1e-4, the cosine
    schedule) from a continued optimizer state (count 3, moments drawn),
    atol 1e-6, a few float32 ulps of the weights; and the moments and
    counts carried on;
  * G's BatchNorm running statistics, 1e-4;
  * ``eval_losses`` rtol 2e-4 and ``repair_grid`` 5e-4 (forward);
  * ``remat=True``, which both packages accept and neither applies to MAE:
    the port's super-step equals its own with remat off bit for bit, and
    the JAX ``MAESteps`` with remat on as above.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_mae import (
    BATCH, CRITICS, MAE, STYLES, DefectGanConfig, JaxConfig, JaxMAEConfig,
    JaxTrainConfig, MAEConfig, TrainConfig, fixed_mask, jax_mae_steps,
    jax_state, jax_steps, make_batches, mae_steps, masks_fed, port_params,
    port_steps)
from de_i2i_gan_torch.train.jax_import import _flatten, _targets, load_jax_mae_state

torch.set_num_threads(1)

LOSS_RTOL = 2e-4
GRAD_RTOL, GRAD_ATOL = 2e-4, 1e-5
ADAM_ATOL = 1e-6
STATS_TOL = 1e-4
ADAM_COUNT = 3
LOSSES = ["gan_D", "clf_D", "rec", "gan_G", "clf_G"]
SGD = dict(batch_size=BATCH, num_critics=CRITICS, lr=(2e-2, 1e-2),
           optimizer="sgd", scheduler="cos", loss_weight=(10, 3, 1))
ADAMW = dict(batch_size=BATCH, num_critics=CRITICS, lr=(1.5e-4,),
             optimizer="adamw", scheduler="cos", loss_weight=(10, 3, 1))


def continued(state, seed):
    """``state`` with every AdamW state drawn: counts ADAM_COUNT, mu normal(0,
    1e-3), nu uniform(0.5, 2) * 1e-2."""
    rng = np.random.default_rng(seed)

    def draw(tree, fn):
        return jax.tree_util.tree_map(
            lambda a: fn(np.shape(a)).astype(np.float32), tree)

    rep = {}
    for name in ("G", "D", "E"):
        net = getattr(state, name)
        if net is None:
            continue
        adam, decay, sched = net.opt_state
        adam = adam._replace(
            count=np.asarray(ADAM_COUNT, np.int32),
            mu=draw(adam.mu, lambda s: rng.normal(0, 1e-3, s)),
            nu=draw(adam.nu, lambda s: rng.uniform(0.5, 2, s) * 1e-2))
        sched = sched._replace(count=np.asarray(ADAM_COUNT, np.int32))
        rep[name] = net.replace(opt_state=(adam, decay, sched))
    return state.replace(**rep)


@functools.lru_cache(maxsize=None)
def run_pair(style, opt, seed=0, split=False):
    """(JAX state before, JAX state after, JAX metrics, port steps after,
    port metrics) of one super-step from one state."""
    tcfg = SGD if opt == "sgd" else ADAMW
    mae = dict(MAE, split_training=split)
    jsteps = jax_steps(style, tcfg, mae)
    state = jax_state(jsteps, seed)
    if opt == "adamw":
        state = continued(state, seed + 1)
    batches = make_batches(seed + 2, style)
    with masks_fed(fixed_mask(seed + 3)):
        after, jmetrics = jax.jit(jsteps.super_step)(
            state, {k: jnp.asarray(v) for k, v in batches.items()},
            jax.random.PRNGKey(1))
        port = port_steps(style, tcfg, mae)
        load_jax_mae_state(port, state)
        metrics = port.super_step({k: torch.from_numpy(v)
                                   for k, v in batches.items()})
    return state, jax.device_get(after), jax.device_get(jmetrics), port, metrics


def nets(port, state, after, name):
    """(port module, flax params before, after, lr) of G, the token, E or
    D."""
    lr_g, lr_d = port.tcfg.lr_g, port.tcfg.lr_d
    if name == "G":
        return port.G, state.G.params["net"], after.G.params["net"], lr_g
    if name == "token":
        return port.token, state.G.params["token"], after.G.params["token"], lr_g
    if name == "E":
        return port.E, state.E.params, after.E.params, lr_g
    return port.D, state.D.params, after.D.params, lr_d


def net_names(style):
    return ["G", "token", "D"] + (["E"] if style == "adain" else [])


CASES = [(s, n) for s in ("adain", "sean", "spade") for n in net_names(s)]


def close_metrics(metrics, jmetrics):
    assert sorted(metrics) == sorted(jmetrics) == sorted(LOSSES)
    for k in jmetrics:
        np.testing.assert_allclose(metrics[k].item(), float(jmetrics[k]),
                                   rtol=LOSS_RTOL, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("style", ["adain", "sean", "spade"])
@pytest.mark.parametrize("opt", ["sgd", "adamw"])
def test_super_step_losses_match_jax(style, opt):
    _, _, jmetrics, _, metrics = run_pair(style, opt)
    close_metrics(metrics, jmetrics)


@pytest.mark.parametrize("style,net", CASES)
def test_super_step_gradients_match_jax(style, net):
    state, after, _, port, _ = run_pair(style, "sgd")
    module, before_tree, after_tree, lr = nets(port, state, after, net)
    before = port_params(module, before_tree)
    moved = 0
    for key, (tensor, ref_after) in port_params(module, after_tree).items():
        start = before[key][1]
        ref = (ref_after - start) / lr
        np.testing.assert_allclose((tensor.detach().numpy() - start) / lr, ref,
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=f"{style} {net} {key}")
        moved += np.count_nonzero(ref)
    # SPADE's label convs meet one-hot labels: the ReLU units they leave at
    # zero pass no gradient
    assert moved > 0.8 * sum(t.numel() for t in module.parameters())


@pytest.mark.parametrize("style,net", CASES)
def test_super_step_params_after_adamw_match_jax(style, net):
    """From a continued AdamW state the update is a smooth function of the
    gradient, so every weight is compared."""
    state, after, _, port, _ = run_pair(style, "adamw")
    module, _, after_tree, _ = nets(port, state, after, net)
    for key, (tensor, ref) in port_params(module, after_tree).items():
        np.testing.assert_allclose(tensor.detach().numpy(), ref, rtol=0,
                                   atol=ADAM_ATOL, err_msg=f"{style} {net} {key}")
    tx = {"G": port.tx_G, "token": port.tx_G, "E": port.tx_E, "D": port.tx_D}[net]
    jnet = {"token": "G"}.get(net, net)
    adam = getattr(after, jnet).opt_state[0]
    assert tx.count == int(adam.count) == ADAM_COUNT + (
        CRITICS if net == "D" else 1)
    tree = adam.mu if net not in ("G", "token") else adam.mu[
        "net" if net == "G" else "token"]
    for key, (tensor, ref) in port_params(module, tree).items():
        np.testing.assert_allclose(tx.opt.state[tensor]["exp_avg"].numpy(), ref,
                                   rtol=1e-3, atol=1e-9, err_msg=f"{net} {key}")


@pytest.mark.parametrize("style", ["adain", "sean", "spade"])
def test_super_step_bn_running_stats_match_jax(style):
    state, after, _, port, _ = run_pair(style, "sgd")
    flat = _flatten(after.G.state["batch_stats"])
    start = _flatten(state.G.state["batch_stats"])
    moved = 0
    for key, tensor, coll, path, _ in _targets(port.G):
        if coll == "batch_stats":
            np.testing.assert_allclose(tensor.numpy(), flat[path],
                                       atol=STATS_TOL, rtol=STATS_TOL,
                                       err_msg=key)
            moved += not np.allclose(flat[path], start[path])
    assert moved > 0


def test_super_step_counts_updates():
    state, after, _, port, _ = run_pair("adain", "sgd")
    assert port.step == int(after.step) == int(state.step) + CRITICS
    assert port.tx_D.count == CRITICS and port.tx_G.count == port.tx_E.count == 1
    assert not port.G.training and not port.D.training
    assert all(p.grad is None for n in ("G", "E", "D", "token")
               for p in getattr(port, n).parameters())


# --------------------------------------------------------- split_training


@pytest.mark.parametrize("net", ["G", "token", "E", "D"])
def test_split_training_matches_jax(net):
    """Reconstruction alone in the G step (gan_G = clf_G = 0, D unused), the
    classifier alone in the D step (gan_D = 0, D's source head idle)."""
    state, after, jmetrics, port, metrics = run_pair("adain", "sgd",
                                                     split=True)
    close_metrics(metrics, jmetrics)
    assert metrics["gan_G"].item() == metrics["clf_G"].item() == 0.0
    assert metrics["gan_D"].item() == 0.0
    module, before_tree, after_tree, lr = nets(port, state, after, net)
    before = port_params(module, before_tree)
    for key, (tensor, ref_after) in port_params(module, after_tree).items():
        start = before[key][1]
        np.testing.assert_allclose((tensor.detach().numpy() - start) / lr,
                                   (ref_after - start) / lr, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=f"{net} {key}")


# ----------------------------------------------- eval_losses, repair_grid


@pytest.mark.parametrize("style", ["adain", "sean", "spade"])
def test_eval_losses_and_repair_grid_match_jax(style):
    """From the state after the SGD super-step (the port's and JAX's
    agree there within the bands above): mae_inference's losses and the
    five repair panels, every net in eval mode."""
    _, after, _, port, _ = run_pair(style, "sgd")
    jsteps = jax_steps(style, SGD)
    batch = {k: v[0] for k, v in make_batches(9, style).items()}
    mask = fixed_mask(10)
    load_jax_mae_state(port, after)
    with masks_fed(mask):
        ref = jax.jit(jsteps.eval_losses)(
            after, {k: jnp.asarray(v) for k, v in batch.items()},
            jax.random.PRNGKey(4))
        got = port.eval_losses({k: torch.from_numpy(v)
                                for k, v in batch.items()})
    assert sorted(got) == sorted(ref) == ["clf", "gan", "rec"]
    for k in ref:
        np.testing.assert_allclose(got[k].item(), float(ref[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    grid_ref = jsteps.repair_grid(after, jnp.asarray(batch["imgs"]),
                                  jnp.asarray(batch["labels"]),
                                  jax.random.PRNGKey(5),
                                  mask=jnp.asarray(mask))
    grid = port.repair_grid(torch.from_numpy(batch["imgs"]),
                            torch.from_numpy(batch["labels"]),
                            mask=torch.from_numpy(mask))
    assert grid.shape == (BATCH, 5, 32, 32, 3) and grid.dtype == torch.float32
    np.testing.assert_allclose(grid.numpy(), np.asarray(grid_ref), atol=5e-4,
                               rtol=5e-4)


def test_loss_weight_must_have_three_entries():
    with pytest.raises(ValueError, match="3 entries"):
        port_steps("adain", dict(SGD, loss_weight=(2, 5, 5, 5, 1)))


def test_remat_is_accepted_and_changes_nothing():
    """ROADMAP C.1: the JAX ``MAESteps`` never reads ``cfg.remat``; the port
    accepts it too. One SGD super-step with remat on equals one with it off
    (every tensor and loss, bit for bit), and JAX's with remat on (the
    tolerances above)."""
    style = "adain"
    jsteps = jax_mae_steps.MAESteps(
        JaxConfig(**STYLES[style], remat=True), JaxMAEConfig(**MAE),
        JaxTrainConfig(**SGD), iters_per_epoch=10, num_epochs=2)
    state = jax_state(jsteps, 0)
    batches = make_batches(2, style)
    runs = {}
    with masks_fed(fixed_mask(3)):
        after, jmetrics = jax.jit(jsteps.super_step)(
            state, {k: jnp.asarray(v) for k, v in batches.items()},
            jax.random.PRNGKey(1))
        for remat in (False, True):
            port = mae_steps.MAESteps(
                DefectGanConfig(**STYLES[style], remat=remat),
                MAEConfig(**MAE), TrainConfig(**SGD), device="cpu",
                iters_per_epoch=10, num_epochs=2)
            load_jax_mae_state(port, state)
            runs[remat] = (port, port.super_step(
                {k: torch.from_numpy(v) for k, v in batches.items()}))
    (off, m_off), (on, m_on) = runs[False], runs[True]
    assert on.cfg.remat and sorted(m_on) == sorted(m_off)
    assert all(torch.equal(m_on[k], m_off[k]) for k in m_off)
    for name in ("G", "token", "E", "D"):
        a, b = getattr(on, name).state_dict(), getattr(off, name).state_dict()
        assert all(torch.equal(a[k], b[k]) for k in b), name
    close_metrics(m_on, jax.device_get(jmetrics))
    after = jax.device_get(after)
    for name in net_names(style):
        module, before_tree, after_tree, lr = nets(on, state, after, name)
        before = port_params(module, before_tree)
        for key, (tensor, ref_after) in port_params(module, after_tree).items():
            start = before[key][1]
            np.testing.assert_allclose(
                (tensor.detach().numpy() - start) / lr,
                (ref_after - start) / lr, rtol=GRAD_RTOL, atol=GRAD_ATOL,
                err_msg=f"remat {name} {key}")
