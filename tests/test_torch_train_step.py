"""One DefectGAN training super-step in both packages, from one state.

The JAX package's ``init_state`` makes the state; biases, BatchNorm
parameters and running statistics are moved off their init values by a
seeded numpy draw, and ``train/jax_import.py::load_jax_train_state``
carries G, E, D and their state (running statistics, spectral u/v, SEAN
statistics) into the port. Both packages then run ``super_step`` (2
critics, batch 2, tiny config, float32) on the same numpy batches: the
AdaIN decoder; the SEAN decoder with spectral norm, running statistics and
distillation; the SPADE decoder with spectral norm. These paths draw no
random numbers (``add_noise=False``, the E image path), except the
DiffAugment run, which the JAX package's own draws are fed into.

Compared, with the tolerances of the JAX suite's gradient checks:
  * the loss terms, rtol 2e-4;
  * the gradients, as (after - before) / lr under SGD, rtol 2e-4 and atol
    1e-5, since absolute parameters would hide a wrong gradient under
    lr * g (D's delta sums its two critic steps);
  * the parameters after Adam, atol 1e-6 (a few float32 ulps of the
    weights, against an update of lr = 1e-4 or 2e-4 per element) wherever
    the gradient is above 1e-6. Adam's first step moves a weight by about
    lr * g / (|g| + 1e-8), so a gradient that is zero in exact arithmetic
    (the BatchNorm bias just before an instance norm) moves by an amount
    set by rounding noise in either package. Those weights are left out;
    at least 90% of each network's weights are compared;
  * the BatchNorm running statistics, 1e-4; the spectral u/v and the SEAN
    statistics, 1e-4;
  * the distillation terms, rtol 2e-4 and atol 1e-5: KL divergences of two
    nearly equal distributions, differences of nearly equal logarithms;
  * the EMA generator (ema_decay 0.999).
"""
from collections.abc import Mapping

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from de_i2i_gan_tpu.config import DefectGanConfig as JaxConfig
from de_i2i_gan_tpu.config import TrainConfig as JaxTrainConfig
from de_i2i_gan_tpu.train.steps import DefectGanSteps as JaxSteps
from de_i2i_gan_torch.config import DefectGanConfig, TrainConfig
from de_i2i_gan_torch.train.jax_import import (
    _flatten, _targets, init_weights, load_jax_train_state)
from de_i2i_gan_torch.train.steps import DefectGanSteps
from de_i2i_gan_torch.utils import diffaug
from tests.test_torch_train_options import jax_draws

torch.set_num_threads(1)

TINY = dict(image_size=32, label_nc=4, ngf=8, ndf=8, num_res=2, hidden_nc=16,
            num_layers=2, style_norm_block_type="adain", use_pallas=True)
CRITICS, BATCH = 2, 2
LOSS_RTOL = 2e-4
GRAD_RTOL, GRAD_ATOL = 2e-4, 1e-5
ADAM_ATOL = 1e-6
STATS_TOL = 1e-4
DISTILL_ATOL = 1e-5
EMBED_NC, NUM_EMBEDS = 24, 3
STYLE_TINY = {
    "sean": dict(TINY, style_norm_block_type="sean", embed_nc=EMBED_NC,
                 num_embeds=NUM_EMBEDS, use_spectral=True,
                 use_running_stats=True, style_distill=True),
    "spade": dict(TINY, style_norm_block_type="spade", use_spectral=True),
}
LR = (2e-2, 1e-2)  # SGD: deltas well above the float32 ulp of the weights


class _JaxSteps(JaxSteps):
    """The JAX package's steps, with the G step finding every distillation
    term SEAN sows. Its ``g_loss_fn`` looks for ``latent`` and ``embed`` at
    the top of the ``distill_loss`` collection, where flax nests them under
    each SEAN module's path, so it adds none of them to the loss and reports
    both as 0 (``de_i2i_gan_tpu/train/steps.py:341-354``). Handed the terms
    grouped by name, it computes the loss its code intends, 0.1 * sum of
    the latent terms + sum of the embedding terms, which the port computes."""

    def _g_apply(self, *args, **kw):
        out, state, sown = super()._g_apply(*args, **kw)
        if sown is not None:
            sown = {name: _sown(sown, name) for name in ("latent", "embed")}
        return out, state, sown


def _sown(tree, name):
    """Every value sown under ``name`` anywhere in a nested collection."""
    found = []
    for k, v in tree.items():
        if k == name:
            found.extend(jax.tree_util.tree_leaves(v))
        elif isinstance(v, Mapping):
            found.extend(_sown(v, name))
    return found


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


def _batches(seed=0, sean=False):
    rng = np.random.default_rng(seed)
    shape = (CRITICS, BATCH, 32, 32, 3)
    batches = {"bg": rng.uniform(-1, 1, shape).astype(np.float32),
               "df": rng.uniform(-1, 1, shape).astype(np.float32),
               "df_labels": np.eye(4, dtype=np.float32)[
                   rng.integers(0, 4, (CRITICS, BATCH))]}
    if sean:
        for k in ("nm_embeds", "df_embeds"):
            batches[k] = rng.normal(0, 1, (CRITICS, BATCH, NUM_EMBEDS,
                                           EMBED_NC)).astype(np.float32)
    return batches


def _trees(state):
    get = jax.device_get
    return dict(g_params=get(state.G.params), g_state=get(state.G.state),
                d_params=get(state.D.params), d_state=get(state.D.state),
                e_params=None if state.E is None else get(state.E.params),
                step=int(state.step),
                ema_params=None if state.ema_G is None else get(state.ema_G))


def run_pair(cfg_kw, tcfg_kw, seed=0):
    """(JAX state before, JAX state after, JAX metrics, port steps after,
    port metrics) of one super-step from one state."""
    jsteps = _JaxSteps(JaxConfig(**cfg_kw), JaxTrainConfig(**tcfg_kw))
    state = jsteps.init_state(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    g_state = jax.device_get(state.G.state)
    state = state.replace(
        G=state.G.replace(
            params=perturb(jax.device_get(state.G.params), rng),
            state={**g_state,
                   "batch_stats": perturb(g_state["batch_stats"], rng)}),
        D=state.D.replace(params=perturb(jax.device_get(state.D.params), rng)))
    if state.E is not None:
        state = state.replace(E=state.E.replace(
            params=perturb(jax.device_get(state.E.params), rng)))
    if state.ema_G is not None:
        state = state.replace(ema_G=perturb(state.G.params, rng))
    batches = _batches(seed, sean=cfg_kw["style_norm_block_type"] == "sean")
    after, jmetrics = jax.jit(jsteps.super_step)(
        state, {k: jnp.asarray(v) for k, v in batches.items()},
        jax.random.PRNGKey(1))
    steps = DefectGanSteps(DefectGanConfig(**cfg_kw), TrainConfig(**tcfg_kw),
                           device="cpu")
    load_jax_train_state(steps, **_trees(state))
    metrics = steps.super_step({k: torch.from_numpy(v)
                                for k, v in batches.items()})
    return state, after, jax.device_get(jmetrics), steps, metrics


SGD = dict(batch_size=BATCH, num_critics=CRITICS, lr=LR, optimizer="sgd",
           ema_decay=0.999)
ADAM = dict(batch_size=BATCH, num_critics=CRITICS, lr=(2e-4, 1e-4))


@pytest.fixture(scope="module")
def sgd_run():
    return run_pair(TINY, SGD)


@pytest.fixture(scope="module")
def adam_run():
    return run_pair(TINY, ADAM)


def _nets(steps, state, after, name):
    """(port module, flax params before, flax params after, lr)."""
    if name == "G":
        return steps.G, state.G.params, after.G.params, steps.tcfg.lr_g
    if name == "E":
        return steps.E, state.E.params, after.E.params, steps.tcfg.lr_g
    return steps.D, state.D.params, after.D.params, steps.tcfg.lr_d


def _params(module, tree):
    """port key -> (port tensor, flax array in the port's layout)."""
    flat = _flatten(jax.device_get(tree))
    return {key: (tensor, to_port(flat[path]))
            for key, tensor, coll, path, to_port in _targets(module)
            if coll == "params"}


LOSSES = ["gan_D", "clf_D", "gan_G", "clf_G", "rec", "sd_cyc", "sd_con"]


def _close_metrics(metrics, jmetrics, expected=LOSSES):
    assert sorted(metrics) == sorted(jmetrics) == sorted(expected)
    for k in jmetrics:
        atol = DISTILL_ATOL if k.startswith("distill") else 0.0
        np.testing.assert_allclose(metrics[k].item(), float(jmetrics[k]),
                                   rtol=LOSS_RTOL, atol=atol, err_msg=k)


@pytest.mark.parametrize("run", ["sgd_run", "adam_run"])
def test_super_step_losses_match_jax(run, request):
    _, _, jmetrics, _, metrics = request.getfixturevalue(run)
    _close_metrics(metrics, jmetrics)


@pytest.mark.parametrize("net", ["G", "E", "D"])
def test_super_step_gradients_match_jax(net, sgd_run):
    state, after, _, steps, _ = sgd_run
    module, before_tree, after_tree, lr = _nets(steps, state, after, net)
    before = _params(module, before_tree)
    moved = 0
    for key, (tensor, ref_after) in _params(module, after_tree).items():
        start = before[key][1]
        got = (tensor.detach().numpy() - start) / lr
        ref = (ref_after - start) / lr
        np.testing.assert_allclose(got, ref, rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=f"{net} {key}")
        moved += np.count_nonzero(ref)
    assert moved > 0.95 * sum(t.numel() for t in module.parameters())


@pytest.mark.parametrize("net", ["G", "E", "D"])
def test_super_step_params_after_adam_match_jax(net, adam_run):
    state, after, _, steps, _ = adam_run
    module, _, after_tree, _ = _nets(steps, state, after, net)
    # JAX's bias-corrected first moment: the gradient of the one update
    # (for D a weighted mean of its two)
    adam = getattr(after, net).opt_state[0]
    grads = _params(module, jax.tree_util.tree_map(
        lambda m: m / (1 - 0.5 ** int(adam.count)), adam.mu))
    checked = 0
    for key, (tensor, ref) in _params(module, after_tree).items():
        got = tensor.detach().numpy()
        live = np.abs(grads[key][1]) > 1e-6
        np.testing.assert_allclose(got[live], ref[live], rtol=0,
                                   atol=ADAM_ATOL, err_msg=f"{net} {key}")
        checked += live.sum()
    assert checked > 0.9 * sum(t.numel() for t in module.parameters())


@pytest.mark.parametrize("run", ["sgd_run", "adam_run"])
def test_super_step_bn_running_stats_match_jax(run, request):
    """Two fused hops with bn_groups=2: four updates of every running
    average, group after group."""
    state, after, _, steps, _ = request.getfixturevalue(run)
    flat = _flatten(jax.device_get(after.G.state["batch_stats"]))
    start = _flatten(jax.device_get(state.G.state["batch_stats"]))
    moved = 0
    for key, tensor, coll, path, _ in _targets(steps.G):
        if coll == "batch_stats":
            np.testing.assert_allclose(tensor.numpy(), flat[path],
                                       atol=STATS_TOL, rtol=STATS_TOL,
                                       err_msg=key)
            moved += not np.allclose(flat[path], start[path])
    assert moved > 0


def test_ema_generator_matches_jax(sgd_run):
    _, after, _, steps, _ = sgd_run
    for key, (tensor, ref) in _params(steps.ema_G, after.ema_G).items():
        np.testing.assert_allclose(tensor.detach().numpy(), ref, rtol=1e-6,
                                   atol=1e-7, err_msg=key)
    for e, g in zip(steps.ema_G.buffers(), steps.G.buffers()):
        assert torch.equal(e, g)


def test_super_step_counts_updates(sgd_run):
    state, after, _, steps, _ = sgd_run
    assert steps.step == int(after.step) == int(state.step) + CRITICS
    assert steps.tx_D.count == CRITICS
    assert steps.tx_G.count == steps.tx_E.count == 1
    assert not steps.G.training  # G is back in eval mode for serving


def test_unfused_g_forward_matches_jax():
    """fused_g_forward=False: four B forwards in the G step and two in the
    D step, against the JAX package's reference-order schedule."""
    state, after, jmetrics, steps, metrics = run_pair(
        dict(TINY, fused_g_forward=False), dict(SGD, ema_decay=0.0), seed=3)
    _close_metrics(metrics, jmetrics)
    module, before_tree, after_tree, lr = _nets(steps, state, after, "G")
    before = _params(module, before_tree)
    for key, (tensor, ref_after) in _params(module, after_tree).items():
        start = before[key][1]
        np.testing.assert_allclose((tensor.detach().numpy() - start) / lr,
                                   (ref_after - start) / lr, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=key)


def test_training_state_is_built_at_first_training_call():
    """Serving holds G and E only; D and the optimizers come with the first
    training call."""
    steps = DefectGanSteps(DefectGanConfig(**TINY), TrainConfig(**ADAM),
                           device="cpu")
    x = torch.zeros(2, 32, 32, 3)
    steps.generate(x, torch.eye(4)[:2])
    assert steps.D is None and steps.tx_D is None and steps.tx_G is None
    steps.d_step({"bg": x, "df": x, "df_labels": torch.eye(4)[:2]})
    assert steps.D is not None and steps.tx_E is not None
    assert steps.step == 1 and steps.tx_D.count == 1 and steps.tx_G.count == 0


@pytest.mark.parametrize("option", [dict(remat=True)])
def test_unported_training_options_raise(option):
    """``remat`` raised while it was not ported; now it builds the training
    state and its super-step is the one without it (losses and every
    parameter within 1e-6; ``tests/test_torch_remat.py`` holds it with noise,
    spectral norm and SEAN's statistics)."""
    runs = []
    for cfg_kw in (option, {}):
        steps = DefectGanSteps(DefectGanConfig(**TINY, **cfg_kw),
                               TrainConfig(**ADAM), device="cpu")
        steps.init_training()
        init_weights(steps, 0)
        metrics = steps.super_step({k: torch.from_numpy(v)
                                    for k, v in _batches(2).items()})
        runs.append((steps, metrics))
    (on, m_on), (off, m_off) = runs
    for k in m_off:
        torch.testing.assert_close(m_on[k], m_off[k], rtol=1e-6, atol=0)
    for net in ("G", "E", "D"):
        for (k, p), q in zip(getattr(on, net).named_parameters(),
                             getattr(off, net).parameters()):
            torch.testing.assert_close(p, q, rtol=0, atol=1e-6, msg=k)


def test_diff_aug_super_step_matches_jax(monkeypatch):
    """DiffAugment on the 4B D batches and the 2B G batch, every policy: the
    port's steps are fed the draws the JAX super-step makes from its keys
    (the scan's split per critic, then the D step's fourth and the G step's
    sixth subkey), and must land where the JAX super-step lands. (At some
    seeds, 4 among them, with or without DiffAugment, a near-tie inside
    ``sd_cyc``'s L1 term takes the other sign of its gradient in one package
    and moves G's deltas by 1%; seed 1 has none.)"""
    policy = "color,translation,cutout"
    key, draws = jax.random.PRNGKey(1), []
    for _ in range(CRITICS):
        key, k = jax.random.split(key)
        draws.append(jax_draws(jax.random.split(k, 4)[3],
                               (4 * BATCH, 32, 32, 3), policy))
    key, k = jax.random.split(key)
    draws.append(jax_draws(jax.random.split(k, 6)[5], (2 * BATCH, 32, 32, 3),
                           policy))

    def fed(shape, policy_, generator=None, device=None, dtype=None):
        assert policy_ == policy
        return draws.pop(0)

    monkeypatch.setattr(diffaug, "draw_diff_augment", fed)
    state, after, jmetrics, steps, metrics = run_pair(
        TINY, dict(SGD, ema_decay=0.0, diff_aug=policy), seed=1)
    assert not draws  # every D and G batch was augmented
    _close_metrics(metrics, jmetrics)
    for net in ("G", "D"):
        module, before_tree, after_tree, lr = _nets(steps, state, after, net)
        before = _params(module, before_tree)
        for key_, (tensor, ref_after) in _params(module, after_tree).items():
            start = before[key_][1]
            np.testing.assert_allclose((tensor.detach().numpy() - start) / lr,
                                       (ref_after - start) / lr, rtol=GRAD_RTOL,
                                       atol=GRAD_ATOL, err_msg=f"{net} {key_}")


@pytest.fixture(scope="module", params=sorted(STYLE_TINY))
def style_run(request):
    """One SGD super-step of the SEAN or the SPADE decoder."""
    return request.param, run_pair(STYLE_TINY[request.param],
                                   dict(SGD, ema_decay=0.0), seed=0)


def test_style_decoder_super_step_losses_match_jax(style_run):
    style, (_, _, jmetrics, _, metrics) = style_run
    _close_metrics(metrics, jmetrics, LOSSES + (
        ["distill_latent", "distill_embed"] if style == "sean" else []))


@pytest.mark.parametrize("net", ["G", "D"])
def test_style_decoder_super_step_gradients_match_jax(net, style_run):
    """(after - before) / lr under SGD, spectral norm on G and D."""
    _, (state, after, _, steps, _) = style_run
    module, before_tree, after_tree, lr = _nets(steps, state, after, net)
    before = _params(module, before_tree)
    moved = 0
    for key, (tensor, ref_after) in _params(module, after_tree).items():
        start = before[key][1]
        ref = (ref_after - start) / lr
        np.testing.assert_allclose((tensor.detach().numpy() - start) / lr, ref,
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=f"{net} {key}")
        moved += np.count_nonzero(ref)
    # SPADE's label convs meet one-hot labels: the ReLU units they leave at
    # zero pass no gradient, about a seventh of G's weights
    assert moved > 0.8 * sum(t.numel() for t in module.parameters())


def test_style_decoder_super_step_state_matches_jax(style_run):
    """G's BatchNorm statistics, spectral u/v and SEAN statistics, and D's
    spectral u/v, after the super-step: D's vectors moved once per critic,
    G's once per train-mode hop of the G step."""
    style, (state, after, _, steps, _) = style_run
    colls = {"G": ("batch_stats", "spectral", "sean_stats"), "D": ("spectral",)}
    for net, module in (("G", steps.G), ("D", steps.D)):
        flat = {c: _flatten(jax.device_get(getattr(after, net).state.get(c)))
                for c in colls[net]}
        start = {c: _flatten(jax.device_get(getattr(state, net).state.get(c)))
                 for c in colls[net]}
        seen = set()
        for key, tensor, coll, path, to_port in _targets(module):
            if coll not in colls[net]:
                continue
            np.testing.assert_allclose(tensor.numpy(), to_port(flat[coll][path]),
                                       atol=STATS_TOL, rtol=STATS_TOL,
                                       err_msg=f"{net} {key}")
            if not np.allclose(flat[coll][path], start[coll][path]):
                seen.add(coll)
        assert seen == set(colls[net]) - ({"sean_stats"} if style == "spade"
                                          else set()), (net, seen)


def test_load_jax_train_state_is_strict(sgd_run):
    state, _, _, _, _ = sgd_run
    trees = _trees(state)
    d_params = dict(trees["d_params"])
    d_params.pop("src_clf")
    steps = DefectGanSteps(DefectGanConfig(**TINY), TrainConfig(**SGD),
                           device="cpu")
    with pytest.raises(KeyError, match="src_clf/conv/kernel"):
        load_jax_train_state(steps, **dict(trees, d_params=d_params))
