"""The port's StarGAN v2 training parts (``models/starganv2.py``
discriminator, ``losses/common.py::r1_penalty``, the solver's ``d_loss_fn`` and
``g_loss_fn``) against the JAX package on the CPU, and the helpers the other
``test_torch_starganv2_train_*`` files share.

Weights and state come from a JAX ``SolverState`` (``init_state``) with every
bias, scale and statistic of G, D, M and S moved off its init value by a
seeded numpy draw, the EMA nets and statistics drawn apart from the nets,
carried into the port by ``train/jax_import.py::load_jax_starganv2``. The
size is the JAX suite's tiny config (``tests/test_starganv2.py``: img 64, 3
domains, max_conv_dim 64, style_dim 8, latent_dim 4, hidden_nc 16, embed_nc
12), batch 2, float32; the batches come from a seed (z in the batch, no
DiffAugment), so neither package draws a random number.

Where the port follows the reference and not the JAX package: the cycle
pass's style code is S(x_real, y_org) (stargan-v2 core/solver.py:531
``s_org = nets.style_encoder(x_real, y_org)``); the JAX ``g_loss_fn`` encodes
x_real for the target domain y_trg. ``JaxSolver`` hands the JAX loss the
source domain for that one call, so the two compute the same loss.

Tolerances: forward 5e-4 (DESIGN.md section 7); loss values rtol 2e-4 (the
JAX suite's gradient checks); gradients per tensor within 1e-3 of their L2
norm (1e-2 for the G loss, whose cycle term runs through G twice: see
G_GRAD_REL), plus 1e-7 * sqrt(numel) for a tensor whose gradient is zero in
exact arithmetic (a conv bias before an instance norm).
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from de_i2i_gan_tpu.losses.common import r1_penalty as jax_r1_penalty
from de_i2i_gan_tpu.models import starganv2 as jsg
from de_i2i_gan_tpu.train.solver import StarGANv2Config as JaxConfig
from de_i2i_gan_tpu.train.solver import StarGANv2Solver as _JaxSolver
from de_i2i_gan_torch.losses.common import r1_penalty
from de_i2i_gan_torch.models import starganv2 as sg
from de_i2i_gan_torch.train.jax_import import (
    _flatten, _targets, load_jax_starganv2)
from de_i2i_gan_torch.train.solver import StarGANv2Config, StarGANv2Solver
from tests.test_torch_starganv2 import carry, jv, perturb

torch.set_num_threads(1)

TOL = 5e-4
LOSS_RTOL = 2e-4
GRAD_REL, GRAD_ATOL = 1e-3, 1e-7
# the G loss's cycle term carries G's input gradient back through a second
# G pass; in float32 that gradient is ill-conditioned (instance norms
# subtract nearly equal means): the port's own input gradient of G moves by
# 8.7e-4 relative between two conv algorithms (oneDNN on and off), and G's,
# M's and S's parameter gradients land up to 5.8e-3 from JAX's (SEAN's
# mlp_beta); the adversarial, style and diversity terms alone hold 1e-3
G_GRAD_REL = 1e-2
STATS_TOL = 1e-5
DOMAINS, STYLE, LATENT, HIDDEN, EMBED, NUM_EMBEDS = 3, 8, 4, 16, 12, 5
BATCH, IMG = 2, 64
CFG = dict(img_size=IMG, num_domains=DOMAINS, style_dim=STYLE,
           latent_dim=LATENT, hidden_nc=HIDDEN, embed_nc=EMBED, w_hpf=0.0,
           max_conv_dim=64, num_embeds=NUM_EMBEDS, ds_iter=10,
           allow_degraded_losses=True)


class JaxSolver(_JaxSolver):
    """The JAX package's solver with the cycle pass's style code encoded for
    the source domain, as the reference's (see the module docstring): its
    ``g_loss_fn`` calls ``S.apply(params, x_real, y_trg)`` for s_org, and
    this S answers that one call (the only one whose images are the
    batch's ``x_src``) with ``y_src``."""

    def g_loss_fn(self, gms_params, state, batch, rng, latent,
                  shared_fake=None):
        net = self.S
        if net is None:
            return super().g_loss_fn(gms_params, state, batch, rng, latent,
                                     shared_fake)

        class _SourceDomainS:
            def apply(self, variables, x, y):
                if x is batch["x_src"]:
                    y = batch["y_src"]
                return net.apply(variables, x, y)

        self.S = _SourceDomainS()
        try:
            return super().g_loss_fn(gms_params, state, batch, rng, latent,
                                     shared_fake)
        finally:
            self.S = net


def config(norm_type, **kw):
    return dict(CFG, norm_type=norm_type, **kw)


def perturbed_state(jsolver, seed):
    """A JAX ``SolverState`` from ``init_state`` with G, D, M and S (and G's
    SEAN statistics) perturbed, and EMA nets and statistics drawn apart."""
    state = jax.device_get(jax.jit(jsolver.init_state)(
        jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    g_state = {k: perturb(v, rng) for k, v in (state.G.state or {}).items()}
    rep = dict(G=state.G.replace(params=perturb(state.G.params, rng),
                                 state=g_state),
               D=state.D.replace(params=perturb(state.D.params, rng)),
               ema_G=perturb(state.G.params, rng))
    if state.ema_sean_stats is not None:
        rep["ema_sean_stats"] = perturb(state.ema_sean_stats, rng)
    if state.M is not None:
        rep.update(M=state.M.replace(params=perturb(state.M.params, rng)),
                   S=state.S.replace(params=perturb(state.S.params, rng)),
                   ema_M=perturb(state.M.params, rng),
                   ema_S=perturb(state.S.params, rng))
    return state.replace(**rep)


def make_batch(seed, sean=False, n=BATCH):
    """A training batch from a seed: images, distinct source and target
    domains, latents, and for SEAN the embeddings."""
    rng = np.random.default_rng(seed)
    y_src = rng.integers(0, DOMAINS, n).astype(np.int32)
    batch = {k: rng.uniform(-1, 1, (n, IMG, IMG, 3)).astype(np.float32)
             for k in ("x_src", "x_ref", "x_ref2")}
    batch.update(y_src=y_src,
                 y_ref=((y_src + 1 + rng.integers(0, DOMAINS - 1, n))
                        % DOMAINS).astype(np.int32),
                 z_ref=rng.normal(0, 1, (n, LATENT)).astype(np.float32),
                 z_ref2=rng.normal(0, 1, (n, LATENT)).astype(np.float32))
    if sean:
        for k in ("s_ref", "s_ref2", "s_src"):
            batch[k] = rng.normal(0, 1, (n, NUM_EMBEDS, EMBED)).astype(
                np.float32)
    return batch


def jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def port_solver(kw, state):
    port = StarGANv2Solver(StarGANv2Config(**kw), device="cpu")
    load_jax_starganv2(port, state)
    return port


def port_params(module, tree):
    """port key -> (port tensor, flax array in the port's layout)."""
    flat = _flatten(jax.device_get(tree))
    return {key: (tensor, to_port(flat[path]))
            for key, tensor, coll, path, to_port in _targets(module)
            if coll == "params"}


def close_grads(module, grads, jax_grads, label, rel=GRAD_REL):
    """Per tensor: ||port - jax|| <= rel ||jax|| + GRAD_ATOL sqrt(n).
    ``grads``: the port's gradients in ``module.parameters()`` order."""
    by_key = dict(zip((k for k, _ in module.named_parameters()), grads))
    refs = port_params(module, jax_grads)
    assert set(by_key) == set(refs)
    live = 0
    for key, (_, ref) in refs.items():
        got = by_key[key].detach().float().numpy()
        diff = np.linalg.norm(got - ref)
        band = rel * np.linalg.norm(ref) + GRAD_ATOL * ref.size ** 0.5
        assert diff <= band, (f"{label} {key}: |d| {diff:.3e} > {band:.3e} "
                              f"(|ref| {np.linalg.norm(ref):.3e})")
        live += np.count_nonzero(ref)
    return live


def close_losses(metrics, jmetrics, rtol=LOSS_RTOL, label=""):
    assert sorted(metrics) == sorted(jmetrics), (sorted(metrics),
                                                 sorted(jmetrics))
    for k, v in jmetrics.items():
        np.testing.assert_allclose(float(metrics[k]), float(v), rtol=rtol,
                                   atol=1e-7, err_msg=f"{label} {k}")


def close_sean_stats(module, sean_stats, tol=STATS_TOL):
    flat = _flatten(jax.device_get(sean_stats))
    n = 0
    for key, tensor, coll, path, _ in _targets(module):
        if coll == "sean_stats":
            np.testing.assert_allclose(tensor.numpy(), flat[path], atol=tol,
                                       rtol=tol, err_msg=key)
            n += 1
    assert n > 0


# --------------------------------------------------------- discriminator


@pytest.mark.parametrize("max_conv_dim", [32, 64])
def test_discriminator_matches_flax(max_conv_dim):
    """Logits of each row's domain, NHWC in, flax's NHWC flattening."""
    x = np.random.default_rng(1).uniform(-1, 1, (3, IMG, IMG, 3)).astype(
        np.float32)
    y = np.asarray([2, 0, 1], np.int32)
    kw = dict(img_size=IMG, num_domains=DOMAINS, max_conv_dim=max_conv_dim)
    jmod, port = jsg.StarGANv2Discriminator(**kw), sg.StarGANv2Discriminator(**kw)
    v = carry(jmod, port, jnp.asarray(x), jnp.asarray(y))
    with torch.no_grad():
        out = port(torch.from_numpy(x), torch.from_numpy(y).long())
    assert out.shape == (3,)
    np.testing.assert_allclose(out.numpy(), np.asarray(
        jmod.apply(jv(v), jnp.asarray(x), jnp.asarray(y))), atol=TOL, rtol=TOL)


def test_r1_penalty_and_its_gradient_match_jax():
    """0.5 E||d sum D(x) / dx||^2 on a bf16 D fed f32 images, and the
    penalty's gradient in D's parameters (the double backward)."""
    x = np.random.default_rng(2).uniform(-1, 1, (2, IMG, IMG, 3)).astype(
        np.float32)
    y = np.asarray([1, 2], np.int32)
    kw = dict(img_size=IMG, num_domains=DOMAINS, max_conv_dim=32)
    jmod = jsg.StarGANv2Discriminator(**kw)
    port = sg.StarGANv2Discriminator(**kw)
    v = carry(jmod, port, jnp.asarray(x), jnp.asarray(y))

    def jax_r1(params):
        return jax_r1_penalty(
            lambda t: jmod.apply({"params": params}, t, jnp.asarray(y)).sum(),
            jnp.asarray(x))

    ref, ref_grads = jax.value_and_grad(jax_r1)(jv(v["params"]))
    xt = torch.from_numpy(x).requires_grad_()
    got = r1_penalty(port(xt, torch.from_numpy(y).long()), xt)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), float(ref), rtol=LOSS_RTOL)
    # the head's bias does not reach the penalty
    grads = torch.autograd.grad(got, list(port.parameters()), allow_unused=True,
                                materialize_grads=True)
    assert close_grads(port, grads, ref_grads, "r1") > 0


# ------------------------------------------------------------ the losses


@functools.lru_cache(maxsize=None)
def loss_run(norm_type):
    """Both packages' D and G losses and gradients from one state, for each
    pass (AdaIN: latent and reference; SEAN: reference, with the batch's
    ``s_fake_pred`` feeding the style term)."""
    kw = config(norm_type)
    jsolver = JaxSolver(JaxConfig(**kw))
    state = perturbed_state(jsolver, 0)
    sean = norm_type == "sean"
    batch = make_batch(3, sean=sean)
    if sean:
        batch["s_fake_pred"] = np.random.default_rng(4).normal(
            0, 1, (BATCH, 1, EMBED)).astype(np.float32)
    passes = (False,) if sean else (True, False)
    rng = jax.random.PRNGKey(5)

    @jax.jit
    def jax_losses(state, jb):
        out = {}
        for latent in passes:
            (_, dm), dg = jax.value_and_grad(jsolver.d_loss_fn, has_aux=True)(
                state.D.params, state, jb, rng, latent)
            m = state.M.params if state.M is not None else None
            s = state.S.params if state.S is not None else None
            (_, (g_state, gm)), gg = jax.value_and_grad(
                jsolver.g_loss_fn, has_aux=True)(
                (state.G.params, m, s), state, jb, rng, latent)
            out[latent] = dict(d_metrics=dm, d_grads=dg, g_metrics=gm,
                               g_grads=gg, g_state=g_state)
        return out

    ref = jax.device_get(jax_losses(jv(state), jax_batch(batch)))
    port = port_solver(kw, state)
    tb = port._batch(torch_batch(batch))
    got = {}
    for latent in passes:
        ld, dm = port.d_loss_fn(tb, latent=latent)
        d_grads = torch.autograd.grad(ld, list(port.D.parameters()))
        lg, gm = port.g_loss_fn(tb, latent=latent)
        nets = [n for n in ("G", "M", "S") if getattr(port, n) is not None]
        params = [p for n in nets for p in getattr(port, n).parameters()]
        flat = torch.autograd.grad(lg, params, allow_unused=True,
                                   materialize_grads=True)
        g_grads, start = {}, 0
        for n in nets:
            size = len(list(getattr(port, n).parameters()))
            g_grads[n] = flat[start:start + size]
            start += size
        got[latent] = dict(d_metrics=dm, d_grads=d_grads, g_metrics=gm,
                           g_grads=g_grads,
                           sean=[b.clone() for b in port.G.buffers()])
    return state, ref, port, got, passes


LOSS_CASES = [("adain", True), ("adain", False), ("sean", False)]
IDS = ["adain-latent", "adain-ref", "sean-ref"]


@pytest.mark.parametrize("norm_type,latent", LOSS_CASES, ids=IDS)
def test_d_loss_and_gradients_match_jax(norm_type, latent):
    """BCE on real and fake logits and R1: the values, and D's gradient."""
    _, ref, port, got, _ = loss_run(norm_type)
    close_losses(got[latent]["d_metrics"], ref[latent]["d_metrics"])
    live = close_grads(port.D, got[latent]["d_grads"],
                       ref[latent]["d_grads"], "D")
    assert live > 0.95 * sum(p.numel() for p in port.D.parameters())


@pytest.mark.parametrize("norm_type,latent", LOSS_CASES, ids=IDS)
def test_g_loss_and_gradients_match_jax(norm_type, latent):
    """adv, sty, ds and cyc: the values, and G's (M's, S's) gradients; D
    is scored but not differentiated."""
    _, ref, port, got, _ = loss_run(norm_type)
    close_losses(got[latent]["g_metrics"], ref[latent]["g_metrics"])
    g, m, s = ref[latent]["g_grads"]
    for name, jax_grads in (("G", g), ("M", m), ("S", s)):
        if jax_grads is None:
            assert getattr(port, name) is None
            continue
        close_grads(getattr(port, name), got[latent]["g_grads"][name],
                    jax_grads, name, rel=G_GRAD_REL)
    assert all(p.grad is None for p in port.D.parameters())


def test_sean_reference_g_loss_tracks_statistics_like_jax():
    """The SEAN reference pass tracks its style codes on x_fake and x_fake2
    (not on x_rec): G's statistics after the loss equal the JAX loss's
    returned state."""
    state, ref, port, got, _ = loss_run("sean")
    g_state = ref[False]["g_state"]["sean_stats"]
    start = _flatten(state.G.state["sean_stats"])
    flat = _flatten(g_state)
    counts = [k for k in flat if k.endswith("count")]
    assert all(flat[k].sum() - start[k].sum() == 2 * BATCH for k in counts)
    probe = StarGANv2Solver(StarGANv2Config(**config("sean")), device="cpu")
    for b, v in zip(probe.G.buffers(), got[False]["sean"]):
        b.copy_(v)
    close_sean_stats(probe.G, g_state)


def test_lambda_ds_decays_with_the_step():
    solver = StarGANv2Solver(StarGANv2Config(**config("adain")), device="cpu")
    jsolver = _JaxSolver(JaxConfig(**config("adain")))
    for step in (0, 3, 10, 12):
        np.testing.assert_allclose(solver._lambda_ds(step),
                                   float(jsolver._lambda_ds(jnp.int32(step))),
                                   rtol=1e-6)
    assert solver._lambda_ds(12) == 0.0


def test_sean_without_the_frozen_vit_refuses_a_zeroed_style_loss():
    """As the JAX solver: lambda_sty inactive is an error unless the config
    allows degraded losses (``set_frozen_nets`` attaches the ViT)."""
    kw = config("sean", allow_degraded_losses=False)
    solver = StarGANv2Solver(StarGANv2Config(**kw), device="cpu")
    solver.init_training()
    batch = solver._batch(torch_batch(make_batch(6, sean=True)))
    with pytest.raises(ValueError, match="allow_degraded_losses"):
        solver.g_loss_fn(batch, latent=False)


def test_training_state_is_built_at_first_training_call():
    """Serving holds G, M, S and their EMA copies; D and the optimizers come
    with the first training call, and init draws D after G, M and S."""
    from de_i2i_gan_torch.train.jax_import import init_starganv2_weights
    solver = StarGANv2Solver(StarGANv2Config(**config("adain")), device="cpu")
    assert solver.D is None and solver.tx_G is None
    init_starganv2_weights(solver, 0)
    before = {k: v.clone() for k, v in solver.G.state_dict().items()}
    trained = StarGANv2Solver(StarGANv2Config(**config("adain")), device="cpu")
    trained.init_training()
    init_starganv2_weights(trained, 0)
    for k, v in trained.G.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert trained.D is not None and trained.tx_M.count == 0
    assert all(not p.requires_grad for p in trained.ema_G.parameters())
    assert all(p.requires_grad for p in trained.G.parameters())
    w = trained.D.block_0.conv1.weight  # he_init, fan_in 256 * 3 * 3
    assert abs(w.std().item() / (2 / (256 * 9)) ** 0.5 - 1) < 0.05
