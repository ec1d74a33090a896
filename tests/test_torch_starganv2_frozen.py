"""StarGAN v2 with the frozen nets (``train/solver.py::set_frozen_nets``)
against the JAX package on the CPU.

* SEAN's lambda_sty term with the frozen ViT: the reference pass's G loss
  values and the **gradient of the style term alone** w.r.t. G, not only
  a step (Adam with beta1 = 0 would hide a wrong gradient, ROADMAP C), at
  ``tests/test_solver_frozen.py``'s config (64^2, 3 domains, the tiny ViT
  at 32^2 fed by an antialiased 64 -> 32 resize, embed_nc 16), from one
  perturbed JAX state carried across with ``load_jax_starganv2`` and
  ``load_jax_vit``. The ViT's parameters take no gradient.
* The masked generator (``w_hpf 1``) inside the G loss: AdaIN's latent pass
  with the batch's FAN masks and ``masks_fake``, values and gradients.
* ``train_step`` with the FAN attached makes the masks of x_src and of
  each pass's x_fake; without the FAN the masked cycle needs
  ``allow_degraded_losses``, as in JAX.
* SEAN pretraining (``init_pretrain``) with the ViT: the reference pass
  alone, the style term live.

Tolerances: loss values rtol 2e-4; gradients per tensor within the G band
of ``tests/test_torch_starganv2_train.py`` (1e-2 of the L2 norm).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import de_i2i_gan_tpu.models.vit as jvit
from de_i2i_gan_torch.models import vit, wing
from de_i2i_gan_torch.train.jax_import import load_jax_vit
from de_i2i_gan_torch.train.solver import StarGANv2Config, StarGANv2Solver
from tests.test_torch_starganv2 import jv
from tests.test_torch_starganv2_train import (
    G_GRAD_REL, JaxConfig, JaxSolver, close_grads, close_losses,
    config, jax_batch, make_batch, perturbed_state, port_solver, torch_batch)

torch.set_num_threads(1)

EMBED = 16  # the tiny ViT's width
BATCH = 2


def sean_batch(seed):
    batch = make_batch(seed)
    rng = np.random.default_rng(seed + 100)
    for k in ("s_ref", "s_ref2", "s_src"):
        batch[k] = rng.normal(0, 1, (BATCH, 2, EMBED)).astype(np.float32)
    return batch


def tiny_vit():
    net = jvit.ViTEncoder(model_size="tiny", image_size=32)
    v = jax.device_get(net.init(jax.random.PRNGKey(3),
                                jnp.zeros((1, 32, 32, 3), jnp.float32)))
    rng = np.random.default_rng(3)
    v = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.normal(0, 0.05, a.shape).astype(
            np.float32), v)
    port = vit.ViTEncoder("tiny", image_size=32)
    load_jax_vit(port, v["params"])
    return net, v, port


def test_sean_style_term_gradient_matches_jax():
    kw = config("sean", embed_nc=EMBED, allow_degraded_losses=False)
    jsolver = JaxSolver(JaxConfig(**kw))
    jnet, v, port_vit = tiny_vit()
    jsolver.set_frozen_nets(vit_variables=v, vit_encoder=jnet)
    state = perturbed_state(jsolver, 0)
    batch = sean_batch(3)
    rng = jax.random.PRNGKey(5)

    def jax_loss(g_params):
        loss, (_, m) = jsolver.g_loss_fn((g_params, None, None), jv(state),
                                         jax_batch(batch), rng, False)
        return loss, m

    @jax.jit
    def jax_grads(g_params):
        (_, m), grads = jax.value_and_grad(jax_loss, has_aux=True)(g_params)
        return m, grads, jax.grad(lambda p: jax_loss(p)[1]["sty"])(g_params)

    jm, jgrads, sty_grads = jax_grads(jv(state.G.params))

    port = port_solver(kw, state)
    port.set_frozen_nets(vit=port_vit)
    tb = port._batch(torch_batch(batch))
    loss, m = port.g_loss_fn(tb, latent=False)
    assert float(m["sty"].detach()) > 0
    close_losses({k: v.detach() for k, v in m.items()}, jm)
    params = list(port.G.parameters())
    sty = torch.autograd.grad(m["sty"], params, retain_graph=True,
                              allow_unused=True, materialize_grads=True)
    assert close_grads(port.G, sty, jax.device_get(sty_grads), "sty",
                       rel=G_GRAD_REL) > 0
    total = torch.autograd.grad(loss, params, allow_unused=True,
                                materialize_grads=True)
    close_grads(port.G, total, jax.device_get(jgrads), "G", rel=G_GRAD_REL)
    assert not any(p.requires_grad for p in port.vit.parameters())
    assert all(p.grad is None for p in port.vit.parameters())


def masks(seed, n=BATCH):
    """Two NHWC 256^2 masks in [0, 1] from a seed (smooth, not flat)."""
    rng = np.random.default_rng(seed)
    low = rng.uniform(0, 1, (2, n, 8, 8, 1)).astype(np.float32)
    return [np.array(jax.image.resize(jnp.asarray(m), (n, 256, 256, 1),
                                      "bilinear")) for m in low]


def test_masked_g_loss_and_gradients_match_jax():
    """AdaIN's latent pass at w_hpf 1: the masked G in the fake, the
    diversity and the cycle (``masks_fake``) forwards."""
    kw = config("adain", w_hpf=1.0)
    jsolver = JaxSolver(JaxConfig(**kw))
    state = perturbed_state(jsolver, 1)
    batch = make_batch(4)
    batch["masks"], batch["masks_fake"] = masks(5), masks(6)
    rng = jax.random.PRNGKey(5)

    def jax_loss(gms):
        loss, (_, m) = jsolver.g_loss_fn(gms, jv(state), jax_batch(batch),
                                         rng, True)
        return loss, m

    gms = (state.G.params, state.M.params, state.S.params)
    (_, jm), jgrads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(
        jv(gms))
    port = port_solver(kw, state)
    tb = port._batch({**torch_batch({k: v for k, v in batch.items()
                                     if not k.startswith("masks")}),
                      "masks": batch["masks"],
                      "masks_fake": batch["masks_fake"]})
    loss, m = port.g_loss_fn(tb, latent=True)
    close_losses({k: v.detach() for k, v in m.items()}, jm)
    nets = ("G", "M", "S")
    params = [p for n in nets for p in getattr(port, n).parameters()]
    flat = torch.autograd.grad(loss, params, allow_unused=True,
                               materialize_grads=True)
    start = 0
    for name, ref in zip(nets, jax.device_get(jgrads)):
        size = len(list(getattr(port, name).parameters()))
        close_grads(getattr(port, name), flat[start:start + size], ref, name,
                    rel=G_GRAD_REL)
        start += size


def test_train_step_takes_the_fan_masks(monkeypatch):
    """With the FAN attached: the masks of x_src once, those of x_fake in
    each G pass's cycle; every G forward gets masks. Without it, a masked
    batch's cycle needs allow_degraded_losses."""
    kw = config("adain", w_hpf=1.0, allow_degraded_losses=False)
    solver = StarGANv2Solver(StarGANv2Config(**kw), device="cpu")
    solver.init_training()
    fan = wing.make_fan("cpu", seed=1)
    solver.set_frozen_nets(fan=fan)
    seen, real = [], wing.fan_masks

    def counted(f, x):
        seen.append(tuple(x.shape))
        return real(f, x)

    monkeypatch.setattr(wing, "fan_masks", counted)
    calls, g_forward = [], solver.G.forward

    def spy(x, s, masks=None, **kw_):
        calls.append(masks is not None)
        return g_forward(x, s, masks, **kw_)

    monkeypatch.setattr(solver.G, "forward", spy)
    m = solver.train_step(torch_batch(make_batch(7)))
    assert seen == [(BATCH, 64, 64, 3)] * 3
    assert calls and all(calls)
    assert all(np.isfinite(float(v)) for v in m.values())

    plain = StarGANv2Solver(StarGANv2Config(**kw), device="cpu")
    plain.init_training()
    batch = plain._batch(torch_batch(make_batch(7)))
    batch["masks"] = [torch.from_numpy(a) for a in masks(8)]
    with pytest.raises(ValueError, match="allow_degraded_losses"):
        plain.g_loss_fn(batch, latent=True)


def test_sean_pretrain_with_the_vit():
    kw = config("sean", embed_nc=EMBED)
    solver = StarGANv2Solver(StarGANv2Config(**kw), device="cpu")
    solver.init_pretrain(0.5, 16)
    solver.init_training()
    solver.set_frozen_nets(vit=tiny_vit()[2])
    batch = sean_batch(9)
    m = solver.pretrain_step(torch_batch(batch),
                             torch.Generator().manual_seed(0))
    assert set(m) == {"D/ref_real", "D/ref_fake", "D/ref_reg", "G/ref_adv",
                      "G/ref_sty", "G/ref_rec", "G/ref_ds"}
    assert float(m["G/ref_sty"]) > 0 and float(m["G/ref_ds"]) == 0
    assert solver.step == 1 and solver.tx_G.count == 1
