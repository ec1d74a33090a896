"""StarGAN v2's MAE ``pretrain_step`` (AdaIN) in both packages, from one
JAX pretrain state continued, and the pretrain mode's wiring.

The JAX ``init_pretrain_state`` makes the state (G's parameters under
``{"net", "token"}``); G, D, M and S and the EMA nets are perturbed as in
``tests/test_torch_starganv2_train.py``, the mask token drawn, and every
optimizer continued (count 3, moments drawn) as in
``tests/test_torch_starganv2_train_step.py``, whose reasons hold here: from
a fresh Adam state with beta1 = 0 a weight moves by about lr * sign(g). The
port's solver, put in pretrain mode, takes the state through
``load_jax_starganv2``. Both packages repair with one fed mask (the JAX
package's ``generate_shifted_mask`` patched here). The size is the JAX
suite's tiny StarGAN v2 config, batch 2, float32.

Compared after the step (D latent, D reference, G latent, G reference, the
EMA of G), with that file's per-net bands: every metric rtol 2e-4; each
net's update per tensor within ``STEP_REL`` of its L2 norm (D 1e-3, M and
S 1e-2, G and its token 2e-2) + 1e-9 sqrt(numel), + the L2 norm of the
float32 spacing of the weights before (M's update at f_lr 1e-6 is below
it, so rounding after = before + update alone moves it by up to a
spacing); Adam's moments in the same bands, without the spacing; the
counts (G and D two updates, M and S one); ``ema_G`` within 1e-6;
``step``.
"""
import functools

import numpy as np
import pytest
import torch

import jax

from tests.test_torch_mae import masks_fed
from tests.test_torch_starganv2_train import (
    IMG, JaxConfig, close_losses, config, jv, jax_batch, make_batch, perturb,
    port_params, torch_batch)
from tests.test_torch_starganv2_train_step import (
    ADAM_COUNT, EMA_ATOL, STEP_REL, UPDATE_ATOL, close_tensors, continued)
from de_i2i_gan_tpu.train.solver import StarGANv2Solver as JaxSolver
from de_i2i_gan_torch.train.jax_import import load_jax_starganv2
from de_i2i_gan_torch.train.solver import StarGANv2Config, StarGANv2Solver

torch.set_num_threads(1)

MASK_RATIO, PATCH = 0.75, 8
STEP_REL = dict(STEP_REL, token=STEP_REL["G"])


def sgv2_mask(seed, n=2):
    grid = np.random.default_rng(seed).random((n, IMG // PATCH, IMG // PATCH, 1))
    return (grid < 0.25).astype(np.float32).repeat(PATCH, 1).repeat(PATCH, 2)


def pretrain_solver(kw):
    port = StarGANv2Solver(StarGANv2Config(**kw), device="cpu")
    port.init_pretrain(MASK_RATIO, PATCH, "position")
    return port


@functools.lru_cache(maxsize=None)
def pretrain_run(seed=0):
    """(state before, JAX state after, JAX metrics, port solver, port
    metrics) of one pretrain_step from one continued pretrain state."""
    kw = config("adain")
    jsolver = JaxSolver(JaxConfig(**kw))
    state = jax.device_get(jsolver.init_pretrain_state(
        jax.random.PRNGKey(seed), MASK_RATIO, PATCH, "position"))
    rng = np.random.default_rng(seed)
    g_params = {"net": perturb(state.G.params["net"], rng),
                "token": {"mask_token": rng.normal(0, 0.1, (1, IMG, IMG, 1))
                          .astype(np.float32)}}
    state = state.replace(
        G=state.G.replace(params=g_params),
        D=state.D.replace(params=perturb(state.D.params, rng)),
        M=state.M.replace(params=perturb(state.M.params, rng)),
        S=state.S.replace(params=perturb(state.S.params, rng)),
        ema_G={"net": perturb(state.G.params["net"], rng),
               "token": g_params["token"]},
        ema_M=perturb(state.M.params, rng), ema_S=perturb(state.S.params, rng))
    state = continued(state, seed + 1)
    batch = make_batch(seed + 2)
    with masks_fed(sgv2_mask(seed + 3)):
        after, jmetrics = jax.jit(jsolver.pretrain_step)(
            jv(state), jax_batch(batch), jax.random.PRNGKey(seed + 4))
        port = pretrain_solver(kw)
        load_jax_starganv2(port, state)
        metrics = port.pretrain_step(torch_batch(batch))
    return state, jax.device_get(after), jax.device_get(jmetrics), port, metrics


def trees(state, name):
    """(flax params, Adam state's (mu, nu) trees) of a net; G's and the
    token's from the ``{"net", "token"}`` tree."""
    key = {"token": "G"}.get(name, name)
    net = getattr(state, key)
    adam = net.opt_state[1]
    if name in ("G", "token"):
        sub = "net" if name == "G" else "token"
        return net.params[sub], adam.mu[sub], adam.nu[sub], int(adam.count)
    return net.params, adam.mu, adam.nu, int(adam.count)


def test_pretrain_step_metrics_match_jax():
    _, _, jmetrics, _, metrics = pretrain_run()
    close_losses(metrics, jmetrics)
    assert sorted(metrics) == sorted(
        [f"D/{p}_{k}" for p in ("latent", "ref") for k in ("real", "fake", "reg")]
        + [f"G/{p}_{k}" for p in ("latent", "ref")
           for k in ("adv", "sty", "rec", "ds")])


@pytest.mark.parametrize("name", ["G", "token", "D", "M", "S"])
def test_pretrain_step_updates_match_jax(name):
    state, after, _, port, _ = pretrain_run()
    module = port.token if name == "token" else getattr(port, name)
    tx = port.tx_G if name == "token" else getattr(port, f"tx_{name}")
    rel = STEP_REL[name]
    before = port_params(module, trees(state, name)[0])
    params, mu, nu, count = trees(after, name)
    for key, (tensor, ref) in port_params(module, params).items():
        start = before[key][1]
        got = tensor.detach().numpy() - start
        # M's update at f_lr 1e-6 lies below the float32 spacing of its
        # weights: each package's rounding of after = before + update adds
        # up to one spacing
        spacing = np.linalg.norm(np.spacing(np.abs(start)))
        diff = np.linalg.norm(got - (ref - start))
        band = rel * np.linalg.norm(ref - start) + UPDATE_ATOL * start.size ** 0.5
        assert diff <= band + spacing, (
            f"{name} {key} update: |d| {diff:.3e} > {band:.3e} + spacing "
            f"{spacing:.3e}")
    for moment, tree in (("exp_avg", mu), ("exp_avg_sq", nu)):
        for key, (tensor, ref) in port_params(module, tree).items():
            close_tensors(tx.opt.state[tensor][moment].numpy(), ref, rel,
                          UPDATE_ATOL, f"{name} {key} {moment}")
    want = ADAM_COUNT + (2 if name in ("G", "token", "D") else 1)
    assert count == tx.count == want


def test_pretrain_step_ema_and_step_match_jax():
    state, after, _, port, _ = pretrain_run()
    for key, (tensor, ref) in port_params(port.ema_G, after.ema_G["net"]).items():
        np.testing.assert_allclose(tensor.numpy(), ref, rtol=0, atol=EMA_ATOL,
                                   err_msg=f"ema_G {key}")
    # M and S keep their EMA nets as they were: pretraining averages G only
    for name in ("M", "S"):
        for key, (tensor, ref) in port_params(
                getattr(port, f"ema_{name}"), getattr(after, f"ema_{name}")).items():
            np.testing.assert_array_equal(tensor.numpy(), ref, err_msg=key)
    assert port.step == int(after.step) == int(state.step) + 1
    assert all(p.grad is None for n in ("G", "D", "M", "S", "token")
               for p in getattr(port, n).parameters())


def test_pretrain_mode_wiring():
    """The token joins G's optimizer and the checkpoint; it must come
    before the training state; SEAN's too."""
    port = pretrain_solver(config("adain"))
    port.init_training()
    token = port.token.mask_token
    assert any(p is token for p in port.tx_G.params)
    assert "token" in port.STATE_NETS
    assert "token" not in StarGANv2Solver.STATE_NETS
    with pytest.raises(RuntimeError, match="before init_training"):
        port.init_pretrain()
    plain = StarGANv2Solver(StarGANv2Config(**config("adain")), device="cpu")
    with pytest.raises(RuntimeError, match="init_pretrain first"):
        plain.pretrain_step(torch_batch(make_batch(0)))
    sean = StarGANv2Solver(StarGANv2Config(**config("sean")), device="cpu")
    sean.init_pretrain()  # SEAN pretrains too (its style term: the ViT)
    sean.init_training()
    assert any(p is sean.token.mask_token for p in sean.tx_G.params)
    assert sean.M is None and sean.tx_M is None


def test_sean_pretrain_through_the_cli(tmp_path, monkeypatch, capsys):
    """StarGAN v2 ``--mode pretrain --norm_type sean`` with ``--vit_path``
    (a tiny HF-keyed ViT the test writes): the reference passes alone, the
    style term live, no diversity term; the pretrain checkpoint."""
    from de_i2i_gan_torch.cli import starganv2_main as sgv2_cli
    from de_i2i_gan_torch.train.checkpoint import read_checkpoint
    from tests.test_torch_starganv2_train_cli import (
        _argv, _iteration_losses, _tiny_vit_bin)
    from tests.test_torch_starganv2_train_fused import _image_tree

    monkeypatch.setattr(sgv2_cli, "VIT_MODEL_SIZE", "tiny")
    _image_tree(tmp_path / "tree", 3, per_domain=2)
    solver = sgv2_cli.main(_argv(
        tmp_path, "--mode", "pretrain", "--norm_type", "sean", "--embed_nc",
        "16", "--num_embeds", "2", "--hidden_nc", "16", "--vit_path",
        str(_tiny_vit_bin(tmp_path / "vit.bin")), "--total_iters", "1",
        "--patch_size", "16", "--save_every", "100"))
    assert solver.step == 1 and solver.vit is not None
    out = capsys.readouterr().out.replace("Pretrain [", "Iteration [")
    losses = _iteration_losses(out)
    assert losses["G/ref_sty"] > 0 and losses["G/ref_ds"] == 0
    assert not any(k.startswith(("D/latent", "G/latent")) for k in losses)
    state = read_checkpoint(tmp_path / "ckpt", "starganv2_pretrain", "latest")
    assert state["step"] == 1 and "token" in state
