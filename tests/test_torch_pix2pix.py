"""pix2pix modules of the port against the JAX package on the CPU, and the
helpers the other ``test_torch_pix2pix_*`` files share.

The size is the tiny config of ``tests/test_pix2pix.py`` (32², ``ngf=ndf=8``,
``num_res=2``, ``hidden_nc=16``, 2 labels), batch 2, float32. The state
comes from the JAX ``Pix2PixSteps.init_state`` with biases and BatchNorm's
parameters and statistics moved off their init values by a seeded numpy
draw (``tests/test_torch_train_step.py::perturb``) and the EMA generator
moved apart from G, carried into the port by
``train/jax_import.py::load_jax_pix2pix_state``. No noise injection: the
two packages draw noise from different generators.

Compared:
  * ``PatchDiscriminatorFeatures`` and ``MultiScaleDiscriminator``: the
    logits and every feature of every scale, 5e-4 (DESIGN.md section 7),
    at the CLI's depth (3 layers) down to the tiny-scale guards (a scale
    of 4 px stops deepening and takes the 1x1 head);
  * ``gan_loss`` (lsgan and hinge, for D and for G) and
    ``feature_matching``: rtol 1e-6 (float32 means);
  * ``generate`` with and without the EMA generator: 5e-4;
  * ``load_jax_pix2pix_state``: strict on both sides.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from de_i2i_gan_tpu.config import DefectGanConfig as JaxConfig
from de_i2i_gan_tpu.config import TrainConfig as JaxTrainConfig
from de_i2i_gan_tpu.train import pix2pix_steps as jp2p
from de_i2i_gan_torch.config import DefectGanConfig, TrainConfig
from de_i2i_gan_torch.train import pix2pix_steps as p2p
from de_i2i_gan_torch.train.jax_import import (
    _flatten, _targets, load_jax_module, load_jax_pix2pix_state)
from tests.test_torch_train_step import perturb

torch.set_num_threads(1)

TOL = 5e-4
BATCH = 2
CFG = dict(image_size=32, label_nc=2, ngf=8, ndf=8, num_scales=2, num_res=2,
           hidden_nc=16, num_layers=2, cycle_gan=True,
           style_norm_block_type="spade")
SGD = dict(batch_size=BATCH, num_critics=1, lr=(2e-2, 1e-2), optimizer="sgd",
           ema_decay=0.999)
ADAM = dict(batch_size=BATCH, num_critics=1, lr=(2e-4,), optimizer="adam",
            ema_decay=0.999)
STEPS_KW = dict(num_d_scales=2, n_layers_d=3, iters_per_epoch=10,
                num_epochs=2)


def jax_steps(tcfg, cfg_kw=None, **kw):
    return jp2p.Pix2PixSteps(JaxConfig(**{**CFG, **(cfg_kw or {})}),
                             JaxTrainConfig(**tcfg), **STEPS_KW, **kw)


def port_steps(tcfg, cfg_kw=None, state=None, **kw):
    steps = p2p.Pix2PixSteps(DefectGanConfig(**{**CFG, **(cfg_kw or {})}),
                             TrainConfig(**tcfg), **STEPS_KW, device="cpu",
                             **kw)
    if state is not None:
        load_jax_pix2pix_state(steps, jax.device_get(state))
    return steps


def jax_state(jsteps, seed=0):
    """The JAX init state: biases, BN parameters and statistics moved; the
    EMA generator moved apart from G (its own draw)."""
    state = jsteps.init_state(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed + 11)
    g_params = perturb(jax.device_get(state.G.params), rng)
    g_state = dict(jax.device_get(state.G.state))
    g_state["batch_stats"] = perturb(g_state["batch_stats"], rng)
    ema = jax.tree_util.tree_map(
        lambda a: (a + rng.normal(0, 1e-3, np.shape(a))).astype(np.float32),
        g_params)
    return state.replace(
        G=state.G.replace(params=g_params, state=g_state),
        D=state.D.replace(params=perturb(jax.device_get(state.D.params), rng)),
        ema_G=ema)


def pairs(seed, lead=(), n=BATCH):
    rng = np.random.default_rng(seed)
    shape = (*lead, n, 32, 32, 3)
    return {"input": rng.uniform(-1, 1, shape).astype(np.float32),
            "target": rng.uniform(-1, 1, shape).astype(np.float32)}


def port_tree(module, tree, coll="params"):
    """port key -> (port tensor, flax array in the port's layout)."""
    flat = _flatten(jax.device_get(tree))
    return {key: (tensor, to_port(flat[path]))
            for key, tensor, c, path, to_port in _targets(module) if c == coll}


def nhwc(t):
    return t.detach().numpy()


# ---------------------------------------------------------- discriminators


@pytest.mark.parametrize("image,layers", [(32, 3), (16, 3), (32, 2)])
def test_multiscale_discriminator_matches_flax(image, layers):
    """Logits and features of both scales. At 32² the second scale (16 px)
    runs 3 layers down to 2 px and takes the 1x1 head; at 16² the second
    scale (8 px) stops deepening at 1 px."""
    rng = np.random.default_rng(image + layers)
    x = rng.uniform(-1, 1, (BATCH, image, image, 6)).astype(np.float32)
    jd = jp2p.MultiScaleDiscriminator(2, 8, layers)
    params = perturb(jax.device_get(jd.init(jax.random.PRNGKey(3),
                                            jnp.asarray(x))["params"]), rng)
    want = jd.apply({"params": params}, jnp.asarray(x), train=True)
    port = p2p.MultiScaleDiscriminator(2, 8, layers, image)
    load_jax_module(port, params)
    got = port(torch.from_numpy(x))
    assert len(got) == len(want) == 2
    for (lg, feats), (jlg, jfeats) in zip(got, want):
        assert lg.shape == jlg.shape and len(feats) == len(jfeats)
        np.testing.assert_allclose(nhwc(lg), np.asarray(jlg), atol=TOL)
        for f, jf in zip(feats, jfeats):
            assert f.shape == jf.shape
            np.testing.assert_allclose(nhwc(f), np.asarray(jf), atol=TOL)


def test_patch_discriminator_matches_flax():
    rng = np.random.default_rng(5)
    x = rng.uniform(-1, 1, (BATCH, 32, 32, 6)).astype(np.float32)
    jd = jp2p.PatchDiscriminatorFeatures(8, 3)
    params = perturb(jax.device_get(jd.init(jax.random.PRNGKey(4),
                                            jnp.asarray(x))["params"]), rng)
    jlg, jfeats = jd.apply({"params": params}, jnp.asarray(x))
    port = p2p.PatchDiscriminatorFeatures(6, 8, 3, 32)
    load_jax_module(port, params)
    lg, feats = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(nhwc(lg.permute(0, 2, 3, 1)), np.asarray(jlg),
                               atol=TOL)
    for f, jf in zip(feats, jfeats, strict=True):
        np.testing.assert_allclose(nhwc(f.permute(0, 2, 3, 1)), np.asarray(jf),
                                   atol=TOL)


# ------------------------------------------------------------------ losses


@pytest.mark.parametrize("kind", ["lsgan", "hinge"])
def test_gan_loss_matches_jax(kind):
    logits = np.random.default_rng(6).normal(size=(2, 5, 5, 1)).astype(np.float32)
    for target_real in (True, False):
        for for_disc in (True, False):
            got = p2p.gan_loss(torch.from_numpy(logits), target_real, kind,
                               for_disc)
            want = jp2p.gan_loss(jnp.asarray(logits), target_real, kind,
                                 for_disc)
            np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    with pytest.raises(ValueError):
        p2p.gan_loss(torch.from_numpy(logits), True, "wgan", True)


def test_feature_matching_matches_jax():
    rng = np.random.default_rng(7)
    shapes = [[(2, 8, 8, 4), (2, 4, 4, 8)], [(2, 4, 4, 4)]]
    real = [[rng.normal(size=s).astype(np.float32) for s in ss] for ss in shapes]
    fake = [[rng.normal(size=s).astype(np.float32) for s in ss] for ss in shapes]
    want = jp2p.feature_matching(
        [[jnp.asarray(a) for a in r] for r in real],
        [[jnp.asarray(a) for a in f] for f in fake])
    fake_t = [[torch.from_numpy(a).requires_grad_() for a in f] for f in fake]
    real_t = [[torch.from_numpy(a).requires_grad_() for a in r] for r in real]
    got = p2p.feature_matching(real_t, fake_t)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    # the real features are constants: only the fakes get a gradient
    got.backward()
    assert all(a.grad is None for r in real_t for a in r)
    assert all(a.grad is not None for f in fake_t for a in f)


# -------------------------------------------------------------- generate


@pytest.mark.parametrize("use_ema", [True, False])
def test_generate_matches_jax(use_ema):
    jsteps = jax_steps(SGD)
    state = jax_state(jsteps)
    x = pairs(8)["input"]
    want = jsteps.jit_generate(state, jnp.asarray(x), use_ema=use_ema)
    port = port_steps(SGD, state=state)
    got = port.generate(torch.from_numpy(x), use_ema=use_ema)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=TOL)
    # u8 images normalize on the way in, as the JAX package's
    u8 = ((x + 1) * 127.5).astype(np.uint8)
    want = jsteps.jit_generate(state, jnp.asarray(u8), use_ema=use_ema)
    got = port.generate(torch.from_numpy(u8), use_ema=use_ema)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=TOL)


def test_load_jax_pix2pix_state_is_strict():
    jsteps = jax_steps(ADAM)
    state = jax.device_get(jax_state(jsteps))
    d_params = dict(state.D.params)
    d_params["scale_1"] = dict(d_params["scale_1"])
    d_params["scale_1"].pop("head")
    with pytest.raises(KeyError):
        port_steps(ADAM, state=state.replace(D=state.D.replace(params=d_params)))
    extra = {**state.G.params, "extra": {"kernel": np.zeros((1, 1))}}
    with pytest.raises(KeyError):
        port_steps(ADAM, state=state.replace(G=state.G.replace(params=extra)))
    with pytest.raises(ValueError):
        port_steps(ADAM, state=state.replace(ema_G=None))
    port = port_steps(ADAM, state=state)
    for name, tree in (("G", state.G.params), ("D", state.D.params),
                       ("ema_G", state.ema_G)):
        for key, (tensor, ref) in port_tree(getattr(port, name), tree).items():
            np.testing.assert_array_equal(tensor.detach().numpy(), ref,
                                          err_msg=f"{name} {key}")
    assert port.tx_G.count == port.tx_D.count == 0 and port.step == 0
