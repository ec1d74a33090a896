"""MAE pretraining modules of the port against the JAX package on the CPU,
and the helpers the other ``test_torch_mae_*`` files share.

The size is the tiny config of ``tests/test_mae_wgan.py`` (32², ``ngf=8``,
``num_res=2``, ``hidden_nc=16``, 3 labels, ``embed_nc=12``, 2 embeddings),
batch 2, float32. Weights and state come from the JAX ``MAESteps.init_state``
with biases, BatchNorm parameters and statistics and the mask token moved
off their init values by a seeded numpy draw, carried into the port by
``train/jax_import.py::load_jax_mae_state``. Neither package draws a random
number: the masks are fed (the JAX package's ``generate_shifted_mask`` is
monkeypatched here, in the test), there is no noise injection, and AdaIN's E
takes the image path.

Compared:
  * ``MaskToken``, all six types: exact (the same float32 products and
    sums; the ``mean`` token's channel mean within 1 float32 ulp of 2, the
    two packages summing the pixels in another order);
  * the masks: given the JAX package's Bernoulli grid and shifts, the port's
    upsampling and shifted crop are the JAX masks bit for bit; the port's
    own draws have the patch structure and ratio ``test_mask_generation``
    checks;
  * ``EmbedEncoder``, ``LatentDecoder`` (its noise fed to both) and
    ``repair`` (G in eval and in train mode): forward 5e-4 (DESIGN.md
    section 7).
"""
import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from de_i2i_gan_tpu.config import DefectGanConfig as JaxConfig
from de_i2i_gan_tpu.config import MAEConfig as JaxMAEConfig
from de_i2i_gan_tpu.config import TrainConfig as JaxTrainConfig
from de_i2i_gan_tpu.nn import blocks as jblocks
from de_i2i_gan_tpu.train import mae_steps as jax_mae_steps
from de_i2i_gan_tpu.utils import masks as jmasks
from de_i2i_gan_torch.config import DefectGanConfig, MAEConfig, TrainConfig
from de_i2i_gan_torch.nn import blocks
from de_i2i_gan_torch.train import mae_steps
from de_i2i_gan_torch.train.jax_import import (
    _flatten, _targets, load_jax_mae_state, load_jax_module)
from de_i2i_gan_torch.utils import masks
from tests.test_torch_train_step import perturb

torch.set_num_threads(1)

TOL = 5e-4
IMG, LABELS, EMBED, NUM_EMBEDS, PATCH = 32, 3, 12, 2, 8
CRITICS, BATCH = 2, 2
CFG = dict(image_size=IMG, label_nc=LABELS, ngf=8, ndf=8, num_scales=2,
           num_res=2, hidden_nc=16, embed_nc=EMBED, num_embeds=NUM_EMBEDS,
           num_layers=2, use_pallas=True)
STYLES = {"adain": dict(CFG, style_norm_block_type="adain"),
          "sean": dict(CFG, style_norm_block_type="sean"),
          "spade": dict(CFG, style_norm_block_type="spade")}
MAE = dict(mask_ratio=0.75, patch_size=PATCH, mask_token_type="position")
TOKENS = ("zero", "mean", "scalar", "vector", "position", "full")


def fixed_mask(seed, n=BATCH):
    """An (n, 32, 32, 1) patch mask from a seed, a quarter visible."""
    grid = np.random.default_rng(seed).random((n, IMG // PATCH, IMG // PATCH, 1))
    grid = (grid < 0.25).astype(np.float32)
    return grid.repeat(PATCH, 1).repeat(PATCH, 2)


@contextlib.contextmanager
def masks_fed(mask):
    """Both packages' MAE steps draw ``mask`` (numpy, (N, H, W, 1)) wherever
    they would draw a shifted patch mask."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_mae_steps, "generate_shifted_mask",
                   lambda key, b, h, w, p, r: jnp.asarray(mask[:b]))
        mp.setattr(jmasks, "generate_shifted_mask",
                   lambda key, b, h, w, p, r: jnp.asarray(mask[:b]))
        fed = torch.from_numpy(mask)

        def port_mask(b, h, w, p, r, generator=None, device="cpu"):
            return fed[:b].to(device)

        mp.setattr(mae_steps, "generate_shifted_mask", port_mask)
        from de_i2i_gan_torch.train import solver
        mp.setattr(solver, "generate_shifted_mask", port_mask)
        yield


def jax_steps(style, tcfg_kw, mae_kw=None):
    return jax_mae_steps.MAESteps(JaxConfig(**STYLES[style]),
                                  JaxMAEConfig(**(mae_kw or MAE)),
                                  JaxTrainConfig(**tcfg_kw),
                                  iters_per_epoch=10, num_epochs=2)


def port_steps(style, tcfg_kw, mae_kw=None):
    return mae_steps.MAESteps(DefectGanConfig(**STYLES[style]),
                              MAEConfig(**(mae_kw or MAE)),
                              TrainConfig(**tcfg_kw), device="cpu",
                              iters_per_epoch=10, num_epochs=2)


def jax_state(jsteps, seed):
    """``init_state`` with G's, E's and D's biases, BatchNorm parameters and
    statistics and the mask token moved off their init values."""
    state = jax.device_get(jsteps.init_state(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    token = {k: rng.normal(0, 0.1, np.shape(v)).astype(np.float32)
             for k, v in state.G.params["token"].items()}
    g_state = dict(state.G.state)
    g_state["batch_stats"] = perturb(g_state["batch_stats"], rng)
    rep = dict(G=state.G.replace(
        params={"net": perturb(state.G.params["net"], rng), "token": token},
        state=g_state),
        D=state.D.replace(params=perturb(state.D.params, rng)))
    if state.E is not None:
        rep["E"] = state.E.replace(params=perturb(state.E.params, rng))
    return state.replace(**rep)


def make_batches(seed, style, critics=CRITICS, n=BATCH):
    rng = np.random.default_rng(seed)
    batches = {"imgs": rng.uniform(-1, 1, (critics, n, IMG, IMG, 3)).astype(
        np.float32),
        "labels": np.eye(LABELS, dtype=np.float32)[
            rng.integers(0, LABELS, (critics, n))]}
    if style == "sean":
        batches["embeds"] = rng.normal(0, 1, (critics, n, NUM_EMBEDS, EMBED)
                                       ).astype(np.float32)
    return batches


def port_params(module, tree):
    """port key -> (port tensor, flax array in the port's layout)."""
    flat = _flatten(jax.device_get(tree))
    return {key: (tensor, to_port(flat[path]))
            for key, tensor, coll, path, to_port in _targets(module)
            if coll == "params"}


# ------------------------------------------------------------- MaskToken


@pytest.mark.parametrize("kind", TOKENS)
def test_mask_token_matches_flax(kind):
    rng = np.random.default_rng(TOKENS.index(kind))
    imgs = rng.uniform(-1, 1, (BATCH, IMG, IMG, 3)).astype(np.float32)
    mask = fixed_mask(7)
    jmod = jblocks.MaskToken(kind, 0.75, 3, IMG)
    params = jax.device_get(jmod.init(jax.random.PRNGKey(0), imgs, mask)
                            .get("params", {}))
    params = {k: rng.normal(0, 0.5, np.shape(v)).astype(np.float32)
              for k, v in params.items()}
    port = blocks.MaskToken(kind, 0.75, 3, IMG)
    load_jax_module(port, params)
    assert sorted(dict(port.named_parameters())) == sorted(params)
    ref = np.asarray(jmod.apply({"params": params}, jnp.asarray(imgs),
                                jnp.asarray(mask)))
    with torch.no_grad():
        got = port(torch.from_numpy(imgs), torch.from_numpy(mask)).numpy()
    if kind == "mean":
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=float(np.spacing(np.float32(2))))
    else:
        np.testing.assert_array_equal(got, ref)
    visible = mask[..., 0] > 0
    np.testing.assert_array_equal(got[visible], imgs[visible])


def test_mask_token_rejects_an_unknown_type():
    with pytest.raises(ValueError, match="Unknown mask token type"):
        blocks.MaskToken("patch", 0.75)


# ----------------------------------------------------------------- masks


@pytest.mark.parametrize("size,patch", [(32, 8), (30, 8), (64, 16)])
def test_masks_match_jax_given_its_grid(size, patch):
    """The JAX package's draws (its Bernoulli grid and shifts, from its own
    key splits) handed to the port's upsampling and crop give its masks
    bit for bit; at 30 the start is clamped as dynamic_slice clamps it."""
    key = jax.random.PRNGKey(size + patch)
    grid = np.asarray(jax.random.bernoulli(
        key, 0.25, (3, size // patch, size // patch, 1))).astype(np.float32)
    got = masks.upsample_grid(torch.from_numpy(grid), patch).numpy()
    np.testing.assert_array_equal(got, np.asarray(
        jmasks.generate_mask(key, 3, size, size, patch, 0.75)))

    k_grid, k_h, k_w = jax.random.split(key, 3)
    ext = size + patch
    grid = np.asarray(jax.random.bernoulli(
        k_grid, 0.25, (3, ext // patch, ext // patch, 1))).astype(np.float32)
    shifts = [int(jax.random.randint(k, (), 0, patch)) for k in (k_h, k_w)]
    got = masks.shifted_crop(masks.upsample_grid(torch.from_numpy(grid), patch),
                             *shifts, size, size).numpy()
    np.testing.assert_array_equal(got, np.asarray(
        jmasks.generate_shifted_mask(key, 3, size, size, patch, 0.75)))


def test_mask_generation_structure_and_ratio():
    """The port's own draws, as ``tests/test_mae_wgan.py::
    test_mask_generation`` checks the JAX package's: every 8x8 patch
    constant, about a quarter visible; the shifted mask of the same shape,
    its values 0 or 1, its runs of equal values patch-long inside."""
    gen = torch.Generator().manual_seed(0)
    m = masks.generate_mask(2, 32, 32, 8, 0.75, gen).numpy()
    assert m.shape == (2, 32, 32, 1) and m.dtype == np.float32
    patches = m.reshape(2, 4, 8, 4, 8)
    assert (patches.std(axis=(2, 4)) == 0).all()
    assert 0.05 < float(m.mean()) < 0.6
    big = masks.generate_mask(64, 32, 32, 8, 0.75, gen).numpy()
    assert abs(float(big.mean()) - 0.25) < 0.05
    ms = masks.generate_shifted_mask(2, 32, 32, 8, 0.75, gen).numpy()
    assert ms.shape == (2, 32, 32, 1)
    assert set(np.unique(ms)) <= {0.0, 1.0}
    # a shifted 8-periodic lattice: each row is constant over 8 aligned
    # columns after some offset < 8
    rows = ms[:, :, :, 0]
    assert any((rows[:, :, o:o + 24].reshape(2, 32, 3, 8).std(axis=3) == 0).all()
               for o in range(8))


# ------------------------------------------------- EmbedEncoder, LatentDecoder


def test_embed_encoder_matches_flax():
    rng = np.random.default_rng(3)
    feat = rng.normal(0, 1, (3, NUM_EMBEDS, EMBED)).astype(np.float32)
    jmod = jblocks.EmbedEncoder(16)
    params = perturb(jax.device_get(jmod.init(jax.random.PRNGKey(1), feat)
                                    ["params"]), rng)
    port = blocks.EmbedEncoder(EMBED, 16)
    load_jax_module(port, params)
    for x in (feat, feat[:, 0]):
        ref = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
        with torch.no_grad():
            got = port(torch.from_numpy(x)).numpy()
        assert got.shape == (3, 16)
        np.testing.assert_allclose(got, ref, atol=TOL, rtol=TOL)


def test_latent_decoder_matches_flax_with_its_noise_fed(monkeypatch):
    """The noise the flax module draws from its 'latent' stream is handed
    to the port's ``noise``."""
    rng = np.random.default_rng(4)
    labels = np.eye(LABELS, dtype=np.float32)[[0, 2, 1]]
    noise = rng.normal(0, 1, (3, 16 - LABELS)).astype(np.float32)
    jmod = jblocks.LatentDecoder(LABELS, 16, 16)
    rngs = {"params": jax.random.PRNGKey(0), "latent": jax.random.PRNGKey(1)}
    params = perturb(jax.device_get(jmod.init(rngs, labels)["params"]), rng)
    real_normal = jax.random.normal

    def fed(key, shape, dtype=jnp.float32):
        assert tuple(shape) == noise.shape
        return jnp.asarray(noise, dtype)

    monkeypatch.setattr(jax.random, "normal", fed)
    ref = np.asarray(jmod.apply({"params": params}, jnp.asarray(labels),
                                rngs={"latent": jax.random.PRNGKey(2)}))
    monkeypatch.setattr(jax.random, "normal", real_normal)
    port = blocks.LatentDecoder(LABELS, 16, 16)
    load_jax_module(port, params)
    with torch.no_grad():
        got = port(torch.from_numpy(labels), torch.from_numpy(noise)).numpy()
        drawn = port(torch.from_numpy(labels),
                     generator=torch.Generator().manual_seed(0))
    assert got.shape == drawn.shape == (3, 16)
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=TOL)


# ----------------------------------------------------------------- repair


@pytest.mark.parametrize("style", sorted(STYLES))
@pytest.mark.parametrize("train", [False, True])
def test_repair_matches_jax(style, train):
    """Mask -> token fill -> G, from one converted state; G in train mode
    normalizes with its batch statistics."""
    tcfg = dict(batch_size=BATCH, num_critics=1, lr=(1.5e-4,),
                loss_weight=(10, 3, 1), optimizer="adamw", scheduler="cos")
    jsteps = jax_steps(style, tcfg)
    state = jax_state(jsteps, 0)
    port = port_steps(style, tcfg)
    load_jax_mae_state(port, state)
    batch = {k: v[0] for k, v in make_batches(1, style).items()}
    feat = {"adain": None, "sean": batch.get("embeds"), "spade": None}[style]
    mask = fixed_mask(2)
    with torch.no_grad():
        tfeat = (port.E(torch.from_numpy(batch["imgs"]),
                        torch.from_numpy(batch["labels"]))
                 if style == "adain" else
                 None if feat is None else torch.from_numpy(feat))
        got, got_mask = port.repair(torch.from_numpy(batch["imgs"]),
                                    torch.from_numpy(batch["labels"]), tfeat,
                                    train=train, mask=torch.from_numpy(mask))
    if style == "adain":
        feat = jsteps.E.apply({"params": state.E.params, **state.E.state},
                              jnp.asarray(batch["imgs"]),
                              jnp.asarray(batch["labels"]),
                              rngs={"latent": jax.random.PRNGKey(0)})
    ref, ref_mask, _ = jsteps.repair(
        state.G.params, state.G.state, jnp.asarray(batch["imgs"]),
        jnp.asarray(batch["labels"]), feat, jax.random.PRNGKey(3),
        train=train, mask=jnp.asarray(mask))
    assert not port.G.training  # back in eval mode
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(ref_mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL, rtol=TOL)
