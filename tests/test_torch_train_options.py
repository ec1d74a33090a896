"""The port's DefectGAN training options against the JAX package: spectral
norm (eval, one train-mode update, the gradient), noise injection,
DiffAugment (every policy given the JAX package's own draws, and its
gradient), the modes each step runs G and D in, and the SEAN statistics'
epoch update.

Inputs and weights come from seeded numpy draws; float32 throughout.
Tolerances: 1e-4 for single layers and their gradients, 5e-4 for blocks
(DESIGN.md §7), 1e-6 for the spectral vectors and DiffAugment (the same
float32 operations, at most in another order).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from de_i2i_gan_tpu.nn import blocks as jblocks
from de_i2i_gan_tpu.nn import layers as jlayers
from de_i2i_gan_tpu.nn import normalization as jnorm
from de_i2i_gan_tpu.utils import diffaug as jdiffaug
from de_i2i_gan_torch.config import DefectGanConfig, TrainConfig
from de_i2i_gan_torch.nn import blocks, layers
from de_i2i_gan_torch.train.jax_import import _flatten, _targets, init_weights, load_jax_module
from de_i2i_gan_torch.train.steps import DefectGanSteps
from de_i2i_gan_torch.utils import diffaug

torch.set_num_threads(1)

LAYER_TOL = 1e-4
BLOCK_TOL = 5e-4
EXACT_TOL = 1e-6
KEY = jax.random.PRNGKey(0)
POLICIES = ["color", "translation", "cutout", "color,translation,cutout"]


def nhwc(seed, shape, scale=1.0, shift=0.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, shape) * scale + shift).astype(np.float32)


def to_port(x):
    """NHWC numpy -> NCHW torch."""
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def close(port, ref, tol):
    got = port.detach().float().numpy()
    if got.ndim == 4:
        got = got.transpose(0, 2, 3, 1)
    np.testing.assert_allclose(got, np.asarray(ref, np.float32), atol=tol,
                               rtol=tol)


def jax_draws(key, shape, policy):
    """The draws ``de_i2i_gan_tpu/utils/diffaug.py::diff_augment`` makes from
    ``key``, in the layout of the port's ``draw_diff_augment``."""
    n, h, w, _ = shape
    draws = []
    for p in policy.split(","):
        for op in diffaug._POLICIES[p]:
            key, sub = jax.random.split(key)
            if op in ("brightness", "saturation", "contrast"):
                draws.append(jax.random.uniform(sub, (n, 1, 1, 1), jnp.float32))
                continue
            kx, ky = jax.random.split(sub)
            if op == "translation":
                sh, sw = int(h * 0.125 + 0.5), int(w * 0.125 + 0.5)
                draws.append((jax.random.randint(kx, (n, 1, 1), -sh, sh + 1),
                              jax.random.randint(ky, (n, 1, 1), -sw, sw + 1)))
            else:
                ch, cw = int(h * 0.5 + 0.5), int(w * 0.5 + 0.5)
                draws.append((
                    jax.random.randint(kx, (n, 1, 1), 0, h + (1 - ch % 2)),
                    jax.random.randint(ky, (n, 1, 1), 0, w + (1 - cw % 2))))
    return [tuple(torch.tensor(np.asarray(t)).long() for t in d)
            if isinstance(d, tuple) else torch.tensor(np.asarray(d))
            for d in draws]


# ---------------------------------------------------------- spectral norm

SN_CASES = {
    "conv": ((2, 8, 8, 4),
             lambda: jlayers.Conv2d(6, (3, 3), padding=1, use_spectral=True),
             lambda: layers.Conv2d(4, 6, (3, 3), padding=1, use_spectral=True)),
    "conv_4x4_stride2": ((2, 8, 8, 3),
                         lambda: jlayers.Conv2d(5, (4, 4), (2, 2), 1, "reflect",
                                                use_spectral=True),
                         lambda: layers.Conv2d(3, 5, (4, 4), (2, 2), 1,
                                               "reflect", use_spectral=True)),
    "dense": ((3, 12),
              lambda: jlayers.Dense(7, use_spectral=True),
              lambda: layers.Dense(12, 7, use_spectral=True)),
}


def _sn_pair(case, seed=0):
    shape, jmake, pmake = SN_CASES[case]
    x = nhwc(seed, shape)
    jmod, port = jmake(), pmake()
    variables = jax.device_get(jmod.init(KEY, jnp.asarray(x)))
    rng = np.random.default_rng(seed + 1)
    params = {k: v + rng.normal(0, 0.05, v.shape).astype(np.float32)
              for k, v in variables["params"].items()}
    load_jax_module(port, params, {"spectral": variables["spectral"]})
    xt = to_port(x) if x.ndim == 4 else torch.from_numpy(x)
    return jmod, port, {"params": params, "spectral": variables["spectral"]}, x, xt


def _close_spectral(port, spectral):
    flat = _flatten(jax.device_get(spectral))
    for key, tensor, coll, path, fn in _targets(port):
        if coll == "spectral":
            np.testing.assert_allclose(tensor.numpy(), fn(flat[path]),
                                       atol=EXACT_TOL, rtol=0, err_msg=key)


@pytest.mark.parametrize("case", sorted(SN_CASES))
def test_spectral_norm_eval_uses_stored_vectors(case):
    """Eval mode: the stored u and v, unchanged."""
    jmod, port, variables, x, xt = _sn_pair(case)
    ref = jmod.apply(variables, jnp.asarray(x))
    port.eval()
    with torch.no_grad():
        close(port(xt), ref, LAYER_TOL)
    _close_spectral(port, variables["spectral"])


@pytest.mark.parametrize("case", sorted(SN_CASES))
def test_spectral_norm_train_update_matches_flax(case):
    """Train mode: one power iteration, twice in a row (new u, v each
    forward), and the output with the updated vectors."""
    jmod, port, variables, x, xt = _sn_pair(case, seed=2)
    port.train()
    for _ in range(2):
        ref, mut = jmod.apply(variables, jnp.asarray(x), update_sn=True,
                              mutable=["spectral"])
        variables = {**variables, "spectral": jax.device_get(mut["spectral"])}
        with torch.no_grad():
            close(port(xt), ref, LAYER_TOL)
        _close_spectral(port, variables["spectral"])


@pytest.mark.parametrize("case", sorted(SN_CASES))
def test_spectral_norm_gradient_matches_jax_grad(case):
    """d/dW of <y, dy> through W / sigma, sigma = u (W v) with u, v held
    constant: against jax.grad, after a train-mode update."""
    jmod, port, variables, x, xt = _sn_pair(case, seed=3)
    dy = nhwc(4, np.asarray(jmod.apply(variables, jnp.asarray(x))).shape)

    def loss(params):
        y, _ = jmod.apply({**variables, "params": params}, jnp.asarray(x),
                          update_sn=True, mutable=["spectral"])
        return jnp.sum(y * dy)

    ref = jax.grad(loss)(variables["params"])["kernel"]
    port.train()
    y = port(xt)
    y.backward(to_port(dy) if dy.ndim == 4 else torch.from_numpy(dy))
    to_port_fn = next(t[4] for t in _targets(port) if t[0] == "weight")
    np.testing.assert_allclose(port.weight.grad.numpy(), to_port_fn(np.asarray(ref)),
                               atol=LAYER_TOL, rtol=LAYER_TOL)


def test_spectral_norm_estimates_top_singular_value():
    """Repeated train-mode forwards converge sigma to the largest singular
    value of the (out, in*kh*kw) weight. The weight has singular values 2
    down to 0.5, so each iteration shrinks the error by (1.79 / 2)^2."""
    gen = torch.Generator().manual_seed(18)
    port = layers.Conv2d(4, 8, (3, 3), padding="same", use_spectral=True)
    left, _ = torch.linalg.qr(torch.randn(8, 8, generator=gen))
    right, _ = torch.linalg.qr(torch.randn(36, 8, generator=gen))
    with torch.no_grad():
        port.weight.copy_(((left * torch.linspace(2.0, 0.5, 8)) @ right.T)
                          .reshape(8, 4, 3, 3))
        for vec in (port.weight_u, port.weight_v):
            draw = torch.randn(vec.shape, generator=gen)
            vec.copy_(draw / draw.norm())
    x = torch.randn((2, 4, 8, 8), generator=gen)
    for _ in range(50):
        port(x)
    mat = port.weight.detach().reshape(8, -1)
    est = port.weight_u @ mat @ port.weight_v
    assert abs(est.item() / 2.0 - 1) < 1e-3


# ------------------------------------------------------------ noise

def _torch_noise(monkeypatch, seed):
    """Make the JAX package draw its noise from a torch generator: the
    (N, H, W, 1) draw it asks for lies in memory as the port's (N, 1, H, W)
    draw does, so both packages see the same noise in the same order."""
    gen = torch.Generator().manual_seed(seed)
    monkeypatch.setattr(
        jax.random, "normal",
        lambda key, shape, dtype=jnp.float32: jnp.asarray(
            torch.randn(shape, generator=gen).numpy(), dtype))


def test_noise_injection_is_exact_at_weight_zero():
    x = to_port(nhwc(5, (2, 6, 6, 4)))
    assert torch.equal(blocks.NoiseInjection()(x), x)


def test_noise_injection_matches_flax_given_its_noise(monkeypatch):
    x = nhwc(6, (2, 6, 5, 4))
    jmod = jblocks.NoiseInjection()
    params = {"weight": np.asarray([0.7], np.float32)}
    port = blocks.NoiseInjection()
    load_jax_module(port, params)
    _torch_noise(monkeypatch, 7)
    ref = jmod.apply({"params": params}, jnp.asarray(x), rngs={"noise": KEY})
    got = port(to_port(x), torch.Generator().manual_seed(7))
    close(got, ref, EXACT_TOL)
    assert not np.allclose(np.asarray(ref), x)


@pytest.mark.parametrize("kind", ["deconv", "norm_conv", "norm_res"])
def test_blocks_with_noise_match_flax(kind, monkeypatch):
    """The noise where the JAX blocks inject it, at non-zero weights."""
    x = nhwc(8, (2, 6, 6, 8))
    labels = np.eye(3, dtype=np.float32)[[0, 2]]
    style = nhwc(9, (2, 12))
    kw = dict(padding="same", padding_mode="reflect", add_noise=True)
    if kind == "deconv":
        jmod = jblocks.DeConvBlock(4, (3, 3), norm="instance", act="relu", **kw)
        port = blocks.DeConvBlock(8, 4, (3, 3), norm="instance", act="relu", **kw)
        jargs, pargs = (jnp.asarray(x),), (to_port(x),)
    else:
        style_kw = dict(label_nc=3, hidden_nc=12, up_scale=True, **kw)
        jcls, pcls = ((jblocks.NormConvBlock, blocks.NormConvBlock)
                      if kind == "norm_conv" else
                      (jblocks.NormResBlock, blocks.NormResBlock))
        jmod = jcls("adain", 4, **style_kw)
        port = pcls("adain", 8, 4, **style_kw)
        jargs = (jnp.asarray(x), jnp.asarray(labels), jnp.asarray(style))
        pargs = (to_port(x), torch.from_numpy(labels), torch.from_numpy(style))
    variables = jax.device_get(jmod.init({"params": KEY, "noise": KEY}, *jargs))
    rng = np.random.default_rng(10)
    params = jax.tree_util.tree_map(
        lambda v: np.asarray(v + rng.normal(0, 0.3, v.shape), np.float32),
        variables["params"])
    load_jax_module(port, params)
    _torch_noise(monkeypatch, 11)
    ref = jmod.apply({"params": params}, *jargs, rngs={"noise": KEY})
    with torch.no_grad():
        got = port(*pargs, generator=torch.Generator().manual_seed(11))
    close(got, ref, BLOCK_TOL)


# ------------------------------------------------------------ DiffAugment

@pytest.mark.parametrize("policy", POLICIES)
def test_diff_augment_matches_jax_given_its_draws(policy):
    """Output and gradient of each policy, on an image size whose cutout is
    odd in one axis and even in the other."""
    x = nhwc(12, (4, 10, 7, 3))
    dy = nhwc(13, (4, 10, 7, 3))
    key = jax.random.PRNGKey(14)
    ref, vjp = jax.vjp(lambda a: jdiffaug.diff_augment(key, a, policy),
                       jnp.asarray(x))
    (dx_ref,) = vjp(jnp.asarray(dy))
    xt = torch.from_numpy(x).requires_grad_()
    got = diffaug.apply_diff_augment(xt, policy, jax_draws(key, x.shape, policy))
    got.backward(torch.from_numpy(dy))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               atol=EXACT_TOL, rtol=EXACT_TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx_ref),
                               atol=EXACT_TOL, rtol=EXACT_TOL)
    assert not np.allclose(np.asarray(ref), x)


@pytest.mark.parametrize("policy", POLICIES)
def test_diff_augment_draws_stay_in_their_ranges(policy):
    """The port's own draws: the ranges of the JAX package's (translation
    within +-sh inclusive, cutout centres below h + (1 - ch % 2)), from the
    generator it is given."""
    shape = (64, 10, 7, 3)
    draws = diffaug.draw_diff_augment(shape, policy,
                                      torch.Generator().manual_seed(15))
    again = diffaug.draw_diff_augment(shape, policy,
                                      torch.Generator().manual_seed(15))
    for op, d, e in zip(diffaug._ops(policy), draws, again):
        if op == "translation":
            assert d[0].min() == -1 and d[0].max() == 1  # sh = int(1.75)
            assert d[1].min() == -1 and d[1].max() == 1  # sw = int(1.375)
        elif op == "cutout":
            # ch = 5 (odd): centres 0..9; cw = 4 (even): centres 0..7
            assert d[0].min() == 0 and d[0].max() == 9
            assert d[1].min() == 0 and d[1].max() == 7
        else:
            assert d.shape == (64, 1, 1, 1) and 0 <= d.min() and d.max() < 1
        for a, b in zip(*(t if isinstance(t, tuple) else (t,) for t in (d, e))):
            assert torch.equal(a, b)
    assert diffaug.diff_augment(torch.ones(shape), "") is not None
    with pytest.raises(ValueError, match="draws"):
        diffaug.apply_diff_augment(torch.ones(shape), policy, draws[:-1])


# --------------------------------------------------- modes of the steps

SPECTRAL_TINY = dict(image_size=32, label_nc=4, ngf=8, ndf=8, num_res=2,
                     hidden_nc=16, num_layers=2, style_norm_block_type="adain",
                     use_spectral=True)


def _spectral_state(net):
    return {k: v.clone() for k, v in net.state_dict().items()
            if k.endswith(("weight_u", "weight_v"))}


def test_g_step_leaves_d_spectral_vectors_and_d_step_leaves_g():
    """Spectral u/v move only in the step that updates their network: the
    G step runs D in eval mode (JAX ``train=False``), the D step G."""
    steps = DefectGanSteps(DefectGanConfig(**SPECTRAL_TINY),
                           TrainConfig(batch_size=2, num_critics=1),
                           device="cpu")
    steps.init_training()
    init_weights(steps, 0)
    gen = torch.Generator().manual_seed(16)
    batch = {"bg": torch.rand((2, 32, 32, 3), generator=gen) * 2 - 1,
             "df": torch.rand((2, 32, 32, 3), generator=gen) * 2 - 1,
             "df_labels": torch.eye(4)[:2]}
    d0, g0 = _spectral_state(steps.D), _spectral_state(steps.G)
    assert d0 and g0
    steps.g_step(batch)
    d1, g1 = _spectral_state(steps.D), _spectral_state(steps.G)
    assert all(torch.equal(d0[k], d1[k]) for k in d0)
    assert all(not torch.equal(g0[k], g1[k]) for k in g0)
    steps.d_step(batch)
    d2, g2 = _spectral_state(steps.D), _spectral_state(steps.G)
    assert all(torch.equal(g1[k], g2[k]) for k in g1)
    assert all(not torch.equal(d1[k], d2[k]) for k in d1)
    assert not steps.G.training and not steps.D.training


def test_update_per_epoch_matches_jax_sean_update_stats():
    """SEAN with use_running_stats: a G step tracks the style codes of its
    two 2B forwards; ``update_per_epoch`` finalizes them as the JAX
    trainer does, and the EMA generator reads the new statistics."""
    cfg = DefectGanConfig(**dict(SPECTRAL_TINY, style_norm_block_type="sean",
                                 embed_nc=24, num_embeds=3,
                                 use_running_stats=True))
    steps = DefectGanSteps(cfg, TrainConfig(batch_size=2, num_critics=1,
                                            ema_decay=0.9), device="cpu")
    steps.init_training()
    init_weights(steps, 1)
    gen = torch.Generator().manual_seed(17)
    batch = {"bg": torch.rand((2, 32, 32, 3), generator=gen) * 2 - 1,
             "df": torch.rand((2, 32, 32, 3), generator=gen) * 2 - 1,
             "df_labels": torch.eye(4)[[1, 3]],
             "nm_embeds": torch.randn((2, 3, 24), generator=gen),
             "df_embeds": torch.randn((2, 3, 24), generator=gen)}
    steps.g_step(batch)
    sean = steps.G.dec_res_0.norm_0.sean
    assert sean.count.sum().item() == 8  # 2 hops x 2B rows
    tree = {k: getattr(sean, k).numpy().copy()
            for k in ("mean", "std", "sum", "sumsq", "count")}
    ref = jax.device_get(jnorm.sean_update_stats({"sean": tree}))["sean"]
    steps.update_per_epoch()
    for k, v in ref.items():
        np.testing.assert_allclose(getattr(sean, k).numpy(), v, atol=1e-5,
                                   rtol=1e-5, err_msg=k)
    assert sean.count.sum().item() == 0 and sean.std.abs().sum().item() > 0
    ema = steps.ema_G.dec_res_0.norm_0.sean
    assert torch.equal(ema.mean, sean.mean) and torch.equal(ema.std, sean.std)
