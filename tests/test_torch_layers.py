"""The PyTorch port's layers, norms and blocks against their flax
counterparts, with weights carried through ``train/jax_import.py``.

Inputs and weights come from seeded numpy draws; the port works in NCHW and
the transposes are done here. Tolerance 1e-4 for single layers (float32
sums of at most 7x7xC products in another order) and 5e-4 for blocks
(DESIGN.md §7).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from de_i2i_gan_tpu.nn import blocks as jblocks
from de_i2i_gan_tpu.nn import layers as jlayers
from de_i2i_gan_tpu.nn import normalization as jnorm
from de_i2i_gan_torch.nn import blocks, layers, normalization
from de_i2i_gan_torch.train.jax_import import load_jax_module

torch.set_num_threads(1)

LAYER_TOL = 1e-4
BLOCK_TOL = 5e-4
KEY = jax.random.PRNGKey(0)


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


def perturb(tree, seed):
    """Every leaf moved by a seeded draw (kernels, biases, BN scale/stats)."""
    rng = np.random.default_rng(seed)

    def walk(t):
        out = {}
        for k, v in t.items():
            if isinstance(v, dict):
                out[k] = walk(v)
                continue
            v = np.asarray(v, np.float32)
            if k == "var":
                out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            else:
                out[k] = v + rng.normal(0, 0.1, v.shape).astype(np.float32)
        return out
    return walk(jax.device_get(tree))


def carry(jmod, port, *args, seed=0, **kw):
    """init the flax module, perturb, load into ``port``; returns the flax
    output for ``args``. Collections other than params and batch_stats
    (spectral u/v, SEAN statistics) are carried at their init values."""
    variables = jmod.init({"params": KEY, "noise": KEY}, *args, **kw)
    params = perturb(variables["params"], seed)
    stats = perturb(variables.get("batch_stats", {}), seed + 1)
    rest = {k: jax.device_get(v) for k, v in variables.items()
            if k not in ("params", "batch_stats")}
    load_jax_module(port, params, {"batch_stats": stats, **rest})
    port.eval()
    full = {"params": params, **rest}
    if stats:
        full["batch_stats"] = stats
    return jmod.apply(full, *args, **kw)


CONV_CASES = {
    # name: (input NHWC shape, port/flax kwargs)
    "same_7x7_reflect": ((2, 12, 12, 3),
                         dict(features=8, kernel_size=(7, 7), padding="same",
                              padding_mode="reflect")),
    "stride2_4x4_pad1_reflect": ((2, 12, 12, 6),
                                 dict(features=8, kernel_size=(4, 4),
                                      strides=(2, 2), padding=1,
                                      padding_mode="reflect")),
    "1x1_zeros_bias": ((2, 5, 7, 6),
                       dict(features=4, kernel_size=(1, 1), padding=0,
                            use_bias=True)),
    "reflect_pad_ge_axis": ((1, 2, 3, 4),
                            dict(features=5, kernel_size=(7, 7),
                                 padding="same", padding_mode="reflect")),
    "replicate_3x3_pad2": ((2, 6, 6, 3),
                           dict(features=4, kernel_size=(3, 3), padding=2,
                                padding_mode="replicate", use_bias=True)),
}


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_conv2d_matches_flax(case):
    shape, kw = CONV_CASES[case]
    x = nhwc(1, shape)
    kw = dict(kw)
    features = kw.pop("features")
    jconv = jlayers.Conv2d(features, **kw)
    port = layers.Conv2d(shape[-1], features, **kw)
    ref = carry(jconv, port, jnp.asarray(x))
    with torch.no_grad():
        close(port(to_port(x)), ref, LAYER_TOL)


@pytest.mark.parametrize("pads", [((3, 3), (3, 3)), ((5, 2), (0, 4))])
@pytest.mark.parametrize("mode", ["reflect", "replicate", "zeros"])
def test_pad_image_matches_jax(pads, mode):
    """Pads wider than the (2, 3) axes: repeated reflection."""
    x = nhwc(2, (1, 2, 3, 2))
    ref = jlayers.pad_image(jnp.asarray(x), pads, mode)
    close(layers.pad_image(to_port(x), pads, mode), ref, 0.0)


def test_same_padding_rejects_stride():
    with pytest.raises(ValueError, match="stride 1"):
        layers.Conv2d(3, 4, (3, 3), (2, 2), "same")


def test_spectral_conv2d_matches_flax():
    """Eval mode: the kernel divided by u (W v) of the stored vectors."""
    x = nhwc(14, (2, 8, 8, 3))
    port = layers.Conv2d(3, 4, (4, 4), (2, 2), 1, "reflect", use_spectral=True)
    jconv = jlayers.Conv2d(4, (4, 4), (2, 2), 1, "reflect", use_spectral=True)
    ref = carry(jconv, port, jnp.asarray(x))
    with torch.no_grad():
        close(port(to_port(x)), ref, LAYER_TOL)


def test_dense_matches_flax():
    x = nhwc(3, (4, 16))
    port = layers.Dense(16, 8)
    ref = carry(jlayers.Dense(8), port, jnp.asarray(x))
    with torch.no_grad():
        close(port(torch.from_numpy(x)), ref, LAYER_TOL)


def test_upsample_and_avg_pool_match_jax():
    x = nhwc(4, (2, 6, 8, 3))
    close(layers.upsample_nearest(to_port(x)),
          jlayers.upsample_nearest(jnp.asarray(x)), 0.0)
    close(layers.avg_pool(to_port(x), 2, 2),
          jlayers.avg_pool(jnp.asarray(x), 2, 2), 1e-6)


def test_conv_block_eval_batchnorm_matches_flax():
    x = nhwc(5, (2, 10, 10, 3), 2.0, 0.5)
    port = blocks.ConvBlock(3, 6, (3, 3), padding="same",
                            padding_mode="reflect", norm="batch",
                            act="leaky_relu")
    jmod = jblocks.ConvBlock(6, (3, 3), padding="same", padding_mode="reflect",
                             norm="batch", act="leaky_relu")
    ref = carry(jmod, port, jnp.asarray(x), train=False)
    with torch.no_grad():
        close(port(to_port(x)), ref, BLOCK_TOL)


def test_batchnorm_rejects_indivisible_bn_groups():
    """Train mode splits the batch into bn_groups contiguous groups; a batch
    that does not split raises, as the JAX package's assert does."""
    bn = blocks.BatchNorm(4).train()
    with pytest.raises(ValueError, match="3 BN groups"):
        bn(torch.zeros(4, 4, 3, 3), bn_groups=3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_instance_norm_matches_jax(dtype):
    x = nhwc(6, (2, 9, 7, 5), 3.0, 1.0)
    ref = jnorm.instance_norm(jnp.asarray(x, dtype))
    got = normalization.instance_norm(to_port(x).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    # bf16: both packages center in bf16; 2 ulps at the largest |y| (~4)
    close(got, ref, LAYER_TOL if dtype == "float32" else 6.25e-2)


def test_adain_matches_flax():
    x = nhwc(7, (2, 8, 8, 16), 2.0, 1.0)
    style = nhwc(8, (2, 12))
    port = normalization.AdaIN(16, 12, use_pallas=True)
    ref = carry(jnorm.AdaIN(16, 12, use_pallas=True), port, jnp.asarray(x),
                jnp.asarray(style))
    with torch.no_grad():
        close(port(to_port(x), torch.from_numpy(style)), ref, BLOCK_TOL)


def test_adain_rejects_wrong_style_shape():
    port = normalization.AdaIN(16, 12)
    with pytest.raises(ValueError, match="style feature"):
        port(torch.zeros(2, 16, 4, 4), torch.zeros(2, 11))


def test_resblock_down_scale_matches_flax():
    x = nhwc(9, (2, 8, 8, 4))
    port = blocks.ResBlock(4, 8, (3, 3), "same", "reflect", norm="instance",
                           act="leaky_relu", down_scale=True)
    jmod = jblocks.ResBlock(8, (3, 3), "same", "reflect", norm="instance",
                            act="leaky_relu", down_scale=True)
    ref = carry(jmod, port, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = port(to_port(x))
    assert got.shape == (2, 8, 4, 4)
    close(got, ref, BLOCK_TOL)


@pytest.mark.parametrize("up_scale", [False, True])
def test_norm_res_block_matches_flax(up_scale):
    x = nhwc(10, (2, 6, 6, 8))
    style = nhwc(11, (2, 12))
    labels = np.eye(3, dtype=np.float32)[[0, 2]]
    feats = 4 if up_scale else 8
    kw = dict(label_nc=3, hidden_nc=12, padding="same",
              padding_mode="reflect", up_scale=up_scale)
    port = blocks.NormResBlock("adain", 8, feats, **kw)
    jmod = jblocks.NormResBlock("adain", feats, **kw)
    ref = carry(jmod, port, jnp.asarray(x), jnp.asarray(labels),
                jnp.asarray(style), train=False)
    with torch.no_grad():
        close(port(to_port(x), torch.from_numpy(labels),
                   torch.from_numpy(style)), ref, BLOCK_TOL)


def test_norm_conv_block_matches_flax():
    x = nhwc(12, (2, 5, 5, 8))
    style = nhwc(13, (2, 12))
    labels = np.eye(3, dtype=np.float32)[[1, 2]]
    kw = dict(label_nc=3, hidden_nc=12, padding="same",
              padding_mode="reflect", up_scale=True)
    port = blocks.NormConvBlock("adain", 8, 4, **kw)
    jmod = jblocks.NormConvBlock("adain", 4, **kw)
    ref = carry(jmod, port, jnp.asarray(x), jnp.asarray(labels),
                jnp.asarray(style), train=False)
    with torch.no_grad():
        got = port(to_port(x), torch.from_numpy(labels),
                   torch.from_numpy(style))
    assert got.shape == (2, 4, 10, 10)
    close(got, ref, BLOCK_TOL)


@pytest.mark.parametrize("style_type", ["spade", "sean"])
def test_norm_conv_block_style_types_match_flax(style_type):
    """The SPADE and SEAN decoders' up-scaling block, eval mode (SEAN from
    (N, num_embeds, embed_nc) embeddings)."""
    x = nhwc(15, (2, 5, 5, 8))
    labels = np.eye(3, dtype=np.float32)[[0, 2]]
    style = nhwc(16, (2, 2, 10)) if style_type == "sean" else None
    kw = dict(label_nc=3, hidden_nc=12, embed_nc=10, padding="same",
              padding_mode="reflect", up_scale=True)
    port = blocks.NormConvBlock(style_type, 8, 4, **kw)
    jmod = jblocks.NormConvBlock(style_type, 4, **kw)
    ref = carry(jmod, port, jnp.asarray(x), jnp.asarray(labels),
                None if style is None else jnp.asarray(style), train=False)
    with torch.no_grad():
        got = port(to_port(x), torch.from_numpy(labels),
                   None if style is None else torch.from_numpy(style))
    assert got.shape == (2, 4, 10, 10)
    close(got, ref, BLOCK_TOL)
