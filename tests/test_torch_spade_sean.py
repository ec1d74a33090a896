"""The port's SPADE and SEAN decoders against the JAX package: the norms on
their own (every SPADE path, every SEAN branch, the label index, the KL
term, ``sean_update_stats``), the style-norm blocks and the generator under
all three decoders, in eval and in train mode.

Weights, state and inputs come from seeded numpy draws, carried into the
port through ``train/jax_import.py``; the port works in NCHW and the
transposes are done here. Float32 throughout. Tolerances (DESIGN.md §7):
1e-4 for single layers, 5e-4 for norms, blocks and networks; 1e-5 for the
float32 statistics; the distillation terms 1e-5 absolute (see
DISTILL_ATOL).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from de_i2i_gan_tpu.config import DefectGanConfig as JaxConfig
from de_i2i_gan_tpu.models.generator import DefectGanGenerator as JaxGenerator
from de_i2i_gan_tpu.nn import blocks as jblocks
from de_i2i_gan_tpu.nn import normalization as jnorm
from de_i2i_gan_torch.config import DefectGanConfig
from de_i2i_gan_torch.models.generator import DefectGanGenerator
from de_i2i_gan_torch.nn import blocks, normalization
from de_i2i_gan_torch.train.jax_import import _flatten, _targets, load_jax_module

torch.set_num_threads(1)

LAYER_TOL = 1e-4
BLOCK_TOL = 5e-4
STATS_TOL = 1e-5
# the distillation terms are KL divergences of two nearly equal
# distributions, differences of nearly equal logarithms: absolute 1e-5, about
# t^2 = 16 times the float32 rounding of a log-softmax sum over 16 entries
DISTILL_ATOL = 1e-5
KEY = jax.random.PRNGKey(0)
LABEL_NC, HIDDEN, EMBED, NUM_EMBEDS = 3, 16, 24, 3
TINY = dict(image_size=32, label_nc=4, ngf=8, ndf=8, num_res=2, hidden_nc=16,
            num_layers=2, embed_nc=EMBED, num_embeds=NUM_EMBEDS,
            use_pallas=True)


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


def perturb(tree, rng):
    """Every leaf of a flax tree moved off its init value: positive
    variances and stds, small integer counts, unit spectral vectors."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = perturb(v, rng)
            continue
        v = np.asarray(v, np.float32)
        if k in ("var", "std"):
            v = rng.uniform(0.5, 1.5, v.shape)
        elif k == "count":
            v = rng.integers(0, 4, v.shape)
        elif k.endswith(("_u", "_v")):
            v = rng.normal(0, 1, v.shape)
            v = v / np.linalg.norm(v)
        else:
            v = v + rng.normal(0, 0.1, v.shape)
        out[k] = np.asarray(v, np.float32)
    return out


def jv(variables):
    """numpy trees -> jax arrays, for flax's apply."""
    return jax.tree_util.tree_map(jnp.asarray, variables)


def carry(jmod, port, *args, seed=0, **kw):
    """init the flax module, perturb every collection, load into ``port``;
    returns the flax variables as numpy trees."""
    variables = jax.device_get(
        jmod.init({"params": KEY, "noise": KEY, "latent": KEY}, *args, **kw))
    rng = np.random.default_rng(seed)
    variables = {k: perturb(v, rng) for k, v in variables.items()}
    load_jax_module(port, variables["params"],
                    {k: v for k, v in variables.items() if k != "params"})
    return variables


def close_state(port, mut, colls=("batch_stats", "spectral", "sean_stats"),
                tol=STATS_TOL):
    """The port's state against flax's mutated collections; returns how many
    tensors were compared."""
    flat = {c: _flatten(mut.get(c)) for c in colls}
    n = 0
    for key, tensor, coll, path, to_port_fn in _targets(port):
        if coll in colls:
            np.testing.assert_allclose(tensor.numpy(),
                                       to_port_fn(flat[coll][path]),
                                       atol=tol, rtol=tol, err_msg=key)
            n += 1
    return n


def labels_of(seed, n, label_nc=LABEL_NC):
    """Multi-hot label rows."""
    return np.random.default_rng(seed).integers(0, 2, (n, label_nc)).astype(
        np.float32)


def style_input(style, seed, n):
    if style == "adain":
        return nhwc(seed, (n, HIDDEN))
    if style == "sean":
        return nhwc(seed, (n, NUM_EMBEDS, EMBED))
    return None


def as_torch(a):
    return None if a is None else torch.from_numpy(a)


def as_jax(a):
    return None if a is None else jnp.asarray(a)


# ------------------------------------------------------------------ SPADE

SPADE_CASES = {
    # name: (x NHWC shape, segmap shape: 2-D labels or 4-D NHWC)
    "tile": ((2, 9, 11, 8), (2, LABEL_NC)),
    "small": ((2, 5, 6, 8), (2, LABEL_NC)),
    "resize_up": ((2, 8, 12, 8), (2, 3, 5, LABEL_NC)),
    "resize_down": ((2, 6, 4, 8), (2, 9, 7, LABEL_NC)),
    "same_size": ((2, 6, 6, 8), (2, 6, 6, LABEL_NC)),
}


@pytest.mark.parametrize("case", sorted(SPADE_CASES))
def test_spade_matches_flax(case):
    xs, ss = SPADE_CASES[case]
    x = nhwc(1, xs, 2.0, 0.5)
    seg = np.random.default_rng(2).uniform(0, 1, ss).astype(np.float32)
    jmod = jnorm.SPADE(8, LABEL_NC, HIDDEN)
    port = normalization.SPADE(8, LABEL_NC, HIDDEN)
    variables = carry(jmod, port, jnp.asarray(x), jnp.asarray(seg))
    ref = jmod.apply(jv(variables), jnp.asarray(x), jnp.asarray(seg))
    seg_t = torch.from_numpy(seg) if seg.ndim == 2 else to_port(seg)
    with torch.no_grad():
        close(port(to_port(x), seg_t), ref, BLOCK_TOL)


@pytest.mark.parametrize("src,dst", [((3, 5), (8, 12)), ((9, 7), (6, 4)),
                                     ((1, 1), (7, 3)), ((6, 6), (6, 6))])
def test_resize_nearest_matches_jax_image_resize(src, dst):
    x = nhwc(3, (2, *src, 3))
    ref = jax.image.resize(jnp.asarray(x), (2, *dst, 3), method="nearest")
    close(normalization.resize_nearest(to_port(x), *dst), ref, 0.0)


# ------------------------------------------------------------------- SEAN

SEAN_BRANCHES = ["latent", "inference_stats", "embeds_tracked", "zero_fallback"]


@pytest.mark.parametrize("branch", SEAN_BRANCHES)
def test_sean_branch_matches_flax(branch):
    """The style code from the labels alone; sampled from the running
    statistics; from embeddings, tracked into the statistics; and an exact
    zero code, which falls back to the latent code."""
    n = 4
    x = nhwc(4, (n, 6, 6, 8), 2.0, 0.5)
    labels = labels_of(5, n)
    jmod = jnorm.SEAN(EMBED, 8, LABEL_NC, HIDDEN, use_pallas=True)
    port = normalization.SEAN(EMBED, 8, LABEL_NC, HIDDEN, use_pallas=True)
    variables = carry(jmod, port, jnp.asarray(x), jnp.asarray(labels),
                      jnp.asarray(nhwc(6, (n, NUM_EMBEDS, EMBED))))
    kw = {}
    if branch == "latent":
        feat = None
    elif branch == "inference_stats":
        feat = nhwc(7, (n, HIDDEN))
        kw = dict(inference_stats=True)
    else:
        feat = nhwc(8, (n, NUM_EMBEDS, EMBED))
        kw = dict(track_stats=True)
    if branch == "zero_fallback":
        # rows 0 and 2: zero embeddings and biases that zero both ReLU codes
        feat[[0, 2]] = 0.0
        p = variables["params"]
        p["mlp_shared"]["bias"][:] = -1.0
        p["mlp_latent"]["bias"][:] = -10.0
        load_jax_module(port, p, {"sean_stats": variables["sean_stats"]})
    ref, mut = jmod.apply(jv(variables), jnp.asarray(x), jnp.asarray(labels),
                          as_jax(feat), mutable=["sean_stats"], **kw)
    with torch.no_grad():
        got = port(to_port(x), torch.from_numpy(labels), as_torch(feat), **kw)
    close(got, ref, BLOCK_TOL)
    assert close_state(port, jax.device_get(mut), ("sean_stats",)) == 5
    if branch == "embeds_tracked":
        assert port.count.sum().item() == variables["sean_stats"]["count"].sum() + n


def test_sean_distill_terms_match_flax():
    n = 4
    x = nhwc(9, (n, 6, 6, 8))
    labels = labels_of(10, n)
    feat = nhwc(11, (n, NUM_EMBEDS, EMBED))
    jmod = jnorm.SEAN(EMBED, 8, LABEL_NC, HIDDEN, style_distill=True)
    port = normalization.SEAN(EMBED, 8, LABEL_NC, HIDDEN, style_distill=True)
    variables = carry(jmod, port, jnp.asarray(x), jnp.asarray(labels),
                      jnp.asarray(feat))
    ref, mut = jmod.apply(jv(variables), jnp.asarray(x), jnp.asarray(labels),
                          jnp.asarray(feat), distill=True,
                          mutable=["distill_loss"])
    terms = []
    with torch.no_grad():
        got = port(to_port(x), torch.from_numpy(labels), torch.from_numpy(feat),
                   distill=terms)
    close(got, ref, BLOCK_TOL)
    (lat, emb), = terms
    sown = mut["distill_loss"]
    np.testing.assert_allclose(lat.item(), float(sown["latent"][0]),
                               rtol=LAYER_TOL, atol=DISTILL_ATOL)
    np.testing.assert_allclose(emb.item(), float(sown["embed"][0]),
                               rtol=LAYER_TOL, atol=DISTILL_ATOL)
    assert lat.item() > 0 and emb.item() > 0
    # without a collector, or with style_distill off, nothing is collected
    off = normalization.SEAN(EMBED, 8, LABEL_NC, HIDDEN)
    off(to_port(x), torch.from_numpy(labels), torch.from_numpy(feat),
        distill=terms)
    assert len(terms) == 1


def test_sean_label_index_matches_jax():
    labels = np.random.default_rng(12).integers(0, 2, (32, 6)).astype(np.float32)
    ref = np.asarray(jnorm.sean_label_index(jnp.asarray(labels)))
    got = normalization.sean_label_index(torch.from_numpy(labels))
    np.testing.assert_array_equal(got.numpy(), ref)
    assert got.min().item() >= 0 and got.max().item() < 2 ** 6


def test_kl_with_logits_matches_jax():
    rng = np.random.default_rng(13)
    p = rng.normal(0, 3, (5, 16)).astype(np.float32)
    q = rng.normal(0, 3, (5, 16)).astype(np.float32)
    ref = float(jnorm._kl_with_logits(jnp.asarray(p), jnp.asarray(q)))
    got = normalization._kl_with_logits(torch.from_numpy(p), torch.from_numpy(q))
    np.testing.assert_allclose(got.item(), ref, rtol=LAYER_TOL)


def test_sean_update_stats_matches_jax():
    """Unbiased variance, std = sqrt(var + eps), unseen combinations kept,
    accumulators reset."""
    rng = np.random.default_rng(14)
    combos = 2 ** LABEL_NC
    codes = rng.normal(0, 1, (20, HIDDEN)).astype(np.float32)
    idx = rng.integers(0, combos - 2, 20)  # the last two combinations unseen
    acc = {"sum": np.zeros((combos, HIDDEN), np.float32),
           "sumsq": np.zeros((combos, HIDDEN), np.float32),
           "count": np.zeros(combos, np.float32)}
    np.add.at(acc["sum"], idx, codes)
    np.add.at(acc["sumsq"], idx, codes ** 2)
    np.add.at(acc["count"], idx, 1.0)
    stats = {"mean": rng.normal(0, 1, (combos, HIDDEN)).astype(np.float32),
             "std": rng.uniform(0.5, 1.5, (combos, HIDDEN)).astype(np.float32),
             **acc}
    ref = jax.device_get(jnorm.sean_update_stats({"dec": {"sean": stats}}))
    port = torch.nn.ModuleDict({"dec": torch.nn.ModuleDict({
        "sean": normalization.SEAN(EMBED, 8, LABEL_NC, HIDDEN)})})
    sean = port["dec"]["sean"]
    for k, v in stats.items():
        getattr(sean, k).copy_(torch.from_numpy(v))
    normalization.sean_update_stats(port)
    for k in stats:
        np.testing.assert_allclose(getattr(sean, k).numpy(), ref["dec"]["sean"][k],
                                   atol=STATS_TOL, rtol=STATS_TOL, err_msg=k)
    assert sean.count.sum().item() == 0
    np.testing.assert_array_equal(sean.std[-2:].numpy(), stats["std"][-2:])


# ------------------------------------------------------- blocks and G

STYLES = ["spade", "sean", "adain"]


def _block_pair(kind, style, in_f, out_f, **kw):
    common = dict(label_nc=LABEL_NC, hidden_nc=HIDDEN, embed_nc=EMBED,
                  style_distill=True, padding="same", padding_mode="reflect",
                  **kw)
    if kind == "res":
        return (jblocks.NormResBlock(style, out_f, up_scale=True, **common),
                blocks.NormResBlock(style, in_f, out_f, up_scale=True, **common))
    return (jblocks.NormConvBlock(style, out_f, up_scale=True, **common),
            blocks.NormConvBlock(style, in_f, out_f, up_scale=True, **common))


@pytest.mark.parametrize("mode", ["eval", "train"])
@pytest.mark.parametrize("style", STYLES)
@pytest.mark.parametrize("kind", ["res", "conv"])
def test_style_block_matches_flax(kind, style, mode):
    """Up-scaling NormResBlock / NormConvBlock with spectral-normalized
    convs. Train mode: one power iteration per conv, SEAN statistics
    tracked and distillation terms collected, as the G step runs them."""
    n = 2
    x = nhwc(15, (n, 4, 4, 8), 2.0, 0.5)
    labels = labels_of(16, n)
    feat = style_input(style, 17, n)
    jmod, port = _block_pair(kind, style, 8, 4, use_spectral=True)
    args = (jnp.asarray(x), jnp.asarray(labels), as_jax(feat))
    variables = carry(jmod, port, *args)
    train = mode == "train"
    ref, mut = jmod.apply(jv(variables), *args, train=train, track_stats=train,
                          distill=train,
                          mutable=["spectral", "sean_stats", "distill_loss"])
    port.train(train)
    terms = []
    with torch.no_grad():
        got = port(to_port(x), torch.from_numpy(labels), as_torch(feat),
                   track_stats=train, distill=terms if train else None)
    assert got.shape == (n, 4, 8, 8)
    close(got, ref, BLOCK_TOL)
    mut = jax.device_get(mut)
    assert close_state(port, mut, ("spectral", "sean_stats")) > 0
    sown = mut.get("distill_loss", {})
    want = sorted(float(v) for leaf in jax.tree_util.tree_leaves(sown)
                  for v in np.atleast_1d(leaf))
    got_terms = sorted(t.item() for pair in terms for t in pair)
    assert len(got_terms) == len(want) == (
        0 if style != "sean" or not train else 2 * (3 if kind == "res" else 1))
    np.testing.assert_allclose(got_terms, want, rtol=LAYER_TOL, atol=DISTILL_ATOL)


def _g_pair(style, **kw):
    cfg = dict(TINY, style_norm_block_type=style, use_spectral=True,
               style_distill=True, use_running_stats=True, **kw)
    return JaxGenerator(JaxConfig(**cfg)), DefectGanGenerator(DefectGanConfig(**cfg))


def _g_inputs(style, seed, n=4):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (n, 32, 32, 3)).astype(np.float32)
    labels = np.eye(4, dtype=np.float32)[rng.integers(0, 4, n)]
    if style == "adain":
        feat = rng.normal(0, 1, (n, 16)).astype(np.float32)
    elif style == "sean":
        feat = rng.normal(0, 1, (n, NUM_EMBEDS, EMBED)).astype(np.float32)
    else:
        feat = None
    return x, labels, feat


@pytest.mark.parametrize("mode", ["eval", "train"])
@pytest.mark.parametrize("style", STYLES)
def test_generator_matches_flax(style, mode):
    """Eval: serving. Train: the fused 2B forward of the G step
    (``bn_groups=2``), spectral u/v and BatchNorm statistics updated, SEAN
    statistics tracked and distillation terms collected."""
    jnet, net = _g_pair(style)
    x, labels, feat = _g_inputs(style, 18)
    args = (jnp.asarray(x), jnp.asarray(labels), as_jax(feat))
    variables = carry(jnet, net, *args, train=True)
    train = mode == "train"
    (jout, jprob), mut = jnet.apply(
        jv(variables), *args, train=train, track_stats=train, distill=train,
        bn_groups=2 if train else 1,
        mutable=["batch_stats", "spectral", "sean_stats", "distill_loss"],
        rngs={"noise": KEY, "latent": KEY})
    net.train(train)
    terms = []
    with torch.no_grad():
        out, prob = net(torch.from_numpy(x), torch.from_numpy(labels),
                        as_torch(feat), bn_groups=2 if train else 1,
                        track_stats=train, distill=terms if train else None)
    for got, ref in ((out, jout), (prob, jprob)):  # both NHWC
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   atol=BLOCK_TOL, rtol=BLOCK_TOL)
    mut = jax.device_get(mut)
    assert close_state(net, mut, tol=1e-4) > 0
    want = sorted(float(v) for leaf in jax.tree_util.tree_leaves(
        mut.get("distill_loss", {})) for v in np.atleast_1d(leaf))
    got_terms = sorted(t.item() for pair in terms for t in pair)
    # SEAN in train mode: 2 terms for each of the 2 * (num_res // 2) +
    # num_scales = 4 norms
    assert len(got_terms) == len(want) == (8 if style == "sean" and train else 0)
    np.testing.assert_allclose(got_terms, want, rtol=LAYER_TOL, atol=DISTILL_ATOL)


def test_generator_inference_stats_matches_flax():
    """SEAN serving that samples the running statistics with noise."""
    jnet, net = _g_pair("sean")
    x, labels, feat = _g_inputs("sean", 19)
    variables = carry(jnet, net, jnp.asarray(x), jnp.asarray(labels),
                      jnp.asarray(feat), train=True)
    noise = np.random.default_rng(20).normal(0, 1, (4, 16)).astype(np.float32)
    jout, jprob = jnet.apply(jv(variables), jnp.asarray(x), jnp.asarray(labels),
                             jnp.asarray(noise), inference_stats=True,
                             rngs={"noise": KEY, "latent": KEY})
    net.eval()
    with torch.no_grad():
        out, prob = net(torch.from_numpy(x), torch.from_numpy(labels),
                        torch.from_numpy(noise), inference_stats=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=BLOCK_TOL,
                               rtol=BLOCK_TOL)
    np.testing.assert_allclose(prob.numpy(), np.asarray(jprob), atol=BLOCK_TOL,
                               rtol=BLOCK_TOL)
