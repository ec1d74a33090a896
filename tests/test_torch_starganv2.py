"""The port's StarGAN v2 serving (``models/starganv2.py``,
``train/solver.py``) against the JAX package on the CPU.

Every module of the serving path is held against its flax counterpart:
``AffineInstanceNorm``, ``ResBlk``, ``StyleAdaIN``, ``SEANv2`` (every
branch: track_stats, inference_stats with std_weight, mix_alpha),
``_StyledResBlk``, ``high_pass``, ``Generator`` (AdaIN and SEAN,
``layer_split_index``, ``w_hpf > 0`` with and without FAN masks),
``MappingNetwork``,
``StyleEncoder`` and ``sean_v2_update_stats``; then the solver's
``generate`` with latent, reference and SEAN styles, EMA and not, and the
update_stats flow (``track_stats_step``, ``finalize_ema_stats``, an
``inference_stats`` request). Weights and state come from a flax init with
every bias, scale and statistic moved off its init value by a seeded numpy
draw, carried into the port with ``train/jax_import.py``. The size is the
JAX suite's tiny config (``tests/test_starganv2.py``: img 64, max_conv_dim
32-64, style_dim 8, hidden_nc 16, embed_nc 12). Float32; forward tolerance
5e-4 (DESIGN.md section 7), 1e-5 for the float32 statistics.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from de_i2i_gan_tpu.models import starganv2 as jsg
from de_i2i_gan_tpu.train.solver import StarGANv2Config as JaxConfig
from de_i2i_gan_tpu.train.solver import StarGANv2Solver as JaxSolver
from de_i2i_gan_torch.models import starganv2 as sg
from de_i2i_gan_torch.train.jax_import import (
    _flatten, _targets, init_starganv2_weights, load_jax_module,
    load_jax_starganv2)
from de_i2i_gan_torch.train.solver import StarGANv2Config, StarGANv2Solver

torch.set_num_threads(1)

TOL = 5e-4
STATS_TOL = 1e-5
KEY = jax.random.PRNGKey(0)
DOMAINS, STYLE, LATENT, HIDDEN, EMBED, NUM_EMBEDS = 3, 8, 4, 16, 12, 5
CFG = dict(img_size=64, num_domains=DOMAINS, style_dim=STYLE,
           latent_dim=LATENT, hidden_nc=HIDDEN, embed_nc=EMBED, w_hpf=0.0,
           max_conv_dim=64, num_embeds=NUM_EMBEDS)


def normal(seed, shape, scale=1.0, shift=0.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, shape) * scale + shift).astype(np.float32)


def domains(seed, n):
    return np.random.default_rng(seed).integers(0, DOMAINS, n).astype(np.int32)


def to_nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def close(port, ref, tol=TOL, nchw=False):
    got = port.detach().float().numpy()
    if nchw:
        got = got.transpose(0, 2, 3, 1)
    np.testing.assert_allclose(got, np.asarray(ref, np.float32), atol=tol,
                               rtol=tol)


def perturb(tree, rng):
    """Every bias, scale and statistic of a flax tree moved off its init
    value (he_init kernels and embeddings are random already): positive
    stds, small integer counts."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = perturb(v, rng)
            continue
        v = np.asarray(v, np.float32)
        if k == "std":
            v = rng.uniform(0.5, 1.5, v.shape)
        elif k == "count":
            v = rng.integers(0, 4, v.shape)
        elif k not in ("kernel", "embedding"):
            v = v + rng.normal(0, 0.1, v.shape)
        out[k] = np.asarray(v, np.float32)
    return out


def jv(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def carry(jmod, port, *args, seed=0, **kw):
    """Init the flax module, perturb every collection, load into ``port``;
    returns the flax variables as numpy trees."""
    variables = jax.device_get(jmod.init(KEY, *args, **kw))
    rng = np.random.default_rng(seed)
    variables = {k: perturb(v, rng) for k, v in variables.items()}
    load_jax_module(port, variables["params"],
                    {k: v for k, v in variables.items() if k != "params"})
    return variables


def close_stats(port, sean_stats, tol=STATS_TOL):
    """The port's SEANv2 buffers against a flax ``sean_stats`` tree."""
    flat = _flatten(sean_stats)
    n = 0
    for key, tensor, coll, path, _ in _targets(port):
        if coll == "sean_stats":
            np.testing.assert_allclose(tensor.numpy(), flat[path], atol=tol,
                                       rtol=tol, err_msg=key)
            n += 1
    assert n > 0
    return n


# ---------------------------------------------------------------- modules


def test_affine_instance_norm_matches_flax():
    x = normal(1, (2, 6, 5, 8), 2.0, 0.5)
    port = sg.AffineInstanceNorm(8)
    v = carry(jsg.AffineInstanceNorm(), port, jnp.asarray(x))
    ref = jsg.AffineInstanceNorm().apply(jv(v), jnp.asarray(x))
    with torch.no_grad():
        close(port(to_nchw(x)), ref, nchw=True)


@pytest.mark.parametrize("normalize,downsample,features", [
    (False, False, 8), (True, True, 12), (False, True, 12), (True, False, 8)])
def test_resblk_matches_flax(normalize, downsample, features):
    x = normal(2, (2, 8, 8, 8))
    jmod = jsg.ResBlk(features, normalize=normalize, downsample=downsample)
    port = sg.ResBlk(8, features, normalize=normalize, downsample=downsample)
    v = carry(jmod, port, jnp.asarray(x))
    with torch.no_grad():
        close(port(to_nchw(x)), jmod.apply(jv(v), jnp.asarray(x)), nchw=True)


def test_style_adain_matches_flax():
    x, s = normal(3, (2, 5, 5, 8), 2.0, 0.5), normal(4, (2, STYLE))
    jmod, port = jsg.StyleAdaIN(8), sg.StyleAdaIN(STYLE, 8)
    v = carry(jmod, port, jnp.asarray(x), jnp.asarray(s))
    ref = jmod.apply(jv(v), jnp.asarray(x), jnp.asarray(s))
    with torch.no_grad():
        close(port(to_nchw(x), torch.from_numpy(s)), ref, nchw=True)


SEAN_BRANCHES = ["embeds", "track_stats", "inference_stats", "mix_alpha"]


@pytest.mark.parametrize("branch", SEAN_BRANCHES)
def test_seanv2_branch_matches_flax(branch):
    """The style code from embeddings (averaged, or weighted by mix_alpha),
    tracked into the statistics, or sampled from them with std_weight."""
    n = 4
    x = normal(5, (n, 6, 6, 8), 2.0, 0.5)
    y = np.asarray([0, 0, 1, 2], np.int32)
    feat = normal(6, (n, NUM_EMBEDS, EMBED))
    jmod = jsg.SEANv2(EMBED, 8, DOMAINS, HIDDEN)
    port = sg.SEANv2(EMBED, 8, DOMAINS, HIDDEN)
    v = carry(jmod, port, jnp.asarray(x), jnp.asarray(y), jnp.asarray(feat))
    kw = {}
    if branch == "track_stats":
        kw = dict(track_stats=True)
    elif branch == "inference_stats":
        feat = normal(7, (n, HIDDEN))
        kw = dict(inference_stats=True, std_weight=1.7)
    elif branch == "mix_alpha":
        kw = dict(mix_alpha=np.random.default_rng(8).uniform(
            0.1, 1.0, (n, NUM_EMBEDS)).astype(np.float32))
    jkw = {k: jnp.asarray(a) if isinstance(a, np.ndarray) else a
           for k, a in kw.items()}
    tkw = {k: torch.from_numpy(a) if isinstance(a, np.ndarray) else a
           for k, a in kw.items()}
    ref, mut = jmod.apply(jv(v), jnp.asarray(x), jnp.asarray(y),
                          jnp.asarray(feat), mutable=["sean_stats"], **jkw)
    with torch.no_grad():
        out = port(to_nchw(x), torch.from_numpy(y).long(),
                   torch.from_numpy(feat), **tkw)
    close(out, ref, nchw=True)
    close_stats(port, jax.device_get(mut["sean_stats"]))
    if branch == "track_stats":
        assert port.count.tolist() == list(v["sean_stats"]["count"] +
                                           np.asarray([2, 1, 1]))
    if branch == "mix_alpha":  # the weights matter
        with torch.no_grad():
            mean = port(to_nchw(x), torch.from_numpy(y).long(),
                        torch.from_numpy(feat))
        assert not torch.allclose(out, mean, atol=1e-3)


def test_seanv2_rejects_flat_embeddings():
    port = sg.SEANv2(EMBED, 8, DOMAINS, HIDDEN)
    with pytest.raises(ValueError, match="num_embeds"):
        port(torch.zeros(2, 8, 4, 4), torch.zeros(2, dtype=torch.long),
             torch.zeros(2, EMBED))


def test_sean_v2_update_stats_matches_jax():
    """Finalized per-domain means and unbiased stds; a domain with no
    tracked code keeps its statistics; the accumulators reset."""
    port = sg.SEANv2(EMBED, 8, DOMAINS, HIDDEN)
    rng = np.random.default_rng(9)
    stats = {"mean": rng.normal(0, 1, (DOMAINS, HIDDEN)),
             "std": rng.uniform(0.5, 1.5, (DOMAINS, HIDDEN)),
             "sum": rng.normal(0, 3, (DOMAINS, HIDDEN)),
             "sumsq": rng.uniform(5, 9, (DOMAINS, HIDDEN)),
             "count": np.asarray([3, 0, 1])}
    stats = {k: np.asarray(v, np.float32) for k, v in stats.items()}
    for k, v in stats.items():
        getattr(port, k).copy_(torch.from_numpy(v))
    sg.sean_v2_update_stats(torch.nn.Sequential(port))
    ref = jax.device_get(jsg.sean_v2_update_stats(jv({"norm": stats})))["norm"]
    for k, want in ref.items():
        np.testing.assert_allclose(getattr(port, k).numpy(), want,
                                   atol=STATS_TOL, rtol=STATS_TOL, err_msg=k)
    np.testing.assert_array_equal(port.mean[1].numpy(), stats["mean"][1])
    assert port.count.sum().item() == 0


@pytest.mark.parametrize("norm_type", ["adain", "sean"])
@pytest.mark.parametrize("upsample,features,w_hpf", [
    (False, 8, 0.0), (True, 6, 0.0), (True, 6, 1.0)])
def test_styled_resblk_matches_flax(norm_type, upsample, features, w_hpf):
    x = normal(10, (2, 6, 6, 8))
    y = np.asarray([1, 2], np.int32)
    s = (normal(11, (2, STYLE)) if norm_type == "adain"
         else normal(11, (2, NUM_EMBEDS, EMBED)))
    blk = dict(norm_type=norm_type, style_dim=STYLE, embed_nc=EMBED,
               label_nc=DOMAINS, hidden_nc=HIDDEN, w_hpf=w_hpf,
               upsample=upsample)
    jmod = jsg._StyledResBlk(features, **blk)
    port = sg._StyledResBlk(8, features, **blk)
    args = (jnp.asarray(x), jnp.asarray(s), jnp.asarray(y))
    v = carry(jmod, port, *args)
    with torch.no_grad():
        out = port(to_nchw(x), torch.from_numpy(s), torch.from_numpy(y).long())
    close(out, jmod.apply(jv(v), *args), nchw=True)
    assert (port.conv1x1 is None) == (w_hpf > 0 or features == 8)


def test_high_pass_matches_jax():
    x = normal(12, (2, 7, 9, 4))
    ref = jsg.high_pass(jnp.asarray(x), 1.5)
    close(sg.high_pass(to_nchw(x), 1.5), ref, tol=1e-5, nchw=True)


GEN_CASES = {
    "adain": dict(norm_type="adain", w_hpf=0.0),
    "adain_hpf": dict(norm_type="adain", w_hpf=1.0),  # no masks
    "sean": dict(norm_type="sean", w_hpf=0.0),
    "adain_split": dict(norm_type="adain", w_hpf=0.0, split=(0, 2)),
    "sean_split": dict(norm_type="sean", w_hpf=0.0, split=(1, 3)),
}


@pytest.mark.parametrize("case", sorted(GEN_CASES))
def test_generator_matches_flax(case):
    kw = dict(GEN_CASES[case])
    split = kw.pop("split", None)
    gkw = dict(img_size=64, style_dim=STYLE, max_conv_dim=32,
               embed_nc=EMBED, label_nc=DOMAINS, hidden_nc=HIDDEN, **kw)
    jmod, port = jsg.Generator(**gkw), sg.Generator(**gkw)
    x = np.random.default_rng(13).uniform(-1, 1, (2, 64, 64, 3)).astype(
        np.float32)
    y = domains(14, 2)
    shape = (2, STYLE) if kw["norm_type"] == "adain" else (2, NUM_EMBEDS, EMBED)
    s = normal(15, shape)
    v = carry(jmod, port, jnp.asarray(x), jnp.asarray(s),
              labels=jnp.asarray(y))
    if split is not None:
        s = np.stack([s, normal(16, shape)], axis=1)
    ref = jmod.apply(jv(v), jnp.asarray(x), jnp.asarray(s),
                     labels=jnp.asarray(y), layer_split_index=split)
    with torch.no_grad():
        out = port(torch.from_numpy(x), torch.from_numpy(s),
                   labels=torch.from_numpy(y).long(), layer_split_index=split)
    assert out.shape == (2, 64, 64, 3)
    close(out, ref)


@pytest.mark.parametrize("mask_size", [256, 32])
def test_generator_with_masks_matches_flax(mask_size):
    """w_hpf 1 with FAN masks (once unported): the encoder's skips at 32 and
    64 px, the masks resized as jax.image.resize does (256 -> 32/64
    antialiased; 32 -> 64 grows), the high-pass fusion."""
    gkw = dict(img_size=64, style_dim=STYLE, max_conv_dim=32, w_hpf=1.0)
    jmod, port = jsg.Generator(**gkw), sg.Generator(**gkw)
    x = np.random.default_rng(20).uniform(-1, 1, (2, 64, 64, 3)).astype(
        np.float32)
    s = normal(21, (2, STYLE))
    rng = np.random.default_rng(22)
    masks = [rng.uniform(0, 1, (2, mask_size, mask_size, 1)).astype(np.float32)
             for _ in range(2)]
    v = carry(jmod, port, jnp.asarray(x), jnp.asarray(s))
    ref = jmod.apply(jv(v), jnp.asarray(x), jnp.asarray(s),
                     masks=[jnp.asarray(m) for m in masks])
    with torch.no_grad():
        out = port(torch.from_numpy(x), torch.from_numpy(s),
                   masks=[torch.from_numpy(m) for m in masks])
        plain = port(torch.from_numpy(x), torch.from_numpy(s))
    close(out, ref)
    assert (out - plain).abs().max() > 1e-3  # the masks changed the output


def test_mapping_network_matches_flax():
    z, y = normal(17, (4, LATENT)), domains(18, 4)
    jmod = jsg.MappingNetwork(LATENT, STYLE, DOMAINS)
    port = sg.MappingNetwork(LATENT, STYLE, DOMAINS)
    v = carry(jmod, port, jnp.asarray(z), jnp.asarray(y))
    with torch.no_grad():
        out = port(torch.from_numpy(z), torch.from_numpy(y).long())
    close(out, jmod.apply(jv(v), jnp.asarray(z), jnp.asarray(y)))


@pytest.mark.parametrize("max_conv_dim", [32, 64])
def test_style_encoder_matches_flax(max_conv_dim):
    x = np.random.default_rng(19).uniform(-1, 1, (3, 64, 64, 3)).astype(
        np.float32)
    y = domains(20, 3)
    kw = dict(img_size=64, style_dim=STYLE, num_domains=DOMAINS,
              max_conv_dim=max_conv_dim)
    jmod, port = jsg.StyleEncoder(**kw), sg.StyleEncoder(**kw)
    v = carry(jmod, port, jnp.asarray(x), jnp.asarray(y))
    with torch.no_grad():
        out = port(torch.from_numpy(x), torch.from_numpy(y).long())
    close(out, jmod.apply(jv(v), jnp.asarray(x), jnp.asarray(y)))


# ---------------------------------------------------------------- solver


def _perturbed_state(jsolver, seed):
    state = jax.device_get(jsolver.init_state(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    g_state = {k: perturb(v, rng) for k, v in (state.G.state or {}).items()}
    replace = dict(
        G=state.G.replace(params=perturb(state.G.params, rng), state=g_state),
        ema_G=perturb(state.G.params, rng))  # an EMA that differs from G
    if state.ema_sean_stats is not None:
        replace["ema_sean_stats"] = perturb(state.ema_sean_stats, rng)
    if state.M is not None:
        replace.update(
            M=state.M.replace(params=perturb(state.M.params, rng)),
            S=state.S.replace(params=perturb(state.S.params, rng)),
            ema_M=perturb(state.M.params, rng),
            ema_S=perturb(state.S.params, rng))
    return state.replace(**replace)


@functools.lru_cache(maxsize=None)
def solvers(case):
    """(jax solver, perturbed jax state, port solver) from one JAX init;
    case: adain, sean, or adain_hpf (w_hpf=1 without masks)."""
    kw = dict(CFG, norm_type=case.split("_")[0],
              w_hpf=1.0 if case.endswith("hpf") else 0.0)
    jsolver = JaxSolver(JaxConfig(**kw))
    state = _perturbed_state(jsolver, 0)
    port = StarGANv2Solver(StarGANv2Config(**kw), device="cpu")
    load_jax_starganv2(port, state)
    return jsolver, state, port


def _request(seed, n=2):
    rng = np.random.default_rng(seed)
    return {"x_src": rng.uniform(-1, 1, (n, 64, 64, 3)).astype(np.float32),
            "x_ref": rng.uniform(-1, 1, (n, 64, 64, 3)).astype(np.float32),
            "z_ref": rng.normal(0, 1, (n, LATENT)).astype(np.float32),
            "s_ref": rng.normal(0, 1, (n, NUM_EMBEDS, EMBED)).astype(np.float32),
            "y_ref": domains(seed + 1, n)}


GENERATE_CASES = [(case, mode, ema) for case in ("adain", "adain_hpf", "sean")
                  for mode in ("latent", "reference") for ema in (True, False)
                  if not (case == "sean" and mode == "latent")]


@pytest.mark.parametrize("case,mode,use_ema", GENERATE_CASES,
                         ids=[f"{c}-{m}-{'ema' if e else 'net'}"
                              for c, m, e in GENERATE_CASES])
def test_generate_matches_jax(case, mode, use_ema):
    """A request: the style code (M for latent, S for reference, the
    caller's embeddings for SEAN), then G, each EMA or not."""
    jsolver, state, port = solvers(case)
    b = _request(21)
    latent = mode == "latent"
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    if case.startswith("adain") and use_ema:
        net = jsolver.M if latent else jsolver.S
        ema = state.ema_M if latent else state.ema_S
        js = net.apply({"params": jv(ema)}, jb["z_ref" if latent else "x_ref"],
                       jb["y_ref"])
    else:
        js = jsolver._style(jv(state), jb, jb["y_ref"], which="ref",
                            latent=latent)
    s = port.style({k: torch.from_numpy(v) for k, v in b.items()},
                   torch.from_numpy(b["y_ref"]), which="ref", latent=latent,
                   use_ema=use_ema)
    close(s, js)
    ref = jsolver.generate(jv(state), jb["x_src"], js, jb["y_ref"],
                           use_ema=use_ema)
    out = port.generate(torch.from_numpy(b["x_src"]), s,
                        torch.from_numpy(b["y_ref"]), use_ema=use_ema)
    assert out.shape == (2, 64, 64, 3)
    close(out, ref)


@pytest.mark.parametrize("case", ["adain", "sean"])
def test_generate_mix_alpha_and_layer_split_match_jax(case):
    jsolver, state, port = solvers(case)
    b = _request(22)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    if case.startswith("sean"):
        s = np.stack([b["s_ref"], _request(23)["s_ref"]], axis=1)
        alpha = np.random.default_rng(24).uniform(
            0.1, 1.0, (2, NUM_EMBEDS)).astype(np.float32)
        jkw = dict(mix_alpha=jnp.asarray(alpha), layer_split_index=(0, 3))
        tkw = dict(mix_alpha=torch.from_numpy(alpha), layer_split_index=(0, 3))
    else:
        s = normal(25, (2, 2, STYLE))
        jkw = tkw = dict(layer_split_index=(1, 2))
    ref = jsolver.generate(jv(state), jb["x_src"], jnp.asarray(s), jb["y_ref"],
                           **jkw)
    out = port.generate(torch.from_numpy(b["x_src"]), torch.from_numpy(s),
                        torch.from_numpy(b["y_ref"]), **tkw)
    close(out, ref)


def test_update_stats_then_inference_stats_request_matches_jax():
    """The update_stats flow: two tracking forwards of the EMA generator,
    the finalization, then a request that samples the finalized running
    styles with noise from a seed. A solver of its own: the flow changes
    its statistics."""
    jsolver, state, port = solvers.__wrapped__("sean")
    for seed in (26, 27):
        b = _request(seed, n=3)
        state = jsolver.track_stats_step(
            jv(state), jnp.asarray(b["x_ref"]), jnp.asarray(b["s_ref"]),
            jnp.asarray(b["y_ref"]))
        port.track_stats_step(torch.from_numpy(b["x_ref"]),
                              torch.from_numpy(b["s_ref"]),
                              torch.from_numpy(b["y_ref"]))
    close_stats(port.ema_G, jax.device_get(state.ema_sean_stats))
    state = jsolver.finalize_ema_stats(state)
    port.finalize_ema_stats()
    assert all(float(m.count.sum()) == 0 for m in port.ema_G.modules()
               if isinstance(m, sg.SEANv2))
    close_stats(port.ema_G, jax.device_get(state.ema_sean_stats))
    b = _request(28)
    noise = normal(29, (2, HIDDEN))
    ref = jsolver.generate(state, jnp.asarray(b["x_src"]), jnp.asarray(noise),
                           jnp.asarray(b["y_ref"]), inference_stats=True,
                           std_weight=0.8)
    out = port.generate(torch.from_numpy(b["x_src"]), torch.from_numpy(noise),
                        torch.from_numpy(b["y_ref"]), inference_stats=True,
                        std_weight=0.8)
    close(out, ref)
    # G's own statistics were not touched by the EMA generator's sweep
    close_stats(port.G, jax.device_get(state.G.state["sean_stats"]))


@pytest.mark.parametrize("case", ["adain", "sean"])
def test_load_is_strict(case):
    _, state, _ = solvers(case)
    other = StarGANv2Solver(StarGANv2Config(
        **dict(CFG, norm_type="sean" if case.startswith("adain") else "adain")),
        device="cpu")
    with pytest.raises((ValueError, KeyError)):
        load_jax_starganv2(other, state)


def test_init_weights_he_distribution():
    solver = StarGANv2Solver(StarGANv2Config(**dict(CFG, norm_type="sean")),
                             device="cpu")
    init_starganv2_weights(solver, 0)
    w = solver.G.decode_0.conv1.weight  # fan_in 64 * 3 * 3
    assert abs(w.std().item() / (2 / (64 * 9)) ** 0.5 - 1) < 0.05
    emb = solver.G.decode_0.norm1.label_embedding.weight
    assert abs(emb.std().item() * HIDDEN ** 0.5 - 1) < 0.3
    assert bool((solver.G.to_rgb_norm.scale == 1).all())
    for k, v in solver.G.state_dict().items():
        assert torch.equal(v, solver.ema_G.state_dict()[k]), k
    again = StarGANv2Solver(StarGANv2Config(**dict(CFG, norm_type="sean")),
                            device="cpu")
    init_starganv2_weights(again, 0)
    assert torch.equal(again.G.from_rgb.weight, solver.G.from_rgb.weight)
