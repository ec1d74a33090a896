"""The port's reference ``.pth`` import (``train/torch_import.py``) against
the JAX package's converter (``de_i2i_gan_tpu/train/torch_import.py``)
carried into the port by ``train/jax_import.py``.

No reference checkpoint is in the repository, so the tests build state
dicts with the reference's key names (``ref_key`` inverts the mapping) at
the tiny config, for SPADE, SEAN and AdaIN, with and without spectral norm
and noise injection: seeded values for every entry the mapping reads, plus
entries it ignores (BatchNorm's ``num_batches_tracked``, the reference's
spectral u and v), noise weights in the reference's (1, 1, 1, 1). Both
paths start from one JAX init (spectral u/v and SEAN's statistics are the
target's own on both). Both give equal tensors; G's and D's forwards (eval,
float32, noise from one torch stream) agree with the JAX package's on the
JAX-converted weights within 5e-4 (DESIGN.md §7). ``import_torch_checkpoint``
reads files ``torch.save`` wrote; a missing key raises ``KeyError``.
"""
import copy
import functools
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from de_i2i_gan_tpu.config import DefectGanConfig as JaxConfig
from de_i2i_gan_tpu.config import TrainConfig as JaxTrainConfig
from de_i2i_gan_tpu.train import torch_import as jax_torch_import
from de_i2i_gan_tpu.train.steps import DefectGanSteps as JaxSteps
from de_i2i_gan_torch.config import DefectGanConfig, TrainConfig
from de_i2i_gan_torch.nn.blocks import BatchNorm
from de_i2i_gan_torch.train import torch_import
from de_i2i_gan_torch.train.jax_import import load_jax_module
from de_i2i_gan_torch.train.steps import DefectGanSteps

torch.set_num_threads(1)

JAX_TOL = 5e-4
TINY = dict(image_size=32, label_nc=4, ngf=8, ndf=8, num_res=2, hidden_nc=16,
            num_layers=2, embed_nc=12, num_embeds=2)
VARIANTS = {"plain": {}, "spectral_noise": dict(use_spectral=True,
                                                add_noise=True)}

# the port's G keys -> the reference's (inverting the JAX module's table)
G_RULES = [
    (r"^stem\.conv\.", "stem.conv_block.0."),
    (r"^stem\.norm\.", "stem.conv_block.1."),
    (r"^enc_(\d+)\.conv\.", r"enc_blk.\1.conv_block.0."),
    (r"^enc_(\d+)\.norm\.", r"enc_blk.\1.conv_block.1."),
    (r"^enc_res_(\d+)\.conv_(\d+)\.conv\.", r"enc_res_blk.\1.res_block.\2.conv_block.0."),
    (r"^enc_res_(\d+)\.conv_(\d+)\.norm\.", r"enc_res_blk.\1.res_block.\2.conv_block.1."),
    (r"^dec_res_(\d+)\.norm_(\d+)\.\w+\.mlp_(shared|latent)\.", r"dec_res_blk.\1.norm_\2.mlp_\3.0."),
    (r"^dec_res_(\d+)\.norm_(\d+)\.\w+\.mlp_", r"dec_res_blk.\1.norm_\2.mlp_"),
    (r"^dec_res_(\d+)\.", r"dec_res_blk.\1."),
    (r"^dec_(\d+)\.norm\.\w+\.mlp_(shared|latent)\.", r"dec_blk.\1.norm.mlp_\2.0."),
    (r"^dec_(\d+)\.norm\.\w+\.mlp_", r"dec_blk.\1.norm.mlp_"),
    (r"^dec_(\d+)\.", r"dec_blk.\1."),
    (r"^(foreground|distribution)_head\.conv\.", r"\1_head.de_conv_block.0."),
]
D_RULES = [
    (r"^stem\.conv\.", "enc_blk.0.conv_block.0."),
    (r"^enc_(\d+)\.conv\.", lambda m: f"enc_blk.{int(m[1]) + 1}.conv_block.0."),
    (r"^(cls|src)_clf\.conv\.", r"\1_clf.conv_block.0."),
]


def ref_key(key, rules):
    for pattern, repl in rules:
        new, n = re.subn(pattern, repl, key)
        if n:
            return new
    raise KeyError(key)


def reference_state_dict(module, rules, seed):
    """A state dict keyed as the reference's: seeded values for the
    module's parameters and BatchNorm statistics (``weight_orig`` for a
    spectrally normalized conv, beside u and v of its own), noise weights
    (1, 1, 1, 1), and BatchNorm's ``num_batches_tracked``."""
    gen = torch.Generator().manual_seed(seed)
    bn = {n for n, m in module.named_modules() if isinstance(m, BatchNorm)}
    sd = {}
    for key, value in module.state_dict().items():
        prefix, name = key.rsplit(".", 1)
        if name in ("weight_u", "weight_v") or prefix.rsplit(".", 1)[-1] in (
                "sean",) and name in ("mean", "std", "sum", "sumsq", "count"):
            continue
        draw = torch.randn(value.shape, generator=gen) * 0.2
        if name == "running_var":
            draw = draw.abs() + 0.5
        if ".noise" in key:
            draw = draw.reshape(1, 1, 1, 1)
        out = ref_key(key, rules)
        if name == "weight" and getattr(module.get_submodule(prefix),
                                        "use_spectral", False):
            sd[out[:-len("weight")] + "weight_orig"] = draw
            for uv in ("weight_u", "weight_v"):
                sd[out[:-len("weight")] + uv] = torch.randn(3, generator=gen)
        else:
            sd[out] = draw
        if prefix in bn and name == "running_var":
            sd[out[:-len("running_var")] + "num_batches_tracked"] = \
                torch.tensor(7)
    return sd


@functools.lru_cache(maxsize=None)
def _jax(style, variant):
    cfg = dict(TINY, style_norm_block_type=style, **VARIANTS[variant])
    jsteps = JaxSteps(JaxConfig(**cfg), JaxTrainConfig())
    state = jax.device_get(jsteps.init_state(jax.random.PRNGKey(0)))
    return jsteps, state


def _case(style, variant):
    """(jax steps, jax state, port cfg, port steps from the JAX init)."""
    jsteps, state = _jax(style, variant)
    cfg = DefectGanConfig(**TINY, style_norm_block_type=style,
                          **VARIANTS[variant])
    steps = DefectGanSteps(cfg, TrainConfig(), device="cpu")
    steps.init_training()
    load_jax_module(steps.G, state.G.params, state.G.state)
    load_jax_module(steps.D, state.D.params, state.D.state)
    return jsteps, state, cfg, steps


def _noise_from(monkeypatch, seed):
    gen = torch.Generator().manual_seed(seed)
    monkeypatch.setattr(
        jax.random, "normal",
        lambda key, shape, dtype=jnp.float32: jnp.asarray(
            torch.randn(shape, generator=gen).numpy(), dtype))


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("style", ["spade", "sean", "adain"])
def test_import_equals_jax_converter(style, variant, tmp_path, monkeypatch):
    jsteps, state, cfg, via_jax = _case(style, variant)
    port = copy.deepcopy(via_jax)
    g_sd = reference_state_dict(port.G, G_RULES, 1)
    d_sd = reference_state_dict(port.D, D_RULES, 2)
    # the JAX converter, carried into the port
    jcfg = JaxConfig(**TINY, style_norm_block_type=style, **VARIANTS[variant])
    g_params, g_stats = jax_torch_import.convert_defectgan_generator(g_sd, jcfg)
    d_params = jax_torch_import.convert_defectgan_discriminator(d_sd, jcfg)
    g_state = {**state.G.state, "batch_stats": g_stats}
    load_jax_module(via_jax.G, g_params, g_state)
    load_jax_module(via_jax.D, d_params, state.D.state)
    # the port's importer, from files
    torch.save(g_sd, tmp_path / "1_net_G.pth")
    torch.save(d_sd, tmp_path / "1_net_D.pth")
    assert torch_import.import_torch_checkpoint(
        tmp_path / "1_net_G.pth", tmp_path / "1_net_D.pth", cfg, port) is port
    for net in ("G", "D"):
        want = getattr(via_jax, net).state_dict()
        got = getattr(port, net).state_dict()
        assert list(got) == list(want)
        for k in want:
            assert torch.equal(got[k], want[k]), f"{net} {k}"

    # the forwards against JAX's on the JAX-converted weights
    gen = torch.Generator().manual_seed(3)
    x = torch.rand((2, 32, 32, 3), generator=gen) * 2 - 1
    labels = torch.eye(4)[torch.tensor([1, 3])]
    style_feat = (torch.randn((2, 16), generator=gen)
                  if style == "adain" else None)
    _noise_from(monkeypatch, 5)
    ref, ref_prob = jsteps.G.apply(
        {"params": g_params, **g_state}, jnp.asarray(x.numpy()),
        jnp.asarray(labels.numpy()),
        None if style_feat is None else jnp.asarray(style_feat.numpy()),
        train=False, rngs={"noise": jax.random.PRNGKey(0)})
    ref_src, ref_cls = jsteps.D.apply({"params": d_params, **state.D.state},
                                      jnp.asarray(x.numpy()), train=False)
    with torch.no_grad():
        out, prob = port.G(x, labels, style_feat,
                           generator=torch.Generator().manual_seed(5))
        src, cls = port.D(x)
    for got, want in ((out, ref), (prob, ref_prob), (src, ref_src),
                      (cls, ref_cls)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=JAX_TOL, rtol=JAX_TOL)


def test_missing_key_raises(tmp_path):
    _, _, cfg, steps = _case("spade", "plain")
    g_sd = reference_state_dict(steps.G, G_RULES, 1)
    d_sd = reference_state_dict(steps.D, D_RULES, 2)
    del g_sd["dec_res_blk.0.norm_1.mlp_gamma.bias"]
    torch.save(g_sd, tmp_path / "G.pth")
    torch.save(d_sd, tmp_path / "D.pth")
    with pytest.raises(KeyError, match="dec_res_blk.0.norm_1.mlp_gamma.bias"):
        torch_import.import_torch_checkpoint(tmp_path / "G.pth",
                                             tmp_path / "D.pth", cfg, steps)
    d_sd.pop("enc_blk.0.conv_block.0.weight")
    with pytest.raises(KeyError, match="enc_blk.0.conv_block.0.weight"):
        torch_import.convert_defectgan_discriminator(d_sd, cfg)


def test_import_builds_d_and_ignores_unread_keys(tmp_path):
    """Steps that have not trained get their D; keys the mapping does not
    read are ignored, as in JAX."""
    _, _, cfg, steps = _case("sean", "plain")
    g_sd = reference_state_dict(steps.G, G_RULES, 1)
    d_sd = reference_state_dict(steps.D, D_RULES, 2)
    g_sd["some_module.extra.weight"] = torch.zeros(3)
    torch.save(g_sd, tmp_path / "G.pth")
    torch.save(d_sd, tmp_path / "D.pth")
    fresh = DefectGanSteps(cfg, TrainConfig(), device="cpu")
    assert fresh.D is None
    torch_import.import_torch_checkpoint(tmp_path / "G.pth", tmp_path / "D.pth",
                                         cfg, fresh)
    assert torch.equal(fresh.D.stem.conv.weight,
                       d_sd["enc_blk.0.conv_block.0.weight"])
    assert torch.equal(fresh.G.dec_0.norm.sean.mlp_latent.weight,
                       g_sd["dec_blk.0.norm.mlp_latent.0.weight"])
