"""``cli/translate_folder.py --spatial`` on CPU ranks over gloo
(``--gpu_ids -1 --num_devices N``: the CLI spawns the ranks itself).

Three PNGs at batch 2 (a padded tail batch), SEAN and SPADE, with and
without ``--add_noise``, on two ranks (``--spatial 2``) and on four (two
data groups of two bands): rank 0's PNGs agree within 1 count with the JAX
package's unsharded ``G.apply`` on the same checkpoint and the same
``EvalTransform`` inputs, batch by batch (float32; the bound of
``tests/test_torch_translate_folder.py``). With noise the JAX package draws
from the torch generator the CLI seeds with 0 (``jax.random.normal``
patched), in the CLI's order, so both see the same noise; the noise weights
are moved off zero. Refused: fewer devices than ``--spatial``, a device
count it does not divide, an image height that does not split, AdaIN.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from de_i2i_gan_tpu.config import DefectGanConfig as JaxConfig
from de_i2i_gan_tpu.config import TrainConfig as JaxTrainConfig
from de_i2i_gan_tpu.data.transforms import EvalTransform as JaxEvalTransform
from de_i2i_gan_tpu.train.steps import DefectGanSteps as JaxSteps
from de_i2i_gan_torch.cli import translate_folder
from de_i2i_gan_torch.config import DefectGanConfig, TrainConfig
from de_i2i_gan_torch.train.checkpoint import save_checkpoint
from de_i2i_gan_torch.train.jax_import import load_jax_generator
from de_i2i_gan_torch.train.steps import DefectGanSteps
from de_i2i_gan_torch.utils.png import write_png
from tests.test_torch_serving import TINY, perturb

torch.set_num_threads(1)

COUNT = 1  # u8 levels
BATCH = 2
NAMES = ["a.png", "b.png", "c.png"]
NOISE_WEIGHT = 0.5


@functools.lru_cache(maxsize=None)
def _defectgan(style, add_noise):
    """(jax steps, jax variables, port steps) from one JAX init, biases,
    scales, statistics and noise weights off their init values."""
    cfg = dict(TINY, style_norm_block_type=style, add_noise=add_noise)
    jsteps = JaxSteps(JaxConfig(**cfg), JaxTrainConfig())
    state = jsteps.init_state(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    params = perturb(jax.device_get(state.G.params), rng)
    for name, block in params.items():
        for key in block:
            if key.startswith("noise"):
                block[key]["weight"] = np.full((1,), NOISE_WEIGHT, np.float32)
    g_state = perturb(jax.device_get(state.G.state), rng)
    steps = DefectGanSteps(DefectGanConfig(**cfg), TrainConfig(), device="cpu")
    load_jax_generator(steps, params, g_state, None)
    return jsteps, {"params": params, **g_state}, steps


def _argv(tmp_path, style, *extra):
    return ["--input_dir", str(tmp_path / "in"), "--output_dir",
            str(tmp_path / "out"), "--target_label", "2", "--name", "dg",
            "--ckpt_dir", str(tmp_path / "ckpt"), "--image_size", "32",
            "--label_nc", "4", "--ngf", "8", "--ndf", "8", "--num_res", "2",
            "--hidden_nc", "16", "--num_layers", "2", "--embed_nc", "12",
            "--num_embeds", "2", "--gpu_ids", "-1", "--compute_dtype",
            "float32", "--batch_size", str(BATCH), "--style_norm_block_type",
            style, *extra]


def _folder(root):
    """Three images of other sizes than the model's, names out of order."""
    rng = np.random.default_rng(0)
    root.mkdir(parents=True)
    for name, (h, w) in zip(("b.png", "a.png", "c.png"),
                            ((40, 48), (32, 32), (50, 36))):
        write_png(root / name, rng.integers(0, 256, (h, w, 3), dtype=np.uint8))


def _jax_pngs(tmp_path, style, add_noise, monkeypatch):
    """The JAX package's unsharded G over the folder in the CLI's batches
    (the tail padded with zeros), its noise the CLI's torch stream."""
    from PIL import Image
    jsteps, variables, _ = _defectgan(style, add_noise)
    gen = torch.Generator().manual_seed(0)
    monkeypatch.setattr(
        jax.random, "normal",
        lambda key, shape, dtype=jnp.float32: jnp.asarray(
            torch.randn(shape, generator=gen).numpy(), dtype))
    tf = JaxEvalTransform(TINY["image_size"])
    rng = np.random.default_rng(123)  # the CLI's default --seed
    imgs = np.stack([tf(Image.open(tmp_path / "in" / n), rng) for n in NAMES])
    imgs = np.concatenate([imgs, np.zeros((1, *imgs.shape[1:]), imgs.dtype)])
    labels = np.zeros((BATCH, TINY["label_nc"]), np.float32)
    labels[:, 2] = 1.0
    out = []
    for i in range(0, len(imgs), BATCH):
        ref, _ = jsteps.G.apply(variables, jnp.asarray(imgs[i:i + BATCH]),
                                jnp.asarray(labels), None, train=False,
                                rngs={"noise": jax.random.PRNGKey(0)})
        out.append(np.asarray(ref))
    want = np.concatenate(out)[:len(NAMES)]
    return np.clip((want + 1) * 127.5, 0, 255).astype(np.uint8)


def _check_against_jax(tmp_path, style, add_noise, monkeypatch, *extra):
    from PIL import Image
    _, _, steps = _defectgan(style, add_noise)
    save_checkpoint(tmp_path / "ckpt", "dg", "latest", steps)
    _folder(tmp_path / "in")
    noise = ["--add_noise"] if add_noise else []
    out = translate_folder.main(_argv(tmp_path, style, *noise, *extra))
    assert [p.name for p in out["written"]] == NAMES
    want = _jax_pngs(tmp_path, style, add_noise, monkeypatch)
    for name, w in zip(NAMES, want):
        got = np.asarray(Image.open(tmp_path / "out" / name))
        assert got.shape == (32, 32, 3) and got.dtype == np.uint8
        assert np.abs(got.astype(int) - w.astype(int)).max() <= COUNT, name


@pytest.mark.parametrize("add_noise", [False, True], ids=["plain", "noise"])
@pytest.mark.parametrize("style", ["sean", "spade"])
def test_spatial_two_ranks_match_jax(style, add_noise, tmp_path, monkeypatch):
    _check_against_jax(tmp_path, style, add_noise, monkeypatch,
                       "--spatial", "2", "--num_devices", "2")


def test_spatial_two_by_two_matches_jax(tmp_path, monkeypatch):
    """Four ranks: two data groups of one image each, two bands each; the
    second batch's second image is padding."""
    _check_against_jax(tmp_path, "sean", True, monkeypatch,
                       "--spatial", "2", "--num_devices", "4")


@pytest.mark.parametrize("extra,error,match", [
    (["--spatial", "2"], ValueError, "needs a multiple of 2 devices, got 1"),
    (["--spatial", "2", "--num_devices", "3"], ValueError,
     "needs a multiple of 2 devices, got 3"),
    (["--spatial", "2", "--num_devices", "2", "--image_size", "36"],
     ValueError, "image height 36 is not divisible by --spatial 2"),
    (["--spatial", "4", "--num_devices", "4", "--image_size", "16"],
     ValueError, "bands of 1 rows"),
], ids=["one_device", "three_devices", "height", "thin_bands"])
def test_spatial_refusals(extra, error, match, tmp_path):
    with pytest.raises(error, match=match):
        translate_folder.main(_argv(tmp_path, "sean", *extra))


def test_spatial_adain_still_needs_a_style(tmp_path):
    with pytest.raises(ValueError, match="AdaIN needs a style code"):
        translate_folder.main(_argv(tmp_path, "adain", "--spatial", "2",
                                    "--num_devices", "2"))
