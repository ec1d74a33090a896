"""``cli/translate_folder.py`` on the CPU: 3 PNGs at batch 2 (a padded
tail), SEAN and SPADE, from a checkpoint of weights carried from one JAX
init (``tests/test_torch_serving.py::defectgan``); the written PNGs agree
within 1 count with the JAX package's ``G.apply`` on the same
``EvalTransform`` inputs (float32). AdaIN, which needs a style code a folder
does not give, is refused. ``--spatial``: ``tests/test_torch_spatial_cli.py``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from de_i2i_gan_tpu.data.transforms import EvalTransform as JaxEvalTransform
from de_i2i_gan_torch.cli import translate_folder
from de_i2i_gan_torch.train.checkpoint import save_checkpoint
from de_i2i_gan_torch.utils.png import write_png
from tests.test_torch_serving import TINY, defectgan

torch.set_num_threads(1)

COUNT = 1  # u8 levels


def _argv(tmp_path, style, *extra):
    return ["--input_dir", str(tmp_path / "in"), "--output_dir",
            str(tmp_path / "out"), "--target_label", "2", "--name", "dg",
            "--ckpt_dir", str(tmp_path / "ckpt"), "--image_size", "32",
            "--label_nc", "4", "--ngf", "8", "--ndf", "8", "--num_res", "2",
            "--hidden_nc", "16", "--num_layers", "2", "--embed_nc", "12",
            "--num_embeds", "2", "--gpu_ids", "-1", "--compute_dtype",
            "float32", "--batch_size", "2", "--style_norm_block_type", style,
            *extra]


def _folder(root):
    """Three images of other sizes than the model's, names out of order."""
    rng = np.random.default_rng(0)
    root.mkdir(parents=True)
    for name, (h, w) in zip(("b.png", "a.png", "c.png"),
                            ((40, 48), (32, 32), (50, 36))):
        write_png(root / name, rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
    (root / "notes.txt").write_text("not an image")


@pytest.mark.parametrize("style", ["sean", "spade"])
def test_translate_folder_matches_jax(style, tmp_path):
    from PIL import Image
    jsteps, state, steps = defectgan(style)
    save_checkpoint(tmp_path / "ckpt", "dg", "latest", steps)
    _folder(tmp_path / "in")
    out = translate_folder.main(_argv(tmp_path, style))
    names = [p.name for p in out["written"]]
    assert names == ["a.png", "b.png", "c.png"]

    tf = JaxEvalTransform(TINY["image_size"])
    rng = np.random.default_rng(123)
    imgs = np.stack([tf(Image.open(tmp_path / "in" / n), rng) for n in names])
    labels = np.zeros((3, TINY["label_nc"]), np.float32)
    labels[:, 2] = 1.0
    ref, _ = jsteps.G.apply({"params": state.G.params, **state.G.state},
                            jnp.asarray(imgs), jnp.asarray(labels), None,
                            train=False, rngs={"noise": jax.random.PRNGKey(0)})
    want = np.clip((np.asarray(ref) + 1) * 127.5, 0, 255).astype(np.uint8)
    for name, w in zip(names, want):
        got = np.asarray(Image.open(tmp_path / "out" / name))
        assert got.shape == (32, 32, 3) and got.dtype == np.uint8
        assert np.abs(got.astype(int) - w.astype(int)).max() <= COUNT, name


def test_adain_needs_a_style(tmp_path):
    _folder(tmp_path / "in")
    with pytest.raises(ValueError, match="AdaIN needs a style code"):
        translate_folder.main(_argv(tmp_path, "adain"))
