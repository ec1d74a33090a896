"""The rest of ``utils/translate.py`` on the CPU: the SEAN alpha-control
and layer-split grids against the JAX package's on the same solver weights
(``tests/test_torch_starganv2.py``'s perturbed JAX init carried into the
port; tolerance 5e-4, DESIGN.md section 7, on grids in [0, 1]), the frame
counts of ``video_ref`` (31 frames a same-domain transition, none across
domains, the last held 10 more) and ``video_latent_walk``, and
``starganv2_main --mode sample --make_video``. Without ``ffmpeg`` the
videos are their frame directories; the tests hide any ``ffmpeg`` so that
they count frames.
"""
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from de_i2i_gan_tpu.utils import translate as jtranslate
from de_i2i_gan_torch.cli import starganv2_main as cli
from de_i2i_gan_torch.train.checkpoint import save_checkpoint
from de_i2i_gan_torch.train.jax_import import init_starganv2_weights
from de_i2i_gan_torch.train.solver import StarGANv2Solver
from de_i2i_gan_torch.utils import translate
from tests.test_torch_starganv2 import (
    CFG, EMBED, NUM_EMBEDS, domains, solvers)
from tests.test_torch_starganv2_train_fused import _image_tree

torch.set_num_threads(1)

TOL = 5e-4
N = 2
TRANSITION = 31  # _get_alphas: 0, 20 eased steps, 10 at 1
HOLD = 10


@pytest.fixture(autouse=True)
def no_ffmpeg(monkeypatch):
    monkeypatch.setattr(translate.shutil, "which", lambda _: None)


def _sources(seed):
    return np.random.default_rng(seed).uniform(
        -1, 1, (N, 64, 64, 3)).astype(np.float32)


def _stacks(seed, *shape):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


def test_alpha_control_matches_jax():
    jsolver, state, port = solvers("sean")
    x, y = _sources(1), domains(2, N)
    s_refs = _stacks(3, N, 2, NUM_EMBEDS, EMBED)
    ref = jtranslate.translate_with_alpha_control(
        jsolver, state, jnp.asarray(x), jnp.asarray(y), jnp.asarray(s_refs),
        steps=3)
    got = translate.translate_with_alpha_control(
        port, torch.from_numpy(x), torch.from_numpy(y.astype(np.int64)),
        torch.from_numpy(s_refs), steps=3)
    assert got.shape == ref.shape == (4 * 66 + 2, N * 66 + 2, 3)
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=TOL)
    # the rows differ as alpha moves from one reference to the other
    assert np.abs(got[68:132] - got[200:264]).max() > 1e-3


def test_layer_split_matches_jax():
    """The JAX package's ``translate_with_layer_split`` passes the split to
    its jitted generate as a traced argument, which its Generator cannot
    branch on; the reference grid is its un-jitted ``generate`` through the
    same ``make_grid``."""
    jsolver, state, port = solvers("sean")
    x, y = _sources(4), domains(5, N)
    s_pair = _stacks(6, N, 2, NUM_EMBEDS, EMBED)
    for split in ([0, 2], [1]):
        ref = jtranslate.make_grid(np.asarray(jsolver.generate(
            state, jnp.asarray(x), jnp.asarray(s_pair), jnp.asarray(y),
            layer_split_index=tuple(split))), nrow=N)
        got = translate.translate_with_layer_split(
            port, torch.from_numpy(x), torch.from_numpy(y.astype(np.int64)),
            torch.from_numpy(s_pair), split)
        assert got.shape == ref.shape == (68, N * 66 + 2, 3)
        np.testing.assert_allclose(got, ref, atol=TOL, rtol=TOL)


def test_alpha_control_needs_sean():
    _, _, port = solvers("adain")
    with pytest.raises(ValueError, match="sean"):
        translate.translate_with_alpha_control(
            port, torch.zeros(1, 64, 64, 3), torch.zeros(1, dtype=torch.int64),
            torch.zeros(1, 2, NUM_EMBEDS, EMBED))


@pytest.mark.parametrize("case", ["adain", "sean"])
def test_video_ref_frame_counts(case, tmp_path):
    """References of domains (1, 0, 0): the cross-domain step skipped, one
    same-domain transition, one frame a step of it plus the hold. A frame
    is [sliding reference | the source over its fake]."""
    _, _, port = solvers(case)
    x_ref = torch.from_numpy(np.concatenate([_sources(7), _sources(8)])[:3])
    y_ref = np.array([1, 0, 0])
    s_ref = (torch.from_numpy(_stacks(8, 3, NUM_EMBEDS, EMBED))
             if case == "sean" else None)
    src = torch.from_numpy(_sources(9)[:1])
    out = translate.video_ref(port, src, x_ref, y_ref, tmp_path / "v.mp4",
                              s_ref=s_ref)
    frames = sorted(out.glob("*.png"))
    assert out == tmp_path / "v_frames"
    assert len(frames) == TRANSITION + HOLD
    from PIL import Image
    first = np.asarray(Image.open(frames[0]))
    assert first.shape == (128, 64 + 32 + 64, 3)
    none = translate.video_ref(port, src,
                               x_ref[:2], np.array([0, 1]),
                               tmp_path / "w.mp4",
                               s_ref=None if s_ref is None else s_ref[:2])
    assert none is None and not (tmp_path / "w_frames").exists()


def test_video_latent_walk_frames(tmp_path):
    _, _, port = solvers("adain")
    out = translate.video_latent_walk(port, torch.from_numpy(_sources(10)), 1,
                                      CFG["latent_dim"], tmp_path / "walk.mp4",
                                      num_frames=5)
    frames = sorted(out.glob("*.png"))
    assert [f.name for f in frames] == [f"{i:04d}.png" for i in range(5)]


def test_sample_mode_make_video(tmp_path, capsys, monkeypatch):
    """--mode sample --make_video: the references sorted by domain (the
    first four of a batch of four over three domains), one transition per
    repeated domain, the frames beside the grids. A schedule of 3 alphas
    here (the full one above)."""
    monkeypatch.setattr(translate, "_get_alphas", lambda: [0.0, 0.5, 1.0])
    _image_tree(tmp_path / "tree", 2, per_domain=2)
    argv = ["--device", "cpu", "--img_size", "64", "--num_domains", "3",
            "--max_conv_dim", "64", "--style_dim", "8", "--latent_dim", "4",
            "--w_hpf", "0", "--val_batch_size", "4", "--num_workers", "1",
            "--compute_dtype", "float32", "--val_img_dir",
            str(tmp_path / "tree"), "--checkpoint_dir", str(tmp_path / "ckpt"),
            "--mode", "sample", "--resume_iter", "1", "--make_video",
            "--result_dir", str(tmp_path / "out")]
    solver = StarGANv2Solver(cli.to_config(cli.build_parser().parse_args(
        argv)), device="cpu")
    solver.init_training()
    init_starganv2_weights(solver, 3)
    save_checkpoint(tmp_path / "ckpt", "starganv2", "000001", solver)
    cli.main(argv)
    printed = capsys.readouterr().out
    assert re.search(r"video_ref -> \S+video_ref_frames", printed)
    frames = len(list((tmp_path / "out" / "video_ref_frames").glob("*.png")))
    # four references over three domains: at least one transition
    assert frames > HOLD and (frames - HOLD) % 3 == 0
    assert (tmp_path / "out" / "000001_cycle.png").exists()


def test_sample_mode_make_video_sean_skips(tmp_path, capsys):
    """SEAN's sample fetcher embeds no reference stacks: the video is
    skipped with the JAX CLI's line."""
    args = cli.build_parser().parse_args(["--norm_type", "sean",
                                          "--sample_dir", str(tmp_path)])
    assert cli.make_video(args, None, {"x_src": None}) is None
    assert "--make_video skipped" in capsys.readouterr().out
