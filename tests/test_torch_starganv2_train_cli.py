"""The StarGAN v2 CLI (``cli/starganv2_main.py``) and its sample grids
(``utils/translate.py``) on the CPU.

* ``translate_using_latent``, ``translate_using_reference`` and
  ``debug_image`` against the JAX package's from one converted
  ``SolverState`` (the tiny config of ``tests/test_torch_starganv2_train.py``,
  float32): grids within the forward tolerance 5e-4; the debug PNGs pixel
  for pixel within 1 of 255 (a float32 difference near a rounding boundary
  of the uint8 cast), 99% of them equal.
* ``--mode train`` with ``--device cpu`` for 2 iterations on an image tree
  of 3 domains (checkpoints ``000002`` and ``latest``, one debug grid), a
  resume with ``--resume_iter 2`` whose loaded state equals the saved one
  tensor for tensor, then ``--mode sample`` from it: the cycle grid and
  ``latent_grid.png`` at their sizes.
* Every mode and flag not ported yet raises ``NotImplementedError`` naming
  its ROADMAP item.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from de_i2i_gan_tpu.utils import translate as jtranslate
from de_i2i_gan_torch.cli import starganv2_main as cli
from de_i2i_gan_torch.train import checkpoint
from de_i2i_gan_torch.utils import translate
from tests.test_torch_starganv2_train import (
    BATCH, DOMAINS, IMG, LATENT, TOL, JaxConfig, JaxSolver, config,
    make_batch, perturbed_state, port_solver)
from tests.test_torch_starganv2_train_fused import _flat, _image_tree

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def solvers():
    kw = config("adain")
    jsolver = JaxSolver(JaxConfig(**kw))
    state = perturbed_state(jsolver, 0)
    return jsolver, state, port_solver(kw, state)


def test_translate_using_latent_matches_jax(solvers):
    jsolver, state, port = solvers
    x = make_batch(12)["x_src"]
    z_list = [np.random.default_rng(i).standard_normal(LATENT).astype(
        np.float32) for i in range(2)]
    ref = jtranslate.translate_using_latent(
        jsolver, state, jnp.asarray(x), list(range(DOMAINS)),
        [jnp.asarray(z) for z in z_list])
    got = translate.translate_using_latent(port, torch.from_numpy(x),
                                           list(range(DOMAINS)), z_list)
    assert got.shape == ref.shape == (7 * (IMG + 2) + 2, BATCH * (IMG + 2) + 2, 3)
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=TOL)


def test_translate_using_reference_matches_jax(solvers):
    jsolver, state, port = solvers
    b = make_batch(13, n=3)
    ref = jtranslate.translate_using_reference(
        jsolver, state, jnp.asarray(b["x_src"][:2]), jnp.asarray(b["x_ref"]),
        b["y_ref"])
    got = translate.translate_using_reference(
        port, torch.from_numpy(b["x_src"][:2]), torch.from_numpy(b["x_ref"]),
        torch.from_numpy(b["y_ref"]))
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=TOL)


def test_debug_image_matches_jax(solvers, tmp_path):
    from PIL import Image
    jsolver, state, port = solvers
    b = make_batch(14)
    jtranslate.debug_image(jsolver, state, b, 5, tmp_path / "jax")
    path = translate.debug_image(port, {k: torch.from_numpy(v)
                                        for k, v in b.items()}, 5,
                                 tmp_path / "torch")
    assert path.name == "000005_cycle.png"
    ref, got = (np.asarray(Image.open(tmp_path / pkg / "000005_cycle.png")
                           ).astype(int) for pkg in ("jax", "torch"))
    assert got.shape == ref.shape == (4 * (IMG + 2) + 2, BATCH * (IMG + 2) + 2, 3)
    assert np.abs(got - ref).max() <= 1 and (got == ref).mean() > 0.99


# ------------------------------------------------------------------ the CLI


def _argv(tmp_path, *extra):
    tree = tmp_path / "tree"
    return ["--device", "cpu", "--img_size", str(IMG), "--num_domains",
            str(DOMAINS), "--max_conv_dim", "64", "--style_dim", "8",
            "--latent_dim", str(LATENT), "--w_hpf", "0", "--batch_size", "2",
            "--val_batch_size", "2", "--num_workers", "1",
            "--compute_dtype", "float32", "--lambda_ds", "2",
            "--train_img_dir", str(tree), "--val_img_dir", str(tree),
            "--checkpoint_dir", str(tmp_path / "ckpt"), "--sample_dir",
            str(tmp_path / "samples"), "--print_every", "1", *extra]


def test_cli_train_resume_then_sample(tmp_path, monkeypatch, capsys):
    _image_tree(tmp_path / "tree", 2, per_domain=3)
    solver = cli.main(_argv(tmp_path, "--total_iters", "2", "--save_every",
                            "2", "--sample_every", "2"))
    assert solver.device.type == "cpu" and solver.step == 2
    assert solver.tx_G.count == solver.tx_D.count == 4
    assert solver.tx_M.count == solver.tx_S.count == 2
    run = tmp_path / "ckpt" / "starganv2"
    assert sorted(p.name for p in run.iterdir()) == [
        "000002_state.pt", "latest_state.pt"]
    assert (tmp_path / "samples" / "000002_cycle.png").exists()
    out = capsys.readouterr().out
    assert "Iteration [2/2]" in out and "G/latent_cyc" in out

    # the resume: the state the loop starts from is the saved one
    loaded = []
    real_train = cli.train

    def spy(args, solver_):
        loaded.append(checkpoint.clone_state(checkpoint.train_state(solver_)))
        real_train(args, solver_)

    monkeypatch.setattr(cli, "train", spy)
    resumed = cli.main(_argv(tmp_path, "--resume_iter", "2", "--total_iters",
                             "3", "--save_every", "100", "--sample_every",
                             "100"))
    saved = checkpoint.read_checkpoint(tmp_path / "ckpt", "starganv2",
                                       "000002")
    flat_s, flat_l = _flat(saved), _flat(loaded[0])
    assert flat_s.keys() == flat_l.keys()
    for k, v in flat_s.items():
        assert (torch.equal(v, flat_l[k]) if isinstance(v, torch.Tensor)
                else v == flat_l[k]), k
    assert resumed.step == 3 and resumed.tx_M.count == 3
    assert checkpoint.read_checkpoint(tmp_path / "ckpt", "starganv2",
                                      "latest")["step"] == 3

    cli.main(_argv(tmp_path, "--mode", "sample", "--resume_iter", "2",
                   "--result_dir", str(tmp_path / "out")))
    from PIL import Image
    cycle = np.asarray(Image.open(tmp_path / "out" / "000002_cycle.png"))
    latent = np.asarray(Image.open(tmp_path / "out" / "latent_grid.png"))
    assert cycle.shape == (4 * (IMG + 2) + 2, 2 * (IMG + 2) + 2, 3)
    # the sources, then 3 latents for each of the 3 domains
    assert latent.shape == (10 * (IMG + 2) + 2, 2 * (IMG + 2) + 2, 3)
    assert cycle.std() > 0 and latent.std() > 0


UNPORTED = [(["--mode", "eval"], "A.8"),
            (["--mode", "update_stats"], "A.7"), (["--mode", "align"], "A.7"),
            (["--norm_type", "sean"], "A.7"),
            (["--vit_path", "x"], "A.7"), (["--wing_ckpt", "x"], "A.7"),
            (["--make_video"], "A.9"), (["--data_parallel", "on"], "A.9")]


@pytest.mark.parametrize("flags,item", UNPORTED,
                         ids=[" ".join(f) for f, _ in UNPORTED])
def test_unported_modes_and_flags_raise(flags, item, tmp_path):
    with pytest.raises(NotImplementedError, match=rf"ROADMAP {item}"):
        cli.main(_argv(tmp_path, *flags))


def test_eval_every_raises_when_it_fires(tmp_path):
    _image_tree(tmp_path / "tree", 3, per_domain=2)
    with pytest.raises(NotImplementedError, match=r"ROADMAP A\.8"):
        cli.main(_argv(tmp_path, "--total_iters", "1", "--eval_every", "1",
                       "--save_every", "100", "--sample_every", "100"))
