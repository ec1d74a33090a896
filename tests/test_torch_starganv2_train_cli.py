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
* The frozen nets through the CLI at the tiny config: SEAN with a random
  tiny ViT and with ``--vit_path`` (an HF-keyed file the test writes),
  ``--mode update_stats``, ``--wing_ckpt`` at ``w_hpf 1`` and ``--mode
  align`` (a FAN checkpoint and mean landmarks the test writes).
* Every mode and flag not ported yet raises ``NotImplementedError`` naming
  its ROADMAP item.
"""
import re

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


UNPORTED = [(["--data_parallel", "on"], "A.9")]


# ----------------------------------------------- the frozen nets in the CLI
SEAN = ["--norm_type", "sean", "--embed_nc", "8", "--num_embeds", "2",
        "--hidden_nc", "16"]


def _iteration_losses(out):
    """{name: value} of the CLI's last ``Iteration`` line."""
    line = [ln for ln in out.splitlines() if ln.startswith("Iteration [")][-1]
    return {k: float(v) for k, v in re.findall(r"(\S+): \[([-\d.e]+)\]", line)}


def _tiny_vit_bin(path):
    """A tiny ViT's state dict under the HF key names (``vit.`` prefix)."""
    from de_i2i_gan_torch.models import vit
    net = vit.ViTEncoder("tiny", generator=torch.Generator().manual_seed(4))
    torch.save({f"vit.{k}": v for k, v in vit.hf_state_dict(net).items()},
               path)
    return path


@pytest.fixture
def tiny_vit(monkeypatch):
    monkeypatch.setattr(cli, "VIT_MODEL_SIZE", "tiny")


def test_cli_sean_train_with_a_random_vit(tmp_path, tiny_vit, capsys):
    """--norm_type sean (once unported): the SEAN fetcher embeds the stacks
    with a random tiny ViT cut to --embed_nc; lambda_sty is inactive, so it
    needs --allow_degraded_losses."""
    _image_tree(tmp_path / "tree", 3, per_domain=2)
    argv = _argv(tmp_path, *SEAN, "--total_iters", "1", "--save_every",
                 "100", "--sample_every", "1")
    with pytest.raises(ValueError, match="allow_degraded_losses"):
        cli.main(argv)
    solver = cli.main(argv + ["--allow_degraded_losses"])
    assert solver.step == 1 and solver.vit is None
    losses = _iteration_losses(capsys.readouterr().out)
    assert losses["G/ref_sty"] == 0.0 and "G/latent_adv" not in losses
    assert (tmp_path / "samples" / "000001_cycle.png").exists()


def test_cli_sean_train_with_vit_path(tmp_path, tiny_vit, capsys):
    """--vit_path (once unported): the HF-keyed weights feed the fetcher and
    the G loss, whose style term is live; --embed_nc must match its width."""
    _image_tree(tmp_path / "tree", 3, per_domain=2)
    vit_bin = _tiny_vit_bin(tmp_path / "vit.bin")
    argv = _argv(tmp_path, *SEAN, "--vit_path", str(vit_bin),
                 "--total_iters", "1", "--save_every", "100",
                 "--sample_every", "100")
    with pytest.raises(SystemExit, match="must match"):
        cli.main(argv)
    solver = cli.main(argv + ["--embed_nc", "16"])
    assert solver.vit is not None and solver.vit.dtype == torch.float32
    assert _iteration_losses(capsys.readouterr().out)["G/ref_sty"] > 0


def test_cli_update_stats(tmp_path, tiny_vit):
    """--mode update_stats (once unported): the EMA generator tracks SEAN
    styles until each domain has --num_stats_samples, then the finalized
    statistics go to the ``stats_updated`` checkpoint."""
    _image_tree(tmp_path / "tree", 3, per_domain=2)
    solver = cli.main(_argv(tmp_path, *SEAN, "--mode", "update_stats",
                            "--num_stats_samples", "2"))
    saved = checkpoint.read_checkpoint(tmp_path / "ckpt", "starganv2",
                                       "stats_updated")
    stats = {k: v for k, v in saved["ema_G"].items()
             if k.endswith((".mean", ".std"))}
    # finalized: the accumulators folded into each domain's mean and std
    assert stats and all(torch.isfinite(v).all() and (v != 0).all(dim=-1).all()
                         for v in stats.values())
    assert solver.step == 0


def _wing_ckpt(path):
    from de_i2i_gan_torch.models import wing
    torch.save({"state_dict": wing.wing_state_dict(wing.make_fan("cpu", 2))},
               path)
    return path


def test_cli_train_with_wing_ckpt(tmp_path, monkeypatch):
    """--wing_ckpt (once unported): at w_hpf 1 every training iteration takes
    the FAN's masks of x_src and of each pass's x_fake."""
    from de_i2i_gan_torch.models import wing
    _image_tree(tmp_path / "tree", 3, per_domain=2)
    seen, real = [], wing.fan_masks

    def counted(fan, x):
        seen.append(tuple(x.shape))
        return real(fan, x)

    monkeypatch.setattr(wing, "fan_masks", counted)
    argv = _argv(tmp_path, "--total_iters", "1", "--save_every", "100",
                 "--sample_every", "100", "--wing_ckpt",
                 str(_wing_ckpt(tmp_path / "wing.ckpt")))
    argv[argv.index("--w_hpf") + 1] = "1"
    solver = cli.main(argv)
    assert solver.fan is not None and solver.step == 1
    assert seen == [(BATCH, IMG, IMG, 3)] * 3


def test_cli_align(tmp_path):
    """--mode align (once unported): FAN landmarks (a checkpoint written by
    the test), the warp to mean landmarks from --lm_path, PNGs out."""
    from PIL import Image
    rng = np.random.default_rng(5)
    (tmp_path / "faces").mkdir()
    for i in range(2):
        Image.fromarray(rng.integers(0, 256, (80, 96, 3), dtype=np.uint8)
                        ).save(tmp_path / "faces" / f"f{i}.jpg")
    np.savez(tmp_path / "lm.npz",
             mean=rng.uniform(60, 200, (98, 2)).astype(np.float32))
    written = cli.main(["--mode", "align", "--device", "cpu", "--img_size",
                        "256", "--inp_dir", str(tmp_path / "faces"),
                        "--out_dir", str(tmp_path / "out"), "--lm_path",
                        str(tmp_path / "lm.npz"), "--wing_ckpt",
                        str(_wing_ckpt(tmp_path / "wing.ckpt"))])
    assert [p.name for p in written] == ["f0.png", "f1.png"]
    for p in written:
        img = np.asarray(Image.open(p))
        assert img.shape == (256, 256, 3) and img.std() > 0


@pytest.mark.parametrize("flags,item", UNPORTED,
                         ids=[" ".join(f) for f, _ in UNPORTED])
def test_unported_modes_and_flags_raise(flags, item, tmp_path):
    with pytest.raises(NotImplementedError, match=rf"ROADMAP {item}"):
        cli.main(_argv(tmp_path, *flags))


def test_eval_every_raises_when_it_fires(tmp_path, monkeypatch):
    """--eval_every (it raised while the metrics were not ported): it fires
    after the iteration it divides, with the solver and the step (the
    evaluation itself: tests/test_torch_metrics_cli.py)."""
    from de_i2i_gan_torch.metrics import eval_starganv2
    fired = []
    monkeypatch.setattr(eval_starganv2, "evaluate_all_tasks",
                        lambda solver, args, step=None: fired.append(
                            (solver.step, step)))
    _image_tree(tmp_path / "tree", 3, per_domain=2)
    cli.main(_argv(tmp_path, "--total_iters", "1", "--eval_every", "1",
                   "--save_every", "100", "--sample_every", "100"))
    assert fired == [(1, 1)]