"""The port's DefectGAN trainer, its JAX continuation, the NaN guard and the
CLIs, on the CPU at the tiny size.

(a) ``DefectGanTrainer`` in both packages: one epoch of 3 super-steps (2
    critics, batch 2, SGD) from one converted JAX state over the same
    synthetic loaders, AdaIN and SPADE. G's and D's deltas (after - before)
    / lr agree per tensor within 1e-3 of the tensor's L2 norm plus 1e-5 per
    element in L2 (the band of the card-vs-CPU super-step in
    ``tests/test_torch_kernel_gpu.py``: three super-steps carry a near-tie
    of a ReLU gate or an L1 term further than one does); the BatchNorm
    statistics within 1e-4 (``tests/test_torch_train_step.py``); ``iter.txt``
    and the checkpoint tags are the same.
(b) A JAX checkpoint taken after one Adam super-step, read back with flax,
    is converted with its Adam moments and update counts; one more
    super-step lands where JAX's continuation lands: parameters within
    1e-6 where the gradient is above 1e-6 (as the Adam test of
    ``tests/test_torch_train_step.py``), the moments within 1e-6 + 1e-3
    relative.
(c) The NaN guard rolls the steps back to its snapshot and aborts after
    ``max_strikes`` consecutive failures, as ``tests/test_guards.py``
    shows for the JAX guard; the trainer's rollback leaves the state of the
    last clean window.
(d) The CLIs with ``--gpu_ids -1``: train, resume, then test with grids and
    ``--cal_clf``; every flag not yet ported raises ``NotImplementedError``;
    the test CLI's grids against the JAX test CLI's from one converted
    checkpoint.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from de_i2i_gan_tpu.config import DefectGanConfig as JaxConfig
from de_i2i_gan_tpu.config import TrainConfig as JaxTrainConfig
from de_i2i_gan_tpu.data import pipeline as jpipeline
from de_i2i_gan_tpu.data.synthetic import SyntheticDefectDataset as JaxSynthetic
from de_i2i_gan_tpu.train import checkpoint as jcheckpoint
from de_i2i_gan_tpu.train.steps import DefectGanSteps as JaxSteps
from de_i2i_gan_tpu.train.trainer import DefectGanTrainer as JaxTrainer
from de_i2i_gan_torch.cli import test_defectgan, train_defectgan
from de_i2i_gan_torch.config import DefectGanConfig, TrainConfig
from de_i2i_gan_torch.data import pipeline
from de_i2i_gan_torch.data.synthetic import SyntheticDefectDataset
from de_i2i_gan_torch.train.checkpoint import read_checkpoint, train_state
from de_i2i_gan_torch.train.jax_import import (
    _flatten, _targets, init_weights, load_jax_train_state)
from de_i2i_gan_torch.train import trainer as trainer_module
from de_i2i_gan_torch.train.steps import DefectGanSteps
from de_i2i_gan_torch.train.trainer import DefectGanTrainer
from de_i2i_gan_torch.utils.guards import NaNGuard, metrics_finite
from tests.test_torch_train_step import _batches, _params, _trees, perturb

torch.set_num_threads(1)

TINY = dict(image_size=32, label_nc=4, ngf=8, ndf=8, num_res=2, hidden_nc=16,
            num_layers=2, use_pallas=True)
CRITICS, BATCH, SUPER_STEPS = 2, 2, 3
SGD = dict(batch_size=BATCH, num_critics=CRITICS, lr=(2e-2, 1e-2),
           optimizer="sgd")
ADAM = dict(batch_size=BATCH, num_critics=CRITICS, lr=(2e-4, 1e-4))
REL_L2, ATOL = 1e-3, 1e-5
STATS_TOL = 1e-4
ADAM_ATOL = 1e-6
# a seed without near-ties: with data seed 3 an L1 term of SPADE's sd_cyc,
# between two nearly equal probability maps, takes the other sign of its
# gradient in one package and moves a BN bias's delta by 1.5% in the first
# super-step (seed-sensitive, as ``tests/test_torch_train_step.py`` notes)
SEED = 2


def _dual(pkg, synthetic, seed):
    n = CRITICS * BATCH * SUPER_STEPS
    df = pkg.DataLoader(synthetic(32, 4, n, "defects", seed=seed), BATCH,
                        seed=seed)
    bg = pkg.DataLoader(synthetic(32, 4, n, "background", seed=seed), BATCH,
                        seed=seed + 1)
    return pkg.DualStreamLoader(df, bg, CRITICS)


def _perturbed_state(state, seed):
    rng = np.random.default_rng(seed)
    g_state = jax.device_get(state.G.state)
    state = state.replace(
        G=state.G.replace(
            params=perturb(jax.device_get(state.G.params), rng),
            state={**g_state, "batch_stats": perturb(g_state["batch_stats"],
                                                     rng)}),
        D=state.D.replace(params=perturb(jax.device_get(state.D.params), rng)))
    if state.E is not None:
        state = state.replace(E=state.E.replace(
            params=perturb(jax.device_get(state.E.params), rng)))
    return state


def _trainers(style, tmp_path, seed=0):
    cfg_kw = dict(TINY, style_norm_block_type=style)
    common = dict(name="run", log_dir=None,
                  iters_per_epoch=SUPER_STEPS * CRITICS, num_epochs=1,
                  save_latest_freq=4, save_ckpt_freq=1, seed=seed)
    jtr = JaxTrainer(JaxConfig(**cfg_kw), JaxTrainConfig(**SGD),
                     ckpt_dir=tmp_path / "jax", **common)
    jtr.state = _perturbed_state(jtr.state, seed)
    tr = DefectGanTrainer(DefectGanConfig(**cfg_kw), TrainConfig(**SGD),
                          ckpt_dir=tmp_path / "torch", device="cpu", **common)
    load_jax_train_state(tr.steps, **_trees(jtr.state))
    return jtr, tr


@pytest.fixture(scope="module", params=["adain", "spade"])
def trained(request, tmp_path_factory):
    tmp_path = tmp_path_factory.mktemp(request.param)
    jtr, tr = _trainers(request.param, tmp_path, seed=SEED)
    before = jax.device_get(jtr.state)
    jtr.train(_dual(jpipeline, JaxSynthetic, SEED), progress=False)
    tr.train(_dual(pipeline, SyntheticDefectDataset, SEED), progress=False)
    return tmp_path, before, jtr, tr


def test_trainer_deltas_match_jax(trained):
    _, before, jtr, tr = trained
    for net, lr in (("G", tr.tcfg.lr_g), ("D", tr.tcfg.lr_d)):
        module = getattr(tr.steps, net)
        start = _params(module, getattr(before, net).params)
        moved = 0
        for key, (tensor, ref_after) in _params(
                module, getattr(jtr.state, net).params).items():
            s = start[key][1]
            got = (tensor.detach().numpy() - s) / lr
            ref = (ref_after - s) / lr
            err = np.linalg.norm(got - ref)
            assert err <= REL_L2 * np.linalg.norm(ref) + ATOL * math.sqrt(
                ref.size), f"{net} {key}: {err:.3e} vs |ref| {np.linalg.norm(ref):.3e}"
            moved += np.count_nonzero(ref)
        assert moved > 0.8 * sum(t.numel() for t in module.parameters())
    flat = _flatten(jax.device_get(jtr.state.G.state["batch_stats"]))
    for key, tensor, coll, path, _ in _targets(tr.steps.G):
        if coll == "batch_stats":
            np.testing.assert_allclose(tensor.numpy(), flat[path],
                                       atol=STATS_TOL, rtol=STATS_TOL,
                                       err_msg=key)
    assert tr.steps.step == int(jtr.state.step) == CRITICS * SUPER_STEPS
    assert tr.iters == jtr.iters == CRITICS * SUPER_STEPS


def test_trainer_checkpoints_match_jax(trained):
    tmp_path, _, jtr, tr = trained
    j, t = tmp_path / "jax" / "run", tmp_path / "torch" / "run"
    assert (t / "iter.txt").read_text() == (j / "iter.txt").read_text() == "1,6\n"
    assert sorted(p.name.split("_state")[0] for p in t.glob("*_state.pt")) == \
        sorted(p.name.split("_state")[0] for p in j.glob("*_state.msgpack")) == \
        ["1", "latest"]
    saved = read_checkpoint(tmp_path / "torch", "run", "latest")
    assert saved["step"] == tr.steps.step and saved["tx_G"]["count"] == 3
    for k, v in tr.steps.G.state_dict().items():
        assert torch.equal(saved["G"][k], v), k


def test_generate_grid_matches_jax(trained):
    """The trained generators' label grids, forward tolerance 5e-4
    (DESIGN.md section 7)."""
    _, _, jtr, tr = trained
    rng = np.random.default_rng(0)
    bg = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    labels = np.eye(4, dtype=np.float32)[1:]
    jout, jprob = jtr.generate_grid(jnp.asarray(bg), jnp.asarray(labels))
    out, prob = tr.generate_grid(torch.from_numpy(bg), torch.from_numpy(labels))
    assert out.shape == (2, 3, 32, 32, 3) and prob.shape == (2, 3, 32, 32, 1)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=5e-4,
                               rtol=5e-4)
    np.testing.assert_allclose(prob.numpy(), np.asarray(jprob), atol=5e-4,
                               rtol=5e-4)


def test_jax_checkpoint_continues_with_its_adam_moments(tmp_path):
    """Adam state from a JAX checkpoint, read with flax: the next update is
    JAX's next update."""
    cfg_kw = dict(TINY, style_norm_block_type="adain")
    jsteps = JaxSteps(JaxConfig(**cfg_kw), JaxTrainConfig(**ADAM))
    state0 = _perturbed_state(jsteps.init_state(jax.random.PRNGKey(0)), 0)
    step = jax.jit(jsteps.super_step)
    b0, b1 = (_batches(seed) for seed in (0, 1))
    state1, _ = step(state0, {k: jnp.asarray(v) for k, v in b0.items()},
                     jax.random.PRNGKey(1))
    jcheckpoint.save_checkpoint(tmp_path, "j", "latest", state1, epoch=1,
                                iters=2)
    loaded = jcheckpoint.load_checkpoint(
        tmp_path, "j", "latest", jsteps.init_state(jax.random.PRNGKey(9)))
    get = jax.device_get
    steps = DefectGanSteps(DefectGanConfig(**cfg_kw), TrainConfig(**ADAM),
                           device="cpu")
    load_jax_train_state(steps, **_trees(loaded),
                         g_opt_state=get(loaded.G.opt_state),
                         d_opt_state=get(loaded.D.opt_state),
                         e_opt_state=get(loaded.E.opt_state))
    assert (steps.tx_G.count, steps.tx_E.count, steps.tx_D.count) == (1, 1, 2)
    for p in steps.tx_D.params:
        assert steps.tx_D.opt.state[p]["step"].item() == 2

    state2, _ = step(loaded, {k: jnp.asarray(v) for k, v in b1.items()},
                     jax.random.PRNGKey(2))
    steps.super_step({k: torch.from_numpy(v) for k, v in b1.items()})
    for net in ("G", "E", "D"):
        module = getattr(steps, net)
        adam = getattr(state2, net).opt_state[0]
        assert getattr(steps, f"tx_{net}").count == int(adam.count)
        # where the last update's gradient is live (Adam moves a weight by
        # about lr * sign(g) when g is rounding noise)
        mu, nu = (_params(module, getattr(adam, m)) for m in ("mu", "nu"))
        prev = _params(module, getattr(loaded, net).opt_state[0].mu)
        checked = 0
        for key, (tensor, ref) in _params(module, getattr(state2, net).params).items():
            g = (mu[key][1] - 0.5 * prev[key][1]) / 0.5
            live = np.abs(g) > 1e-6
            np.testing.assert_allclose(tensor.detach().numpy()[live], ref[live],
                                       rtol=0, atol=ADAM_ATOL,
                                       err_msg=f"{net} {key}")
            st = getattr(steps, f"tx_{net}").opt.state
            np.testing.assert_allclose(st[tensor]["exp_avg"].numpy(),
                                       mu[key][1], rtol=1e-3, atol=1e-6)
            np.testing.assert_allclose(st[tensor]["exp_avg_sq"].numpy(),
                                       nu[key][1], rtol=1e-3, atol=1e-6)
            checked += live.sum()
        assert checked > 0.8 * sum(t.numel() for t in module.parameters())


# ---------------------------------------------------------------- (c) guard
def _tiny_steps():
    steps = DefectGanSteps(DefectGanConfig(**TINY, style_norm_block_type="adain"),
                           TrainConfig(**ADAM), device="cpu")
    steps.init_training()
    init_weights(steps, 0)
    return steps


def _poison(steps):
    with torch.no_grad():
        for p in steps.G.parameters():
            p.fill_(7.0)
    steps.step += 5
    steps.tx_G.count += 1


def test_nan_guard_rollback_and_abort():
    assert metrics_finite({"a": torch.tensor(1.0), "b": 2.0})
    assert not metrics_finite({"a": torch.tensor(float("nan"))})
    assert not metrics_finite({"a": 1.0, "b": float("inf")})
    guard = NaNGuard(snapshot_every=1, max_strikes=2)
    steps = _tiny_steps()
    good = {k: v.clone() for k, v in steps.G.state_dict().items()}
    assert guard.update(steps, {"loss": 1.0})

    # a poisoned step rolls back to the snapshot: weights, counts, step
    _poison(steps)
    assert not guard.update(steps, {"loss": float("nan")})
    for k, v in steps.G.state_dict().items():
        assert torch.equal(v, good[k]), k
    assert (steps.step, steps.tx_G.count, guard.restores) == (0, 0, 1)

    # recovery resets the strike counter; the snapshot survives a rollback
    assert guard.update(steps, {"loss": 0.5})
    _poison(steps)
    assert not guard.update(steps, {"loss": float("nan")})
    assert torch.equal(steps.G.stem.conv.weight, good["stem.conv.weight"])
    with pytest.raises(FloatingPointError, match="2 consecutive"):
        guard.update(steps, {"loss": float("nan")})


def test_trainer_rolls_back_a_poisoned_window(tmp_path):
    """Epoch 1 is clean (its metrics drain leaves a snapshot); a super-step
    of epoch 2 poisons G and reports NaN, so the drain of epoch 2 restores
    the state at the end of epoch 1."""
    cfg = DefectGanConfig(**TINY, style_norm_block_type="adain")
    tr = DefectGanTrainer(cfg, TrainConfig(**SGD), name="nan",
                          ckpt_dir=tmp_path, log_dir=None,
                          iters_per_epoch=SUPER_STEPS * CRITICS, num_epochs=2,
                          save_ckpt_freq=1, device="cpu")
    real, calls = tr.steps.super_step, []

    def super_step(batch, generator=None):
        metrics = real(batch, generator)
        calls.append(1)
        if len(calls) == SUPER_STEPS + 2:
            _poison(tr.steps)
            metrics = dict(metrics, gan_G=torch.tensor(float("nan")))
        return metrics

    tr.steps.super_step = super_step
    tr.train(_dual(pipeline, SyntheticDefectDataset, 3), progress=False)
    after_epoch_1 = read_checkpoint(tmp_path, "nan", 1)
    state = train_state(tr.steps)
    for k, v in tr.steps.G.state_dict().items():
        assert torch.equal(v, after_epoch_1["G"][k]), k
    assert state["step"] == after_epoch_1["step"] == CRITICS * SUPER_STEPS
    assert tr._guard.restores == 1 and tr.iters == 2 * CRITICS * SUPER_STEPS


# ------------------------------------------------------------------ (d) CLIs
def _tiny_argv(tmp_path):
    return ["--ckpt_dir", str(tmp_path / "ckpt"), "--log_dir",
            str(tmp_path / "logs"), "--dataset_name", "synthetic",
            "--image_size", "32", "--label_nc", "4", "--batch_size", "16",
            "--ngf", "8", "--ndf", "8", "--num_scales", "2", "--num_res", "2",
            "--hidden_nc", "16", "--num_layers", "2", "--gpu_ids", "-1",
            "--style_norm_block_type", "adain"]


def test_cli_train_resume_then_test(tmp_path, monkeypatch):
    # no TensorBoard: importing it takes longer than the whole run
    writer = trainer_module.TBWriter
    monkeypatch.setattr(trainer_module, "TBWriter", lambda _: writer(None))
    tiny = _tiny_argv(tmp_path)
    tr = train_defectgan.main(["--name", "dg", "--num_epochs", "1",
                               "--num_critics", "8", "--save_ckpt_freq", "1"]
                              + tiny)
    run = tmp_path / "ckpt" / "dg"
    # 512 synthetic images / batch 16 / 8 critics = 4 super-steps
    assert tr.steps.device.type == "cpu" and tr.iters == 32
    assert (run / "iter.txt").read_text() == "1,32\n"
    assert (run / "1_state.pt").exists() and (run / "latest_state.pt").exists()

    resumed = train_defectgan.main(["--name", "dg", "--continue_training",
                                    "--num_epochs", "2"] + tiny)
    # as the JAX trainer: the run restarts at the recorded epoch
    assert resumed.first_epoch == 1 and resumed.iters == 32 + 2 * 32
    assert (run / "iter.txt").read_text() == "2,96\n"

    res = tmp_path / "res"
    out = test_defectgan.main(["--name", "dg", "--results_dir", str(res),
                               "--save_img_grid", "--save_diverse_images",
                               "--cal_clf", "--num_display_images", "2"] + tiny)
    grids = sorted(p.name for p in (res / "dg").glob("grid_*.png"))
    singles = sorted(p.name for p in (res / "dg" / "images").glob("Single_*.png"))
    assert grids == ["grid_0.png", "grid_1.png"]
    assert singles == ["Single_1.png", "Single_2.png", "Single_3.png"]
    assert sorted(out["pngs"]) == sorted(res.rglob("*.png"))
    assert 0.0 <= out["classifier_accuracy"] <= 1.0
    pil = pytest.importorskip("PIL.Image")
    grid = np.asarray(pil.open(res / "dg" / "grid_0.png"))
    # background, then (image, heat map) for each of the 3 defect labels
    assert grid.shape == (32, 32 * 7, 3) and grid.dtype == np.uint8


UNPORTED = {
    "train": [["--data_parallel", "on"], ["--num_devices", "2"],
              ["--gpu_ids", "0,1"]],
    "test": [["--gpu_ids", "0,1"]],
}


@pytest.mark.parametrize("etype", ["hidden", "mean", "std"])
def test_vis_style_embeds_through_the_cli(etype, tmp_path):
    """--vis_style_embeds (once unported): SEAN with an embedding bank, from
    a checkpoint; the captured activations by layer and label, one PCA
    scatter a layer when matplotlib is there."""
    from de_i2i_gan_torch.config.options import (
        Options, to_defectgan_config, to_train_config)
    from de_i2i_gan_torch.data.embeddings import EmbeddingBank
    from de_i2i_gan_torch.train.checkpoint import save_checkpoint
    from de_i2i_gan_torch.train.steps import DefectGanSteps

    argv = ["--name", "vis"] + _tiny_argv(tmp_path)[:-1] + [
        "sean", "--embed_nc", "12", "--num_embeds", "2"]
    opt = Options("defectgan_test").parse(argv, save=False)
    steps = DefectGanSteps(to_defectgan_config(opt), to_train_config(opt),
                           device="cpu")
    save_checkpoint(tmp_path / "ckpt", "vis", "latest", steps)
    rng = np.random.default_rng(0)
    bank = EmbeddingBank.from_dict(
        {(1, 0, 0, 0): list(rng.normal(size=(3, 12))),
         (0, 1, 1, 0): list(rng.normal(size=(2, 12)))}, 4)
    bank.save(tmp_path / "bank.npz")
    out = test_defectgan.main(argv + [
        "--results_dir", str(tmp_path / "res"), "--vis_style_embeds", etype,
        "--embed_path", str(tmp_path / "bank.npz")])
    layers = out["style_embeds"]
    want = {"hidden": ("mlp_shared", "mlp_latent"), "mean": ("mlp_beta",),
            "std": ("mlp_gamma",)}[etype]
    assert layers and all(k.rsplit(".", 1)[-1] in want for k in layers)
    for by_label in layers.values():
        assert sum(len(v) for v in by_label.values()) == 64  # the test set
        assert all(np.isfinite(e).all() for v in by_label.values() for e in v)
        if etype == "hidden":
            assert all((e >= 0).all() for v in by_label.values() for e in v)
    try:
        import matplotlib  # noqa: F401
        plotted = len(layers)
    except ImportError:
        plotted = 0
    assert len(list((tmp_path / "res" / "vis" / "pca").glob("*.png"))) == plotted


@pytest.mark.parametrize("cli,flags", [(c, f) for c in UNPORTED
                                       for f in UNPORTED[c]],
                         ids=lambda v: v if isinstance(v, str) else " ".join(v))
def test_unported_flags_raise(cli, flags, tmp_path):
    main = train_defectgan.main if cli == "train" else test_defectgan.main
    with pytest.raises(NotImplementedError, match=r"ROADMAP A\.\d+"):
        main(["--name", "x"] + _tiny_argv(tmp_path) + flags)


@pytest.mark.parametrize("flags,std", [
    (["--init_type", "xavier"], lambda fan_in, fan_out: 0.02 * math.sqrt(
        2.0 / (fan_in + fan_out))),
    (["--init_variance", "0.05"], lambda fan_in, fan_out: 0.05)],
    ids=lambda v: " ".join(v) if isinstance(v, list) else "")
def test_init_flags_draw_their_weights(flags, std, tmp_path, monkeypatch):
    """The init flags (once unported, now ``init_weights``' redraw): one
    tiny super-step through the train CLI; G's and D's conv kernels as
    drawn hold the flag's std within 10% (kernels of 1000 or more
    elements)."""
    writer = trainer_module.TBWriter
    monkeypatch.setattr(trainer_module, "TBWriter", lambda _: writer(None))
    drawn, real = {}, DefectGanTrainer.train

    def capture(self, *args, **kw):
        for net in ("G", "D"):
            for k, p in getattr(self.steps, net).named_parameters():
                if k.endswith("conv.weight") and p.numel() >= 1000:
                    drawn[f"{net}.{k}"] = p.detach().clone()
        return real(self, *args, **kw)

    monkeypatch.setattr(DefectGanTrainer, "train", capture)
    argv = ["--name", "x"] + _tiny_argv(tmp_path) + flags
    argv[argv.index("--batch_size") + 1] = "64"
    trainer = train_defectgan.main(argv + ["--num_critics", "8",
                                           "--num_epochs", "1"])
    assert trainer.iters == 8  # one super-step of 8 critics
    assert len(drawn) >= 4
    for k, w in drawn.items():
        fan_in, fan_out = w[0].numel(), w.shape[0]
        want = std(fan_in, fan_out)
        assert abs(w.std().item() - want) <= 0.1 * want, (k, w.std(), want)


def test_cli_test_grids_match_the_jax_clis(tmp_path):
    """One JAX checkpoint (a perturbed init state, SPADE, which draws no
    random numbers), converted to the port's format; both packages' test
    CLIs write ``--save_img_grid`` panels from it in float32: the same
    grids, pixel for pixel within 1 of 255 (a float32 difference near a
    rounding boundary of the uint8 cast), 99% of them equal."""
    from PIL import Image

    from de_i2i_gan_tpu.cli import test_defectgan as jax_test_cli
    from de_i2i_gan_torch.train.checkpoint import save_checkpoint

    cfg_kw = dict(TINY, style_norm_block_type="spade")
    jsteps = JaxSteps(JaxConfig(**cfg_kw), JaxTrainConfig(**SGD))
    state = _perturbed_state(jsteps.init_state(jax.random.PRNGKey(0)), SEED)
    jcheckpoint.save_checkpoint(tmp_path / "jax", "dg", 1, state)
    steps = DefectGanSteps(DefectGanConfig(**cfg_kw), TrainConfig(**SGD),
                           device="cpu")
    load_jax_train_state(steps, **_trees(state))
    save_checkpoint(tmp_path / "torch", "dg", 1, steps)

    argv = ["--name", "dg", "--which_epoch", "1", "--save_img_grid",
            "--num_display_images", "2"] + _tiny_argv(tmp_path)[4:] + [
        "--style_norm_block_type", "spade", "--compute_dtype", "float32"]
    for pkg, cli in (("jax", jax_test_cli), ("torch", test_defectgan)):
        cli.main(argv + ["--ckpt_dir", str(tmp_path / pkg), "--results_dir",
                         str(tmp_path / f"res_{pkg}")])
    for i in range(2):
        ref, got = (np.asarray(Image.open(tmp_path / f"res_{pkg}" / "dg" /
                                          f"grid_{i}.png")).astype(int)
                    for pkg in ("jax", "torch"))
        assert got.shape == ref.shape == (32, 32 * 7, 3)
        assert np.abs(got - ref).max() <= 1
        assert (got == ref).mean() > 0.99
