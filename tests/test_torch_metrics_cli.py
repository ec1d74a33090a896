"""The metric flags of the port's CLIs on the CPU, each flag that raised
before now running end to end: ``cli.test_defectgan --metrics fid is lpips
--save_stats`` then ``--cal_mfid``, ``cli.test_pix2pix --metrics fid``,
``cli.train_defectgan --val_metrics``, ``cli.fid`` (two folders, a folder
and an ``.npz``, ``--save_stats``, ``--mfid``) and ``cli.starganv2_main
--eval_every`` and ``--mode eval``. The metric nets are drawn from a seed:
the tests check the flow, the files and that every number is finite, not
the values. They take 64 dimensions (``--dims 64``: InceptionV3's first
tap, a few convs at 299²; StarGAN v2's evaluation, which has no such flag,
through an ``Evaluator`` patched to them) to keep the CPU time small: a
2048-wide FID spends seconds in ``scipy.linalg.sqrtm`` a task.
"""
import functools
import json
import math

import numpy as np
import pytest
import torch

from de_i2i_gan_torch.cli import fid as fid_cli
from de_i2i_gan_torch.cli import starganv2_main, test_defectgan, test_pix2pix
from de_i2i_gan_torch.cli import train_defectgan, train_pix2pix
from de_i2i_gan_torch.config.options import (
    Options, to_defectgan_config, to_train_config)
from de_i2i_gan_torch.train import trainer as trainer_module
from de_i2i_gan_torch.train.checkpoint import save_checkpoint
from de_i2i_gan_torch.train.jax_import import init_weights
from de_i2i_gan_torch.train.steps import DefectGanSteps
from de_i2i_gan_torch.utils.png import write_png
from tests.test_torch_starganv2_train_fused import _image_tree

torch.set_num_threads(1)


class _NoTensorBoard(trainer_module.TBWriter):
    """No TensorBoard (importing it takes longer than the runs)."""

    def __init__(self, log_dir):
        self._w, self.log_dir = None, log_dir


@pytest.fixture(autouse=True)
def _no_tensorboard(monkeypatch):
    monkeypatch.setattr(trainer_module, "TBWriter", _NoTensorBoard)


def _finite(d):
    return all(math.isfinite(v) for v in d.values())


def _dg_argv(tmp_path):
    return ["--name", "dg", "--ckpt_dir", str(tmp_path / "ckpt"), "--log_dir",
            str(tmp_path / "logs"), "--dataset_name", "synthetic",
            "--image_size", "32", "--label_nc", "4", "--batch_size", "16",
            "--ngf", "8", "--ndf", "8", "--num_scales", "2", "--num_res", "2",
            "--hidden_nc", "16", "--num_layers", "2", "--gpu_ids", "-1",
            "--style_norm_block_type", "sean", "--embed_nc", "12",
            "--num_embeds", "2", "--dims", "64"]


def test_test_defectgan_metrics_stats_and_mfid(tmp_path):
    argv = _dg_argv(tmp_path)
    opt = Options("defectgan_test").parse(argv, save=False)
    steps = DefectGanSteps(to_defectgan_config(opt), to_train_config(opt),
                           device="cpu")
    init_weights(steps, 5)
    save_checkpoint(tmp_path / "ckpt", "dg", "latest", steps)
    res = tmp_path / "res"
    out = test_defectgan.main(argv + [
        "--results_dir", str(res), "--metrics", "fid", "is", "lpips",
        "--num_imgs", "16", "--num_lpips_images", "1", "--metrics_out",
        str(res / "metrics.json"), "--save_stats"])
    metrics = out["metrics"]
    assert set(metrics) == {"fid", "is", "is_std", "lpips"} and _finite(metrics)
    assert metrics["lpips"] > 0 and metrics["is"] >= 1.0
    assert json.loads((res / "metrics.json").read_text()) == metrics
    # the defect set's activations by label combination (64 test images)
    stats = {p.stem: np.load(p) for p in out["stats"]}
    assert sum(len(a) for a in stats.values()) == 64
    assert all(a.shape[1] == 64 and np.isfinite(a).all()
               for a in stats.values())
    singles = [k for k, a in stats.items() if "-" not in k and len(a) > 1]
    assert singles

    out = test_defectgan.main(argv + [
        "--results_dir", str(res), "--cal_mfid", "--npy_path", str(res / "dg"),
        "--num_imgs", "16", "--metrics_out", str(res / "mfid.json")])
    mfid = out["mfid"]
    assert set(mfid) == {k[len("stats_"):] for k in singles} | {"mean"}
    assert _finite(mfid)
    assert json.loads((res / "mfid.json").read_text())["mfid"] == mfid["mean"]


def test_train_defectgan_val_metrics(tmp_path):
    argv = _dg_argv(tmp_path) + ["--num_epochs", "1", "--num_critics", "8",
                                 "--save_ckpt_freq", "1", "--val_metrics",
                                 "fid", "lpips", "--num_imgs", "16",
                                 "--num_lpips_images", "1"]
    train_defectgan.main(argv)
    got = json.loads((tmp_path / "ckpt" / "dg" / "val_metrics_1.json"
                      ).read_text())
    assert set(got) == {"fid", "lpips"} and _finite(got)


def test_test_pix2pix_metrics_fid(tmp_path):
    argv = ["--name", "p", "--ckpt_dir", str(tmp_path / "ckpt"),
            "--log_dir", str(tmp_path / "logs"), "--dataroot", "synthetic",
            "--crop_size", "32", "--load_size", "36", "--ngf", "8", "--ndf",
            "8", "--num_res", "2", "--hidden_nc", "16", "--n_layers_D", "2",
            "--batch_size", "2", "--iters_per_launch", "2",
            "--max_dataset_size", "8", "--gpu_ids", "-1"]
    train_pix2pix.main(argv + ["--num_epochs", "1"])
    out = test_pix2pix.main(argv + ["--results_dir", str(tmp_path / "res"),
                                    "--metrics", "fid", "--dims", "64"])
    assert math.isfinite(out["fid"]) and out["fid"] > 0
    saved = json.loads((tmp_path / "res" / "p" / "results.json").read_text())
    assert saved["fid"] == out["fid"]


def _png_folder(root, seed, n=6):
    rng = np.random.default_rng(seed)
    root.mkdir(parents=True)
    for i in range(n):
        write_png(root / f"{i}.png",
                  rng.integers(0, 256, (32, 32, 3), dtype=np.uint8))
    return root


def test_fid_cli(tmp_path, capsys):
    a, b = _png_folder(tmp_path / "a", 0), _png_folder(tmp_path / "b", 1)
    common = ["--dims", "64", "--image_size", "32", "--batch_size", "4",
              "--device", "cpu"]
    two = fid_cli.main([str(a), str(b)] + common)["fid"]
    assert math.isfinite(two) and two > 0
    assert f"FID: {two:.4f}" in capsys.readouterr().out
    npz = tmp_path / "a.npz"
    assert fid_cli.main([str(a), "--save_stats", str(npz)] + common) == {
        "stats": npz}
    with np.load(npz) as f:
        assert f["mu"].shape == (64,) and f["sigma"].shape == (64, 64)
    assert fid_cli.main([str(npz), str(b)] + common)["fid"] == pytest.approx(
        two, rel=1e-9)
    same = fid_cli.main([str(a), str(a)] + common)["fid"]
    assert abs(same) < 1e-6 * two

    rng = np.random.default_rng(2)
    for d, shift in (("real", 0.0), ("fake", 1.0)):
        (tmp_path / d).mkdir()
        for k in ("1", "2"):
            np.save(tmp_path / d / f"stats_{k}.npy",
                    rng.normal(shift, 1, (10, 4)))
    mfid = fid_cli.main(["--mfid", str(tmp_path / "real"),
                         str(tmp_path / "fake")])["mfid"]
    assert set(mfid) == {"1", "2", "mean"} and _finite(mfid)


def test_starganv2_eval_every_and_eval_mode(tmp_path, monkeypatch):
    """One training iteration with --eval_every 1 writes the step's JSON:
    an FID and an LPIPS for each of the 6 ordered pairs of 3 domains, and
    their means; --mode eval on the checkpoint of that step writes
    results_latent.json with the same numbers (the same weights, and the
    evaluation's draws come from --seed)."""
    from de_i2i_gan_torch.metrics import eval_starganv2
    monkeypatch.setattr(eval_starganv2, "Evaluator", functools.partial(
        eval_starganv2.Evaluator, dims=64))
    _image_tree(tmp_path / "tree", 2, per_domain=2)
    argv = ["--device", "cpu", "--img_size", "64", "--num_domains", "3",
            "--max_conv_dim", "64", "--style_dim", "8", "--latent_dim", "4",
            "--w_hpf", "0", "--batch_size", "2", "--val_batch_size", "2",
            "--num_workers", "1", "--compute_dtype", "float32",
            "--lambda_ds", "2", "--train_img_dir", str(tmp_path / "tree"),
            "--val_img_dir", str(tmp_path / "tree"), "--checkpoint_dir",
            str(tmp_path / "ckpt"), "--sample_dir", str(tmp_path / "samples"),
            "--eval_dir", str(tmp_path / "eval"), "--num_outs_per_domain", "2"]
    starganv2_main.main(argv + ["--total_iters", "1", "--eval_every", "1",
                                "--save_every", "1", "--sample_every", "100"])
    during = json.loads((tmp_path / "eval" / "results_000001_latent.json"
                         ).read_text())
    res = starganv2_main.main(argv + ["--mode", "eval", "--resume_iter", "1"])
    assert json.loads((tmp_path / "eval" / "results_latent.json").read_text()
                      ) == res
    tasks = {f"{s}2{t}" for s in ("cat", "dog", "wild")
             for t in ("cat", "dog", "wild") if s != t}
    assert set(res) == set(during) == (
        {f"FID_latent/{t}" for t in tasks} |
        {f"LPIPS_latent/{t}" for t in tasks} |
        {"FID_latent/mean", "LPIPS_latent/mean"})
    assert _finite(res) and res["LPIPS_latent/mean"] > 0
    assert res == pytest.approx(during, rel=1e-6)
