"""The port's tools against the JAX package's: ``utils/profiling.py``
(``trace`` writing a Chrome trace; its spans are in
``tests/test_torch_spans.py``), ``cli/sweep.py``
(``build_commands``, ``_filter`` and ``--dry_run`` equal to JAX's with the
package names swapped; one real one-value sweep with ``--eval`` on the CPU,
its runs executed in this process) and ``utils/visualize.py::draw_ablation``.
"""
import importlib
import json
import types

import numpy as np
import pytest
import torch

from de_i2i_gan_tpu.cli import sweep as jax_sweep
from de_i2i_gan_torch.cli import sweep
from de_i2i_gan_torch.utils import profiling
from de_i2i_gan_torch.utils.visualize import draw_ablation
from tests import torch_dp_workers as workers

torch.set_num_threads(1)

SWAP = ("de_i2i_gan_tpu.", "de_i2i_gan_torch.")


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(tmp_path / "t") as prof:
        torch.ones(8, 8).matmul(torch.ones(8, 8))
    trace = json.loads((tmp_path / "t" / "trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "aten::matmul" in names and prof is not None


# ------------------------------------------------------------------ sweep
COMMON = ["--dataset_name", "synthetic", "--image_size", "32", "--ngf", "8",
          "--ndf", "8", "--num_scales", "2", "--num_res", "2", "--hidden_nc",
          "16", "--num_layers", "2", "--gpu_ids", "-1", "--num_epochs", "1",
          "--batch_size", "32", "--num_critics", "8",
          "--style_norm_block_type", "adain", "--dims", "64", "--num_imgs",
          "8", "--not_a_flag", "x", "y"]


def _swapped(cmds):
    return [([t.replace(*SWAP) for t in cmd], meta) for cmd, meta in cmds]


@pytest.mark.parametrize("eval_runs", [False, True])
def test_build_commands_match_jax(eval_runs, tmp_path):
    args = ("mask_ratio", [0.1, 0.75], COMMON, eval_runs, "ck", tmp_path)
    got = sweep.build_commands(*args)
    assert got == _swapped(jax_sweep.build_commands(*args))
    assert len(got) == (6 if eval_runs else 4)
    assert all("de_i2i_gan_torch.cli." in cmd[2] for cmd, _ in got)


def test_filter_matches_jax():
    tokens = ["--a", "1", "--zz", "x", "y", "--b", "--c=3", "--a", "2"]
    assert sweep._filter(tokens, {"--a", "--b"}) == \
        jax_sweep._filter(tokens, {"--a", "--b"}) == \
        ["--a", "1", "--b", "--a", "2"]
    for kind in ("mae_train", "defectgan_train", "defectgan_test"):
        assert sweep._filter(COMMON, sweep._known_flags(kind)) == \
            jax_sweep._filter(COMMON, jax_sweep._known_flags(kind))


def test_dry_run_prints_jax_commands(tmp_path, capsys):
    argv = ["--axis", "mask_token_type", "--values", "zero", "position",
            "--eval", "--dry_run", "--out_dir", str(tmp_path), "--",
            *COMMON]
    jax_sweep.main(argv)
    want = capsys.readouterr().out
    sweep.main(argv)
    assert capsys.readouterr().out == want.replace(*SWAP)


def test_one_value_sweep_with_eval(tmp_path, monkeypatch):
    """MAE pretraining, the warm-started DefectGAN run and its FID: each
    command runs its module's ``main`` in this process (TensorBoard left
    out), then the sweep writes the JSON and the figure."""
    ran = []

    def run(cmd, check):
        assert check and cmd[1] == "-m"
        ran.append(cmd[2])
        main = importlib.import_module(cmd[2]).main
        workers.no_tensorboard(main, cmd[3:])

    monkeypatch.setattr(sweep, "subprocess", types.SimpleNamespace(run=run))
    out = tmp_path / "out"
    sweep.main(["--axis", "mask_ratio", "--values", "0.5", "--eval",
                "--ckpt_dir", str(tmp_path / "ck"), "--out_dir", str(out),
                "--", *COMMON[:-3]])
    assert ran == ["de_i2i_gan_torch.cli.train_mae",
                   "de_i2i_gan_torch.cli.train_defectgan",
                   "de_i2i_gan_torch.cli.test_defectgan"]
    fids = json.loads((out / "sweep_mask_ratio.json").read_text())
    assert list(fids) == ["0.5"] and np.isfinite(fids["0.5"])
    assert (out / "sweep_mask_ratio.png").stat().st_size > 0


def test_draw_ablation_writes_its_png(tmp_path):
    from PIL import Image
    draw_ablation({0.1: 73.4, 0.4: 65.0, 0.9: 80.5}, "MAE mask_ratio sweep",
                  "mask_ratio", tmp_path / "fig" / "a.png")
    img = np.asarray(Image.open(tmp_path / "fig" / "a.png"))
    assert img.shape[0] > 100 and img.shape[1] > 100 and img.std() > 0
