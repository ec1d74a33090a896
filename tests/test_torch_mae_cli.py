"""The MAE entry points of the port on the CPU (``--gpu_ids -1``, tiny
widths, synthetic or on-disk data), the MAE options, and the native
super-batch feed against the JAX package's.

* ``Options("mae_train")`` takes the JAX package's MAE defaults (batch 32,
  AdamW, cosine schedule with lr_decay 0.05, lr 1.5e-4, loss_weight [10, 3,
  1], one critic) and ``to_mae_config`` its fields.
* ``cli.train_mae`` for one epoch on the Python loader -> ``cli.test_mae``
  on its checkpoint (the loss line, a repair grid PNG of 4 rows of 5
  panels) -> ``cli.train_defectgan --load_model_name`` starting from the MAE
  run's generator.
* ``cli.train_mae --native_loader``: u8 super-batches reach the step, the
  cache under ``native_cache/<name>/fusion``.
* ``cli.train_mtvec --pretrain`` and ``cli.pretrain_mtvec`` on the MVTec
  layout train MAE runs.
* ``make_native_super_batch``: the port's and the JAX package's super-batches
  bit for bit with one C++ thread, as ``tests/test_torch_native_loader.py``
  holds the dual stream.
"""
import struct

import numpy as np
import pytest
import torch

from de_i2i_gan_tpu.config.options import Options as JaxOptions
from de_i2i_gan_tpu.config.options import to_mae_config as jax_to_mae_config
from de_i2i_gan_tpu.data.synthetic import SyntheticDefectDataset as JaxSynthetic
from de_i2i_gan_tpu.runtime import native_loader as jnative
from de_i2i_gan_tpu.runtime.native_loader import native_available
from de_i2i_gan_torch.cli import (
    pretrain_mtvec, test_mae, train_defectgan, train_mae, train_mtvec)
from de_i2i_gan_torch.config.options import Options, to_mae_config
from de_i2i_gan_torch.data.synthetic import SyntheticDefectDataset
from de_i2i_gan_torch.runtime import native_loader
from de_i2i_gan_torch.train import checkpoint
from de_i2i_gan_torch.train import trainer as trainer_module
from de_i2i_gan_torch.train.mae_steps import MAESteps
from de_i2i_gan_torch.train.trainer import DefectGanTrainer
from de_i2i_gan_torch.utils.png import write_png

torch.set_num_threads(1)

TINY = ["--image_size", "32", "--ngf", "8", "--ndf", "8", "--num_scales", "2",
        "--num_res", "2", "--hidden_nc", "16", "--num_layers", "2",
        "--gpu_ids", "-1", "--style_norm_block_type", "adain"]


def _argv(tmp_path, name, *extra):
    return ["--name", name, "--ckpt_dir", str(tmp_path / "ckpt"),
            "--log_dir", str(tmp_path / "logs"), *TINY, *extra]


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    writer = trainer_module.TBWriter
    monkeypatch.setattr(trainer_module, "TBWriter", lambda _: writer(None))


@pytest.fixture
def seen_batches(monkeypatch):
    """The dtype and device of each super-batch's images at the MAE step."""
    seen = []
    real = MAESteps.super_step

    def super_step(self, batches, generator=None):
        seen.append((batches["imgs"].dtype, batches["imgs"].device.type,
                     tuple(batches["imgs"].shape)))
        return real(self, batches, generator)

    monkeypatch.setattr(MAESteps, "super_step", super_step)
    return seen


def test_mae_options_match_jax(tmp_path):
    argv = ["--name", "m", "--ckpt_dir", str(tmp_path), "--mask_ratio", "0.5",
            "--mask_token_type", "full", "--split_training"]
    opt = Options("mae_train").parse(argv, save=False)
    jopt = JaxOptions("mae_train").parse(argv, save=False)
    for k in ("batch_size", "optimizer", "num_epochs", "lr", "scheduler",
              "lr_decay", "loss_weight", "num_critics", "save_latest_freq",
              "mask_ratio", "patch_size", "mask_token_type",
              "split_training"):
        assert getattr(opt, k) == getattr(jopt, k), k
    assert (opt.batch_size, opt.optimizer, opt.lr, opt.loss_weight,
            opt.num_critics) == (32, "adamw", [1.5e-4], [10, 3, 1], 1)
    assert vars(to_mae_config(opt)) == vars(jax_to_mae_config(jopt))
    test = Options("mae_test").parse(["--name", "m", "--ckpt_dir",
                                      str(tmp_path)])
    assert test.load_model_name == "m" and test.batch_size == 32


def _png_size(path):
    head = path.read_bytes()[:24]
    assert head[:8] == b"\x89PNG\r\n\x1a\n"
    w, h = struct.unpack(">II", head[16:24])
    return h, w


def test_train_mae_then_test_mae_then_warm_start(tmp_path, seen_batches,
                                                 monkeypatch, capsys):
    tr = train_mae.main(_argv(tmp_path, "mae", "--dataset_name", "synthetic",
                              "--num_epochs", "1"))
    # 512 fusion images, batch 32, one critic
    assert len(seen_batches) == 16 and tr.iters == 16
    assert all(s == (torch.float32, "cpu", (1, 32, 32, 32, 3))
               for s in seen_batches)
    run = tmp_path / "ckpt" / "mae"
    assert {"latest_state.pt", "iter.txt", "opt.json"} <= {
        p.name for p in run.iterdir()}
    assert tr.steps.device.type == "cpu"

    out = test_mae.main(_argv(tmp_path, "mae", "--dataset_name", "synthetic",
                              "--results_dir", str(tmp_path / "res")))
    assert sorted(out["losses"]) == ["clf", "gan", "rec"]
    assert all(np.isfinite(v) for v in out["losses"].values())
    assert "'rec':" in capsys.readouterr().out
    assert out["grid"] == tmp_path / "res" / "mae" / "repair_grid.png"
    assert _png_size(out["grid"]) == (4 * 32, 5 * 32)

    saved = checkpoint.read_checkpoint(tmp_path / "ckpt", "mae", "latest")
    entry = []
    real_train = DefectGanTrainer.train

    def capture(self, *args, **kw):
        entry.append({k: v.clone() for k, v in self.steps.G.state_dict().items()})
        return real_train(self, *args, **kw)

    monkeypatch.setattr(DefectGanTrainer, "train", capture)
    train_defectgan.main(_argv(tmp_path, "dg", "--dataset_name", "synthetic",
                               "--load_model_name", "mae", "--num_epochs",
                               "1", "--batch_size", "16", "--num_critics",
                               "8", "--save_ckpt_freq", "4"))
    assert entry[0].keys() == saved["G"].keys()
    for k, v in saved["G"].items():
        assert torch.equal(entry[0][k], v), k


def test_train_mae_native_loader(tmp_path, seen_batches):
    if not native_available():
        pytest.skip("no native toolchain")
    tr = train_mae.main(_argv(tmp_path, "nat", "--dataset_name", "synthetic",
                              "--num_epochs", "1", "--native_loader"))
    assert len(seen_batches) == tr.iters == 16
    assert all(s == (torch.uint8, "cpu", (1, 32, 32, 32, 3))
               for s in seen_batches)
    cache = tmp_path / "ckpt" / "native_cache" / "nat" / "fusion"
    assert (cache / "images.u8").exists()
    assert (tmp_path / "ckpt" / "nat" / "latest_state.pt").exists()
    for p in tr.steps.G.parameters():
        assert torch.isfinite(p).all()


def _mtvec_tree(root):
    rng = np.random.default_rng(5)
    for lbl in ("normal", "scratch"):
        d = root / "mtvec" / "pill" / "train" / lbl
        d.mkdir(parents=True)
        for i in range(6):
            write_png(d / f"{i}.png",
                      rng.integers(0, 255, (48, 48, 3), dtype=np.uint8))


@pytest.mark.parametrize("entry", ["train_mtvec --pretrain", "pretrain_mtvec"])
def test_mtvec_pretrain_clis(entry, tmp_path, seen_batches):
    _mtvec_tree(tmp_path / "data")
    argv = _argv(tmp_path, "mt", "--data_dir", str(tmp_path / "data"),
                 "--dataset_data_type", "pill", "--label_nc", "2",
                 "--batch_size", "2", "--num_epochs", "1")
    if entry == "pretrain_mtvec":
        tr = pretrain_mtvec.main(argv)
    else:
        tr = train_mtvec.main(["--pretrain", *argv])
    # 12 fusion images of the MVTec layout, batch 2: an MAE run
    assert isinstance(tr.steps, MAESteps) and len(seen_batches) == 6
    assert tr.tcfg.clf_loss_type == "cce"
    saved = checkpoint.read_checkpoint(tmp_path / "ckpt", "mt", "latest")
    assert "token" in saved


def test_native_super_batches_match_jax(tmp_path):
    if not native_available():
        pytest.skip("no native toolchain")
    port_ds = SyntheticDefectDataset(48, 6, 20, "fusion", seed=5)
    jax_ds = JaxSynthetic(48, 6, 20, "fusion", seed=5)
    kw = dict(image_size=32, batch_size=2, num_critics=3, seed=4,
              num_threads=1)
    port = native_loader.make_native_super_batch(port_ds, tmp_path / "port", **kw)
    ref = jnative.make_native_super_batch(jax_ds, tmp_path / "jax", **kw)
    try:
        assert len(port) == len(ref) == 20 // 2 // 3
        for _ in range(2):  # two epochs
            got, want = list(port), list(ref)
            assert len(got) == len(want) == len(port)
            for b, jb in zip(got, want):
                assert sorted(b) == ["imgs", "labels"]
                assert b["imgs"].dtype == np.uint8
                assert b["imgs"].shape == (3, 2, 32, 32, 3)
                for k in b:
                    np.testing.assert_array_equal(b[k], jb[k], err_msg=k)
            assert got[0]["imgs"].ctypes.data != got[1]["imgs"].ctypes.data
    finally:
        port.close()
        ref.close()
    for a, b in zip(sorted((tmp_path / "port").iterdir()),
                    sorted((tmp_path / "jax").iterdir())):
        assert a.read_bytes() == b.read_bytes(), a.name


def test_epoch_view_counts_an_epoch(tmp_path):
    if not native_available():
        pytest.skip("no native toolchain")
    ds = SyntheticDefectDataset(32, 6, 10, "defects", seed=1)
    cache, index = native_loader.build_cache(ds, tmp_path)
    loader = native_loader.NativeDataLoader(cache, index, 32, 4, num_threads=1)
    try:
        view = native_loader.EpochView(loader)
        assert len(view) == 10 // 4
        batches = list(view)
        assert len(batches) == 2 and batches[0][0].shape == (4, 32, 32, 3)
        assert len(native_loader.EpochView(loader, 5)) == 5
        with pytest.raises(ValueError, match="u8 only"):
            native_loader.NativeSuperBatchLoader(loader, 2)
    finally:
        loader.close()
