"""The pix2pix CLIs of the port with ``--gpu_ids -1``, at 32² on the
synthetic pairs (``--crop_size 32 --load_size 36``, ``ngf=ndf=8``,
``num_res=2``, 2 layers of D, 16 pairs, 2 iterations a super-step):

  * ``cli.train_pix2pix`` for 2 epochs on the Python loader, then
    ``--continue_training`` to epoch 3: the state loaded at the resume is
    the one saved, tensor for tensor, and the run restarts at the recorded
    epoch, as the JAX trainer does; the input | fake | target panels are
    written every epoch;
  * ``cli.train_pix2pix --native_loader`` for an epoch (needs g++): u8
    ``pair`` batches at the step;
  * ``cli.test_pix2pix`` on one JAX checkpoint (a perturbed init state),
    converted to the port's format: its ``results.json`` ``l1`` against the
    JAX test CLI's, float32, within 1e-4 (a mean of |fake - target| over
    the 16 test pairs, each fake within 5e-4 of JAX's), and the panels,
    pixel for pixel within 1 of 255 (a rounding boundary of the u8 cast).
"""
import json

import jax
import numpy as np
import pytest
import torch

from de_i2i_gan_tpu.cli import test_pix2pix as jax_test_cli
from de_i2i_gan_tpu.config import DefectGanConfig as JaxConfig
from de_i2i_gan_tpu.config import TrainConfig as JaxTrainConfig
from de_i2i_gan_tpu.runtime.native_loader import native_available
from de_i2i_gan_tpu.train import checkpoint as jcheckpoint
from de_i2i_gan_tpu.train import pix2pix_steps as jp2p
from de_i2i_gan_torch.cli import test_pix2pix, train_pix2pix
from de_i2i_gan_torch.config import DefectGanConfig, TrainConfig
from de_i2i_gan_torch.train import trainer as trainer_module
from de_i2i_gan_torch.train.checkpoint import (
    read_checkpoint, save_checkpoint, train_state)
from de_i2i_gan_torch.train.jax_import import load_jax_pix2pix_state
from de_i2i_gan_torch.train.pix2pix_steps import Pix2PixSteps
from tests.test_torch_pix2pix import CFG, jax_state

torch.set_num_threads(1)

L1_TOL = 1e-4
PAIRS, IPL = 16, 2


class _NoTensorBoard(trainer_module.TBWriter):
    """PNGs into the log directory, no TensorBoard (importing it takes
    longer than the runs)."""

    def __init__(self, log_dir):
        self._w, self.log_dir = None, log_dir


@pytest.fixture(autouse=True)
def _no_tensorboard(monkeypatch):
    monkeypatch.setattr(trainer_module, "TBWriter", _NoTensorBoard)


def _argv(tmp_path, name, *extra):
    return ["--name", name, "--ckpt_dir", str(tmp_path / "ckpt"), "--log_dir",
            str(tmp_path / "logs"), "--dataroot", "synthetic", "--crop_size",
            "32", "--load_size", "36", "--ngf", "8", "--ndf", "8", "--num_res",
            "2", "--hidden_nc", "16", "--n_layers_D", "2", "--batch_size", "2",
            "--iters_per_launch", str(IPL), "--max_dataset_size", str(PAIRS),
            "--gpu_ids", "-1", *extra]


def _state(steps):
    return {k: v.detach().clone() if isinstance(v, torch.Tensor) else v
            for k, v in _flat(train_state(steps)).items()}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _equal(a, b):
    assert a.keys() == b.keys()
    for k, v in a.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, b[k]), k
        else:
            assert v == b[k], k


def test_cli_train_resume(tmp_path, monkeypatch):
    trainer = train_pix2pix.main(_argv(tmp_path, "p2p", "--num_epochs", "2",
                                       "--save_img_freq", "1"))
    per_epoch = PAIRS // 2 // IPL * IPL
    assert trainer.iters == 2 * per_epoch
    run = tmp_path / "ckpt" / "p2p"
    assert (run / "iter.txt").read_text().strip() == f"2,{2 * per_epoch}"
    saved = _flat(read_checkpoint(tmp_path / "ckpt", "p2p", "latest"))
    _equal(_state(trainer.steps), saved)
    for epoch in (1, 2):
        assert (tmp_path / "logs" / "p2p" /
                f"Images_input_fake_target_{epoch}.png").exists()
    for k, v in trainer.steps.G.named_parameters():
        assert torch.isfinite(v).all(), k

    entry, real = {}, trainer_module.Pix2PixTrainer.train

    def capture(self, *args, **kw):
        entry.update(epoch=self.first_epoch, iters=self.iters,
                     state=_state(self.steps))
        return real(self, *args, **kw)

    monkeypatch.setattr(trainer_module.Pix2PixTrainer, "train", capture)
    resumed = train_pix2pix.main(_argv(tmp_path, "p2p", "--continue_training",
                                       "--num_epochs", "3"))
    _equal(entry["state"], saved)
    # as the JAX trainer: the recorded epoch runs again
    assert (entry["epoch"], entry["iters"]) == (2, 2 * per_epoch)
    assert resumed.iters == 4 * per_epoch
    assert (run / "iter.txt").read_text().strip() == f"3,{4 * per_epoch}"


@pytest.mark.skipif(not native_available(), reason="no native toolchain")
def test_cli_native_loader_trains_one_epoch(tmp_path, monkeypatch):
    seen, real = [], Pix2PixSteps.super_step

    def spy(self, batches, generator=None):
        seen.append({k: v.dtype for k, v in batches.items()})
        return real(self, batches, generator)

    monkeypatch.setattr(Pix2PixSteps, "super_step", spy)
    trainer = train_pix2pix.main(_argv(tmp_path, "native", "--num_epochs", "1",
                                       "--native_loader"))
    assert len(seen) == PAIRS // 2 // IPL and trainer.iters == len(seen) * IPL
    assert all(s == {"pair": torch.uint8} for s in seen)
    assert (tmp_path / "ckpt" / "native_cache" / "native" / "pairs" /
            "images.u8").exists()
    for k, v in trainer.steps.D.named_parameters():
        assert torch.isfinite(v).all(), k


def test_cli_test_l1_matches_the_jax_cli(tmp_path):
    from PIL import Image

    # the test CLI's nets: its defaults at the sizes of _argv
    cfg_kw = dict(CFG, ngf=8, ndf=8, num_res=2, hidden_nc=16, num_layers=5)
    jsteps = jp2p.Pix2PixSteps(JaxConfig(**cfg_kw),
                               JaxTrainConfig(ema_decay=0.999), n_layers_d=2)
    state = jax_state(jsteps, 4)
    jcheckpoint.save_checkpoint(tmp_path / "jax", "p2p", "latest", state)
    steps = Pix2PixSteps(DefectGanConfig(**cfg_kw), TrainConfig(ema_decay=0.999),
                         n_layers_d=2, device="cpu")
    load_jax_pix2pix_state(steps, jax.device_get(state))
    save_checkpoint(tmp_path / "torch", "p2p", "latest", steps)
    base = _argv(tmp_path, "p2p")[4:] + ["--compute_dtype", "float32",
                                        "--save_img"]
    results = {}
    for pkg, cli in (("jax", jax_test_cli), ("torch", test_pix2pix)):
        cli.main(["--name", "p2p", "--ckpt_dir", str(tmp_path / pkg),
                  "--results_dir", str(tmp_path / f"res_{pkg}"), *base])
        out = tmp_path / f"res_{pkg}" / "p2p"
        results[pkg] = json.loads((out / "results.json").read_text())
        assert len(list(out.glob("*.png"))) == PAIRS
    assert results["torch"]["num_images"] == results["jax"]["num_images"] == PAIRS
    assert abs(results["torch"]["l1"] - results["jax"]["l1"]) <= L1_TOL
    for i in (0, PAIRS - 1):
        got, ref = (np.asarray(Image.open(tmp_path / f"res_{pkg}" / "p2p" /
                                          f"{i:05d}.png")).astype(int)
                    for pkg in ("torch", "jax"))
        assert got.shape == ref.shape == (32, 96, 3)
        assert np.abs(got - ref).max() <= 1
