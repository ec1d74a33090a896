"""The WGAN CLI of the port with ``--gpu_ids -1``, at 32² on the synthetic
backgrounds (its 1024 images, batch 32, 5 critics: 6 super-steps an
epoch), ``ngf=ndf=8``:

  * ``cli.train_wgan`` for an epoch on the Python loader, then
    ``--continue_training`` to epoch 2: the state loaded at the resume is
    the one saved (RMSprop's ``nu`` and the update counts with it), tensor
    for tensor, and the run restarts at the recorded epoch as the JAX
    trainer does; the 4x4 grid of the fixed noise's samples is written
    every epoch; the critic's weights stay within the clip (0.03 plus one
    RMSprop step);
  * ``--native_loader`` for an epoch (needs g++): u8 super-batches at the
    step, the cache under ``<ckpt_dir>/native_cache/<name>/train``;
  * ``--init_type`` and unported flags as the DefectGAN CLI takes them.
"""
import pytest
import torch

from de_i2i_gan_tpu.runtime.native_loader import native_available
from de_i2i_gan_torch.cli import train_wgan
from de_i2i_gan_torch.train import trainer as trainer_module
from de_i2i_gan_torch.train.checkpoint import read_checkpoint, train_state
from de_i2i_gan_torch.train.wgan_steps import WGanSteps
from tests.test_torch_pix2pix_cli import _NoTensorBoard, _equal, _flat, _state

torch.set_num_threads(1)

SUPER_STEPS = 1024 // 32 // 5


@pytest.fixture(autouse=True)
def _no_tensorboard(monkeypatch):
    monkeypatch.setattr(trainer_module, "TBWriter", _NoTensorBoard)


def _argv(tmp_path, name, *extra):
    return ["--name", name, "--ckpt_dir", str(tmp_path / "ckpt"), "--log_dir",
            str(tmp_path / "logs"), "--dataset_name", "synthetic",
            "--image_size", "32", "--batch_size", "32", "--ngf", "8",
            "--ndf", "8", "--gpu_ids", "-1", *extra]


def test_cli_train_resume(tmp_path, monkeypatch):
    trainer = train_wgan.main(_argv(tmp_path, "wgan", "--num_epochs", "1"))
    assert trainer.iters == 5 * SUPER_STEPS
    assert trainer.cfg.num_layers == 2  # log2(32) - 3
    run = tmp_path / "ckpt" / "wgan"
    assert (run / "iter.txt").read_text().strip() == f"1,{5 * SUPER_STEPS}"
    saved = _flat(read_checkpoint(tmp_path / "ckpt", "wgan", "latest"))
    _equal(_state(trainer.steps), saved)
    assert any(k.endswith("/nu") for k in saved)  # RMSprop's moments
    assert (tmp_path / "logs" / "wgan" / "Images_fixed_noise_1.png").exists()
    steps = trainer.steps
    assert steps.step == 5 * SUPER_STEPS and steps.tx_G.count == SUPER_STEPS
    lr = trainer.tcfg.lr_d
    for k, p in steps.D.named_parameters():
        # clipped to 0.03 before the last critic step, then moved by at
        # most lr / sqrt(1 - 0.99) (RMSprop's largest step from a clip)
        assert p.abs().max() <= 0.03 + 10 * lr + 1e-7, k

    entry, real = {}, trainer_module.WGanTrainer.train

    def capture(self, *args, **kw):
        entry.update(epoch=self.first_epoch, iters=self.iters,
                     state=_state(self.steps))
        return real(self, *args, **kw)

    monkeypatch.setattr(trainer_module.WGanTrainer, "train", capture)
    resumed = train_wgan.main(_argv(tmp_path, "wgan", "--continue_training",
                                    "--num_epochs", "2"))
    _equal(entry["state"], saved)
    assert (entry["epoch"], entry["iters"]) == (1, 5 * SUPER_STEPS)
    assert resumed.iters == 15 * SUPER_STEPS
    assert (run / "iter.txt").read_text().strip() == f"2,{15 * SUPER_STEPS}"
    assert _state(resumed.steps).keys() == saved.keys()


@pytest.mark.skipif(not native_available(), reason="no native toolchain")
def test_cli_native_loader_trains_one_epoch(tmp_path, monkeypatch):
    seen, real = [], WGanSteps.super_step

    def spy(self, batches, generator=None):
        seen.append({k: v.dtype for k, v in batches.items()})
        return real(self, batches, generator)

    monkeypatch.setattr(WGanSteps, "super_step", spy)
    trainer = train_wgan.main(_argv(tmp_path, "native", "--num_epochs", "1",
                                    "--native_loader"))
    assert len(seen) == SUPER_STEPS and trainer.iters == 5 * SUPER_STEPS
    assert all(s["imgs"] == torch.uint8 for s in seen)
    assert (tmp_path / "ckpt" / "native_cache" / "native" / "train" /
            "images.u8").exists()
    for k, p in trainer.steps.G.named_parameters():
        assert torch.isfinite(p).all(), k


def test_data_parallel_on_with_one_device_raises(tmp_path):
    """``--data_parallel on`` (it raised while unported): with one device,
    JAX's ``RuntimeError``."""
    with pytest.raises(RuntimeError,
                       match="--data_parallel on: only one device visible"):
        train_wgan.main(_argv(tmp_path, "x") + ["--data_parallel", "on"])


def test_gpu_ids_list_spreads_the_training(tmp_path, monkeypatch):
    """``--gpu_ids 0,1`` (it raised while unported): one rank a listed
    card, handed to the spawner (no card here to run them; two CPU ranks
    train in tests/test_torch_parallel_cli_more.py)."""
    from de_i2i_gan_torch.parallel import distributed
    seen = []
    monkeypatch.setattr(distributed, "launch",
                        lambda fn, devices, *args: seen.append(devices))
    assert train_wgan.main(_argv(tmp_path, "x") + ["--gpu_ids", "0,1"]) is None
    assert seen == [("cuda:0", "cuda:1")]


def test_state_names_the_nets_and_moments(tmp_path):
    trainer = train_wgan.main(_argv(tmp_path, "s", "--num_epochs", "1",
                                    "--batch_size", "128"))
    state = train_state(trainer.steps)
    assert sorted(state) == ["D", "G", "step", "tx_D", "tx_G"]
    assert set(state["tx_D"]["moments"]["critic.weight"]) == {"nu"}
