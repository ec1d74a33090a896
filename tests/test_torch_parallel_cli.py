"""The training CLIs of the port over two CPU ranks (``--gpu_ids -1
--num_devices 2 --data_parallel on``), tiny and for one epoch: checkpoints
written by rank 0, the ranks' states equal bit for bit
(``parallel/mesh.py::state_digest``), and a resume that goes on from them.
The ranks run each CLI's ``main`` (``tests/torch_dp_workers.py::cli_rank``,
TensorBoard left out); ``test_main_spawns_its_ranks`` goes through the
CLI's own spawner instead. DefectGAN and MAE here; pix2pix, WGAN and
StarGAN v2 in ``test_torch_parallel_cli_more.py``. The flags' decisions:
``--data_parallel on`` with one device raises JAX's ``RuntimeError``, and
'auto' falls back with JAX's line when the batch does not split.
"""
import pytest
import torch

from de_i2i_gan_torch.cli import train_defectgan, train_wgan
from de_i2i_gan_torch.parallel import distributed
from de_i2i_gan_torch.train import trainer as trainer_module
from de_i2i_gan_torch.train.checkpoint import read_checkpoint, read_iter_record
from tests import torch_dp_workers as workers

torch.set_num_threads(1)

RANKS = ["--gpu_ids", "-1", "--num_devices", "2", "--data_parallel", "on"]
TINY_DG = ["--image_size", "32", "--label_nc", "4", "--ngf", "8", "--ndf",
           "8", "--num_scales", "2", "--num_res", "2", "--hidden_nc", "16",
           "--num_layers", "2", "--style_norm_block_type", "adain"]
CLIS = {
    # module, flags, super-steps (iterations) an epoch
    "train_defectgan": (["--dataset_name", "synthetic", "--batch_size", "16",
                         "--num_critics", "8", *TINY_DG], 4),
    "train_mae": (["--dataset_name", "synthetic", "--batch_size", "16",
                   "--num_critics", "8", *TINY_DG], 4),
    "train_pix2pix": (["--dataroot", "synthetic", "--crop_size", "32",
                       "--load_size", "36", "--ngf", "8", "--ndf", "8",
                       "--num_res", "2", "--hidden_nc", "16", "--n_layers_D",
                       "2", "--batch_size", "2", "--iters_per_launch", "2",
                       "--max_dataset_size", "16"], 8),
    "train_wgan": (["--dataset_name", "synthetic", "--image_size", "32",
                    "--batch_size", "64", "--ngf", "8", "--ndf", "8"], 3),
}


def _argv(tmp_path, cli, *extra):
    flags, _ = CLIS[cli]
    return ["--name", "dp", "--ckpt_dir", str(tmp_path / "ckpt"),
            "--log_dir", str(tmp_path / "logs"), *flags, *RANKS, *extra]


def _equal(digests):
    a, b = digests
    assert a.keys() == b.keys() and len(a) > 10
    differ = [k for k in a if a[k] != b[k]]
    assert not differ, f"the ranks' states differ at {differ[:5]}"


def train_then_resume(tmp_path, cli):
    """One epoch, then ``--continue_training`` to epoch 2, in one launch of
    two ranks: each run's digests by rank."""
    runs = distributed.launch(
        workers.cli_rank, ["cpu", "cpu"], cli,
        _argv(tmp_path, cli, "--num_epochs", "1"),
        _argv(tmp_path, cli, "--continue_training", "--num_epochs", "2"))
    return [[r[i] for r in runs] for i in range(2)]


def check_train_then_resume(tmp_path, cli):
    """Both runs' ranks equal; rank 0 wrote the checkpoints; the resume went
    on from epoch 1's: the JAX trainer's resume restarts at the recorded
    epoch, so epoch 1's iterations come three times."""
    first, resumed = train_then_resume(tmp_path, cli)
    _equal(first)
    _equal(resumed)
    run = tmp_path / "ckpt" / "dp"
    assert (run / "latest_state.pt").exists() and (run / "opt.json").exists()
    epoch, iters = read_iter_record(tmp_path / "ckpt", "dp")
    assert epoch == 2 and iters > 0 and iters % (3 * CLIS[cli][1]) == 0
    assert read_checkpoint(tmp_path / "ckpt", "dp", "latest")["step"] == \
        resumed[0]["step"] == 3 * first[0]["step"] > 0


@pytest.mark.parametrize("cli", ["train_defectgan", "train_mae"])
def test_cli_over_two_ranks_trains_and_resumes(cli, tmp_path):
    check_train_then_resume(tmp_path, cli)


def test_main_spawns_its_ranks(tmp_path, monkeypatch):
    """``--num_devices 2`` trains through the CLI's own spawner
    (``parallel/mesh.py::run``, TensorBoard left out of the ranks): ``main``
    returns each rank's state digest."""
    launch = distributed.launch
    monkeypatch.setattr(distributed, "launch", lambda fn, devices, *args:
                        launch(workers.no_tensorboard, devices, fn, *args))
    digests = train_wgan.main(_argv(tmp_path, "train_wgan", "--num_epochs",
                                    "1"))
    assert isinstance(digests, list) and len(digests) == 2
    _equal(digests)
    assert read_checkpoint(tmp_path / "ckpt", "dp", "latest")["step"] == \
        digests[0]["step"] == 3 * 5


@pytest.mark.parametrize("flags", [["--data_parallel", "on"],
                                   ["--data_parallel", "on", "--gpu_ids", "-1"]],
                         ids=["one card", "one CPU rank"])
def test_data_parallel_on_one_device_raises(flags, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="--data_parallel on: only one "
                                           "device visible"):
        train_defectgan.main(["--name", "x", "--ckpt_dir",
                              str(tmp_path / "ckpt"), *TINY_DG, *flags])


def test_batch_that_does_not_split_falls_back_under_auto(tmp_path, capsys,
                                                         monkeypatch):
    """'auto' prints JAX's line and trains on the one device."""
    writer = trainer_module.TBWriter
    monkeypatch.setattr(trainer_module, "TBWriter", lambda _: writer(None))
    tr = train_wgan.main(["--name", "w", "--ckpt_dir", str(tmp_path / "ckpt"),
                          "--log_dir", str(tmp_path / "logs"),
                          "--dataset_name", "synthetic", "--image_size", "32",
                          "--batch_size", "63", "--ngf", "8", "--ndf", "8",
                          "--gpu_ids", "-1", "--num_devices", "2",
                          "--num_epochs", "1"])
    assert "[data_parallel] --data_parallel: batch_size 63 does not divide 2 " \
        "local devices; running single-device" in capsys.readouterr().out
    assert tr.mesh is None and tr.iters > 0
