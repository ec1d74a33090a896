"""pix2pix (batch 2), WGAN and StarGAN v2 through their CLIs over two CPU
ranks, as ``test_torch_parallel_cli.py`` runs DefectGAN and MAE: a run and
its resume in one launch, checkpoints written by rank 0, the ranks' states
equal bit for bit.
"""
import pytest
import torch

from de_i2i_gan_torch.parallel import distributed
from de_i2i_gan_torch.train.checkpoint import read_checkpoint
from tests import torch_dp_workers as workers
from tests.test_torch_parallel_cli import _equal, check_train_then_resume
from tests.test_torch_starganv2_train_fused import _image_tree

torch.set_num_threads(1)


@pytest.mark.parametrize("cli", ["train_pix2pix", "train_wgan"])
def test_cli_over_two_ranks_trains_and_resumes(cli, tmp_path):
    check_train_then_resume(tmp_path, cli)


def test_starganv2_over_two_ranks_trains_and_resumes(tmp_path):
    tree = tmp_path / "tree"
    _image_tree(tree, 2, per_domain=3)
    base = ["--device", "cpu", "--img_size", "64", "--num_domains", "2",
            "--max_conv_dim", "64", "--style_dim", "8", "--latent_dim", "4",
            "--w_hpf", "0", "--batch_size", "2", "--val_batch_size", "2",
            "--num_workers", "1", "--compute_dtype", "float32",
            "--train_img_dir", str(tree), "--val_img_dir", str(tree),
            "--checkpoint_dir", str(tmp_path / "ckpt"), "--sample_dir",
            str(tmp_path / "samples"), "--print_every", "1", "--save_every",
            "1", "--sample_every", "100", "--num_devices", "2",
            "--data_parallel", "on"]
    runs = distributed.launch(
        workers.cli_rank, ["cpu", "cpu"], "starganv2_main",
        base + ["--total_iters", "1"],
        base + ["--total_iters", "2", "--resume_iter", "1"])
    first, resumed = ([r[i] for r in runs] for i in range(2))
    _equal(first)
    _equal(resumed)
    run = tmp_path / "ckpt" / "starganv2"
    assert sorted(p.name for p in run.iterdir()) == [
        "000001_state.pt", "000002_state.pt", "latest_state.pt"]
    assert first[0]["step"] == 1
    assert read_checkpoint(tmp_path / "ckpt", "starganv2", "latest")[
        "step"] == resumed[0]["step"] == 2
