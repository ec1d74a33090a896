"""The ViT CLIs (``cli/train_vit.py``, ``cli/test_vit.py``) on the CPU with
the tiny ViT at the synthetic dataset's 32^2, and the embedding bank they
write feeding DefectGAN's SEAN (``cli.train_defectgan --embed_path``);
``utils/visualize.py``'s PCA by SVD.
"""
import numpy as np
import pytest
import torch

from de_i2i_gan_torch.cli import test_vit, train_defectgan, train_vit
from de_i2i_gan_torch.data.embeddings import EmbeddingBank
from de_i2i_gan_torch.train import trainer as trainer_module
from de_i2i_gan_torch.train.checkpoint import read_checkpoint
from de_i2i_gan_torch.utils.visualize import reduce_embeddings

torch.set_num_threads(1)


def vit_argv(tmp_path, name="v"):
    return ["--name", name, "--dataset_name", "synthetic", "--image_size",
            "32", "--model_size", "tiny", "--batch_size", "16", "--gpu_ids",
            "-1", "--ckpt_dir", str(tmp_path / "ckpt"), "--log_dir",
            str(tmp_path / "logs")]


def test_train_then_test_then_sean_reads_the_bank(tmp_path, monkeypatch):
    steps = train_vit.main(vit_argv(tmp_path) + ["--num_epochs", "1"])
    # the synthetic set's 512 defect images in batches of 16
    assert steps.step == steps.tx_head.count == 32
    saved = read_checkpoint(tmp_path / "ckpt", "v", "latest")
    assert torch.equal(saved["head"]["clf.weight"], steps.head.clf.weight)
    assert (tmp_path / "ckpt" / "v" / "1_state.pt").exists()

    out = test_vit.main(vit_argv(tmp_path) + [
        "--results_dir", str(tmp_path / "res"), "--calc_classifier_acc",
        "--save_embeddings", "--visualize_tsne"])
    assert 0.0 <= out["accuracy"] <= 1.0 and np.isfinite(out["loss"])
    bank = EmbeddingBank.load(out["embeddings_path"])
    assert bank.embed_nc == 16 and int(bank.counts.sum()) == 64
    vecs = [e for v in out["bank"].values() for e in v]
    assert len(vecs) == 64 and all(e.shape == (16,) for e in vecs)

    # the bank of --dump_embeddings feeds DefectGAN's SEAN as --embed_path
    dump = tmp_path / "dump" / "embeds.npz"
    train_vit.main(vit_argv(tmp_path, "d") + ["--dump_embeddings", str(dump)])
    assert int(EmbeddingBank.load(dump).counts.sum()) == 512
    writer = trainer_module.TBWriter
    monkeypatch.setattr(trainer_module, "TBWriter", lambda _: writer(None))
    tr = train_defectgan.main([
        "--name", "sean", "--ckpt_dir", str(tmp_path / "ckpt"), "--log_dir",
        str(tmp_path / "logs"), "--dataset_name", "synthetic", "--image_size",
        "32", "--batch_size", "16", "--ngf", "8", "--ndf", "8",
        "--num_scales", "2", "--num_res", "2", "--hidden_nc", "16",
        "--num_layers", "2", "--gpu_ids", "-1", "--num_epochs", "1",
        "--num_critics", "8", "--style_norm_block_type", "sean",
        "--embed_nc", "16", "--num_embeds", "2", "--embed_path", str(dump)])
    assert tr.iters == 32
    for k, p in tr.steps.G.named_parameters():
        assert torch.isfinite(p).all(), k


def test_pca_by_svd():
    """The PCA of the embedding scatter, numpy alone: the centred vectors
    projected on the covariance's two leading eigenvectors (up to sign)."""
    rng = np.random.default_rng(0)
    bank = {(1, 0): list(rng.normal(0, 1, (20, 6)) * [5, 3, 1, 1, 1, 1]),
            (0, 1): list(rng.normal(2, 1, (10, 6)))}
    red, labels = reduce_embeddings(bank, "pca")
    vecs = np.concatenate([np.stack(v) for v in bank.values()])
    c = vecs - vecs.mean(0)
    w, v = np.linalg.eigh(c.T @ c)
    ref = c @ v[:, ::-1][:, :2]
    assert red.shape == (30, 2) and labels.count((1, 0)) == 20
    np.testing.assert_allclose(np.abs(red), np.abs(ref), rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose((red ** 2).sum(0), w[::-1][:2], rtol=1e-8)


@pytest.mark.parametrize("flags", [["--gpu_ids=-1,0"],
                                   ["--data_parallel", "on"]],
                         ids=lambda v: " ".join(v))
def test_train_vit_takes_no_mesh(flags, tmp_path):
    """``--gpu_ids`` with several ids and ``--data_parallel on`` (they raised
    while unported): as in JAX, which takes no mesh here, the run goes on
    the first device (the CPU) and ignores ``--data_parallel``."""
    argv = vit_argv(tmp_path) + ["--dump_embeddings",
                                 str(tmp_path / "e.npz")] + flags
    steps = train_vit.main(argv)
    assert steps.device.type == "cpu"
    assert int(EmbeddingBank.load(tmp_path / "e.npz").counts.sum()) == 512
