"""Warm starts from MAE pretraining, and the MAE trainer's checkpoints, on
the CPU.

* A port MAE checkpoint restored through
  ``DefectGanTrainer(load_model_name=...)`` sets every generator tensor
  (parameters and BatchNorm statistics), and E and D, to the MAE run's
  values, tensor for tensor; before the restore each differs.
* StarGAN v2: ``--mode train --pretrain_dir`` starts G and ``ema_G`` from
  the ``--mode pretrain`` run's generator and its EMA, D, M, S and their EMA
  nets from the run's, and leaves the mask token out.
* The JAX package's own MAE warm start restores none of the generator: its
  MAE state nests G under ``{"net", "token"}``. The record test below states
  the difference (ROADMAP §C); it checks nothing of the port.
* ``MAETrainer``: one epoch writes ``latest``, the epoch checkpoint and
  ``iter.txt``; ``continue_training`` starts from the saved state and goes
  on counting; the validation losses run each epoch.

The tiny config of ``tests/test_mae_wgan.py`` (AdaIN decoder), float32.
"""
import numpy as np
import pytest
import torch

import jax

from de_i2i_gan_tpu.config import DefectGanConfig as JaxConfig
from de_i2i_gan_tpu.config import MAEConfig as JaxMAEConfig
from de_i2i_gan_tpu.config import TrainConfig as JaxTrainConfig
from de_i2i_gan_tpu.train import checkpoint as jcheckpoint
from de_i2i_gan_tpu.train.mae_steps import MAESteps as JaxMAESteps
from de_i2i_gan_tpu.train.trainer import DefectGanTrainer as JaxDefectGanTrainer
from de_i2i_gan_torch.cli import starganv2_main as sgv2_cli
from de_i2i_gan_torch.config import DefectGanConfig, MAEConfig, TrainConfig
from de_i2i_gan_torch.train import checkpoint
from de_i2i_gan_torch.train import trainer as trainer_module
from de_i2i_gan_torch.train.trainer import DefectGanTrainer, MAETrainer
from tests.test_torch_mae import CFG, MAE, make_batches
from tests.test_torch_starganv2_train_cli import _argv
from tests.test_torch_starganv2_train_fused import _flat, _image_tree

torch.set_num_threads(1)

ADAIN = dict(CFG, style_norm_block_type="adain")
MAE_TCFG = dict(batch_size=2, num_critics=1, lr=(1.5e-4,), optimizer="adamw",
                scheduler="cos", loss_weight=(10, 3, 1))
DG_TCFG = dict(batch_size=2, num_critics=2, lr=(2e-4, 1e-4))


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    writer = trainer_module.TBWriter
    monkeypatch.setattr(trainer_module, "TBWriter", lambda _: writer(None))


class _Loader:
    """``n`` single-stream super-batches from a seed, as SuperBatchLoader
    yields them."""

    def __init__(self, n, seed=0):
        self.batches = [{k: v[:1] for k, v in make_batches(seed + i, "adain")
                         .items()} for i in range(n)]

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        return iter(self.batches)


def mae_trainer(tmp_path, **kw):
    return MAETrainer(DefectGanConfig(**ADAIN), MAEConfig(**MAE),
                      TrainConfig(**MAE_TCFG), name="mae",
                      ckpt_dir=tmp_path / "ckpt", log_dir=None,
                      iters_per_epoch=3, num_epochs=kw.pop("num_epochs", 1),
                      save_latest_freq=1000, save_ckpt_freq=1, device="cpu",
                      **kw)


def dg_trainer(tmp_path, **kw):
    return DefectGanTrainer(DefectGanConfig(**ADAIN), TrainConfig(**DG_TCFG),
                            name="dg", ckpt_dir=tmp_path / "ckpt", log_dir=None,
                            iters_per_epoch=4, num_epochs=1, seed=7,
                            device="cpu", **kw)


@pytest.mark.parametrize("net", ["G", "E", "D"])
def test_mae_checkpoint_warm_starts_defectgan(net, tmp_path):
    mae = mae_trainer(tmp_path)
    mae.train(_Loader(3), progress=False)
    saved = checkpoint.read_checkpoint(tmp_path / "ckpt", "mae", "latest")
    assert "token" in saved and "mask_token" in saved["token"]
    assert not any(k.startswith("token") for k in saved["G"])
    fresh = getattr(dg_trainer(tmp_path).steps, net).state_dict()
    warm = getattr(dg_trainer(tmp_path, load_model_name="mae").steps,
                   net).state_dict()
    assert warm.keys() == saved[net].keys() == fresh.keys()
    for k, v in saved[net].items():
        assert torch.equal(warm[k], v), k
        if v.is_floating_point() and v.numel() > 1:
            # one AdamW super-step moved every weight, and G's BatchNorm
            # statistics, off their fresh init
            assert not torch.equal(fresh[k], v), k


def test_mae_trainer_checkpoints_resume_and_validation(tmp_path):
    mae = mae_trainer(tmp_path)
    seen = []
    real = mae.steps.eval_losses

    def eval_losses(batch, generator=None):
        seen.append(sorted(batch))
        return real(batch, generator)

    mae.steps.eval_losses = eval_losses
    val = [{k: v[0] for k, v in make_batches(20 + i, "adain").items()}
           for i in range(2)]
    mae.train(_Loader(3), val_loader=val, progress=False)
    assert seen == [["imgs", "labels"]] * 2
    run = tmp_path / "ckpt" / "mae"
    assert sorted(p.name for p in run.iterdir()) == [
        "1_state.pt", "iter.txt", "latest_state.pt"]
    assert checkpoint.read_iter_record(tmp_path / "ckpt", "mae") == (1, 3)
    saved = checkpoint.read_checkpoint(tmp_path / "ckpt", "mae", "latest")
    assert saved["step"] == 3 and saved["tx_G"]["count"] == 3

    resumed = mae_trainer(tmp_path, num_epochs=2, continue_training=True)
    flat_s = _flat(saved)
    flat_l = _flat(checkpoint.clone_state(checkpoint.train_state(resumed.steps)))
    assert flat_s.keys() == flat_l.keys()
    for k, v in flat_s.items():
        assert (torch.equal(v, flat_l[k]) if isinstance(v, torch.Tensor)
                else v == flat_l[k]), k
    # as the JAX trainer: the run restarts at the recorded epoch
    assert (resumed.first_epoch, resumed.iters) == (1, 3)
    resumed.train(_Loader(3), progress=False)
    assert resumed.iters == 9 and resumed.steps.step == 9
    assert checkpoint.read_iter_record(tmp_path / "ckpt", "mae") == (2, 9)


def test_starganv2_pretrain_dir_warm_starts_g_and_ema_g(tmp_path, monkeypatch):
    _image_tree(tmp_path / "tree", 4, per_domain=2)
    pre = sgv2_cli.main(_argv(tmp_path, "--mode", "pretrain", "--total_iters",
                              "2", "--save_every", "1", "--print_every", "2"))
    assert pre.step == 2 and pre.tx_G.count == pre.tx_D.count == 4
    assert pre.tx_M.count == pre.tx_S.count == 2
    run = tmp_path / "ckpt" / "starganv2_pretrain"
    assert sorted(p.name for p in run.iterdir()) == [
        "000001_state.pt", "000002_state.pt", "latest_state.pt"]
    saved = checkpoint.read_checkpoint(tmp_path / "ckpt", "starganv2_pretrain",
                                       "latest")
    assert "token" in saved and "token.mask_token" in saved["tx_G"]["moments"]
    loaded, real_train = [], sgv2_cli.train

    def spy(args, solver):
        loaded.append(checkpoint.clone_state(checkpoint.train_state(solver)))
        real_train(args, solver)

    monkeypatch.setattr(sgv2_cli, "train", spy)
    fresh = sgv2_cli.main(_argv(tmp_path / "fresh", "--train_img_dir",
                                str(tmp_path / "tree"), "--total_iters", "0"))
    sgv2_cli.main(_argv(tmp_path, "--total_iters", "0", "--pretrain_dir",
                        str(tmp_path / "ckpt")))
    state = loaded[-1]
    assert "token" not in state
    for net in ("G", "ema_G", "D", "M", "S", "ema_M", "ema_S"):
        assert state[net].keys() == saved[net].keys()
        for k, v in saved[net].items():
            assert torch.equal(state[net][k], v), f"{net} {k}"
    fresh_g = fresh.G.state_dict()
    assert any(not torch.equal(fresh_g[k], v) for k, v in saved["G"].items())
    # the token's moments stay behind with the token
    assert set(state["tx_G"]["moments"]) == {k for k, _ in fresh.G.named_parameters()}


def test_starganv2_pretrain_iter_picks_the_tagged_checkpoint(tmp_path,
                                                            monkeypatch):
    _image_tree(tmp_path / "tree", 5, per_domain=2)
    sgv2_cli.main(_argv(tmp_path, "--mode", "pretrain", "--total_iters", "2",
                        "--save_every", "1", "--print_every", "2"))
    first = checkpoint.read_checkpoint(tmp_path / "ckpt", "starganv2_pretrain",
                                       "000001")
    solver = sgv2_cli.main(_argv(tmp_path, "--total_iters", "0",
                                 "--pretrain_dir", str(tmp_path / "ckpt"),
                                 "--pretrain_iter", "1"))
    for k, v in first["G"].items():
        assert torch.equal(solver.G.state_dict()[k], v), k


def test_record_jax_mae_warm_start_leaves_the_generator_unrestored(tmp_path):
    """A record of how the JAX package differs (ROADMAP §C), not a check of
    the port: its ``DefectGanTrainer(load_model_name=<MAE run>)`` restores
    D from an MAE checkpoint but no leaf of G, since the MAE state holds G
    under ``{"net", "token"}`` and the filtered restore matches keys from
    the top. The port restores every G tensor (the tests above)."""
    cfg = JaxConfig(**{k: v for k, v in CFG.items() if k != "use_pallas"})
    mae = JaxMAESteps(cfg, JaxMAEConfig(),
                      JaxTrainConfig(batch_size=2, lr=(1e-4,),
                                     loss_weight=(10, 3, 1)),
                      iters_per_epoch=5, num_epochs=2)
    jcheckpoint.save_checkpoint(tmp_path, "mae", "latest",
                                mae.init_state(jax.random.PRNGKey(0)))
    tcfg = JaxTrainConfig(batch_size=2, num_critics=2, lr=(1e-4,))
    kw = dict(ckpt_dir=tmp_path, log_dir=None, iters_per_epoch=5,
              num_epochs=1, seed=9)
    fresh = JaxDefectGanTrainer(cfg, tcfg, name="dg", **kw).state
    warm = JaxDefectGanTrainer(cfg, tcfg, name="dg", load_model_name="mae",
                               **kw).state

    def changed(a, b):
        la, lb = jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
        return sum(not np.array_equal(x, y) for x, y in zip(la, lb)), len(la)

    g_changed, g_leaves = changed(fresh.G.params, warm.G.params)
    d_changed, d_leaves = changed(fresh.D.params, warm.D.params)
    assert (g_changed, g_leaves) == (0, 45)
    assert d_changed == d_leaves == 5
