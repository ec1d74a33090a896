"""Checkpoints of the port (``train/checkpoint.py``).

A save and a strict load give back the training state exactly (``torch.equal``
on every tensor: parameters, BatchNorm statistics, spectral u/v, SEAN
statistics, optimizer moments; equality of the update counts and ``step``),
and the reloaded steps then take the same next super-step bit for bit (CPU,
float32). A filtered (``strict=False``) warm start from a SPADE run into a
SEAN generator restores every entry whose key and shape match and keeps the
SEAN heads fresh, and reports its counts. ``iter.txt`` is written; a write
that fails midway leaves the previous checkpoint as it was.
"""
import numpy as np
import pytest
import torch

from de_i2i_gan_torch.config import DefectGanConfig, TrainConfig
from de_i2i_gan_torch.train import checkpoint
from de_i2i_gan_torch.train.checkpoint import (
    latest_exists, load_checkpoint, read_iter_record, save_checkpoint,
    train_state)
from de_i2i_gan_torch.train.jax_import import init_weights
from de_i2i_gan_torch.train.steps import DefectGanSteps

torch.set_num_threads(1)

TINY = dict(image_size=32, label_nc=4, ngf=8, ndf=8, num_res=2, hidden_nc=16,
            num_layers=2, use_pallas=True)
SEAN = dict(TINY, style_norm_block_type="sean", embed_nc=24, num_embeds=3,
            use_spectral=True, use_running_stats=True, style_distill=True)
CASES = {
    "adain_adam_ema": (dict(TINY, style_norm_block_type="adain"),
                       dict(optimizer="adam", ema_decay=0.99)),
    "sean_rmsprop": (SEAN, dict(optimizer="rmsprop")),
    "spade_adamw_noise": (dict(TINY, style_norm_block_type="spade",
                               add_noise=True), dict(optimizer="adamw")),
}


def _steps(cfg_kw, tcfg_kw, seed=0):
    steps = DefectGanSteps(DefectGanConfig(**cfg_kw),
                           TrainConfig(batch_size=2, num_critics=2,
                                       lr=(2e-3, 1e-3), **tcfg_kw),
                           device="cpu", iters_per_epoch=8, num_epochs=4)
    steps.init_training()
    init_weights(steps, seed)
    return steps


def _batches(cfg_kw, seed):
    rng = np.random.default_rng(seed)
    shape = (2, 2, 32, 32, 3)
    out = {"bg": rng.uniform(-1, 1, shape), "df": rng.uniform(-1, 1, shape),
           "df_labels": np.eye(4)[rng.integers(0, 4, (2, 2))]}
    if cfg_kw.get("style_norm_block_type") == "sean":
        for k in ("nm_embeds", "df_embeds"):
            out[k] = rng.normal(0, 1, (2, 2, 3, 24))
    return {k: torch.tensor(v, dtype=torch.float32) for k, v in out.items()}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _assert_same_state(a, b):
    fa, fb = _flat(train_state(a)), _flat(train_state(b))
    assert fa.keys() == fb.keys()
    for k, v in fa.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, fb[k]), k
        else:
            assert v == fb[k], k


@pytest.mark.parametrize("case", sorted(CASES))
def test_save_then_load_is_exact(case, tmp_path):
    cfg_kw, tcfg_kw = CASES[case]
    steps = _steps(cfg_kw, tcfg_kw)
    gen = torch.Generator().manual_seed(1)
    steps.super_step(_batches(cfg_kw, 0), gen)
    if cfg_kw.get("use_running_stats"):
        steps.super_step(_batches(cfg_kw, 1), gen)  # statistics tracked
    save_checkpoint(tmp_path, "run", "latest", steps, epoch=3, iters=10)

    fresh = _steps(cfg_kw, tcfg_kw, seed=5)
    load_checkpoint(tmp_path, "run", "latest", fresh)
    _assert_same_state(steps, fresh)
    assert (fresh.step, fresh.tx_G.count, fresh.tx_D.count) == (
        steps.step, steps.tx_G.count, steps.tx_D.count) != (0, 0, 0)
    moments = _flat(train_state(fresh)["tx_G"]["moments"])
    if tcfg_kw["optimizer"] != "sgd":
        assert moments and any(v.abs().sum() > 0 for v in moments.values())

    # the same next super-step, draws and all
    for s in (steps, fresh):
        s.super_step(_batches(cfg_kw, 2), torch.Generator().manual_seed(3))
    _assert_same_state(steps, fresh)


def test_filtered_warm_start_spade_to_sean(tmp_path):
    spade = _steps(dict(TINY, style_norm_block_type="spade"),
                   dict(optimizer="adam"))
    spade.super_step(_batches({}, 0))
    save_checkpoint(tmp_path, "spade", 4, spade)

    sean = _steps(SEAN, dict(optimizer="adam"), seed=7)
    before = {k: v.clone() for k, v in sean.G.state_dict().items()}
    stats = load_checkpoint(tmp_path, "spade", 4, sean, strict=False)

    src = spade.G.state_dict()
    shared = set(src) & set(before)
    assert any(k.startswith("enc_") for k in shared)
    for k, v in sean.G.state_dict().items():
        if k in shared:  # encoder, decoder convs, heads, BN statistics
            assert torch.equal(v, src[k]), k
        else:  # the SEAN heads and statistics stay fresh
            assert torch.equal(v, before[k]), k
    d_src = spade.D.state_dict()  # the same D, with spectral u/v besides
    for k, v in sean.D.state_dict().items():
        if k in d_src:
            assert torch.equal(v, d_src[k]), k
    fresh_only = set(before) - shared
    assert sum(p.startswith("G/") for p in stats["missing"]) == len(fresh_only)
    assert sum(p.startswith("D/") for p in stats["missing"]) == sum(
        k.endswith(("_u", "_v")) for k in sean.D.state_dict())
    assert stats["restored"] > 0 and not stats["shape_mismatch"]
    assert any(p.startswith("tx_G/moments/") for p in stats["missing"])
    assert (sean.step, sean.tx_G.count) == (spade.step, spade.tx_G.count)

    with pytest.raises(KeyError, match="missing"):
        load_checkpoint(tmp_path, "spade", 4, _steps(SEAN, {}, seed=7))


def test_strict_load_of_a_misfit_writes_nothing(tmp_path):
    save_checkpoint(tmp_path, "spade", "latest",
                    _steps(dict(TINY, style_norm_block_type="spade"), {}))
    sean = _steps(SEAN, {}, seed=7)
    before = {k: v.clone() for k, v in _flat(train_state(sean)).items()
              if isinstance(v, torch.Tensor)}
    with pytest.raises(KeyError):
        load_checkpoint(tmp_path, "spade", "latest", sean)
    for k, v in _flat(train_state(sean)).items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, before[k]), k


def test_iter_record_and_latest(tmp_path):
    steps = _steps(dict(TINY, style_norm_block_type="adain"), {})
    assert not latest_exists(tmp_path, "run")
    path = save_checkpoint(tmp_path, "run", "latest", steps, epoch=2, iters=35)
    assert path == tmp_path / "run" / "latest_state.pt"
    assert latest_exists(tmp_path, "run")
    assert (tmp_path / "run" / "iter.txt").read_text() == "2,35\n"
    assert read_iter_record(tmp_path, "run") == (2, 35)
    save_checkpoint(tmp_path, "run", 3, steps)  # no (epoch, iters): kept
    assert read_iter_record(tmp_path, "run") == (2, 35)
    assert sorted(p.name for p in (tmp_path / "run").iterdir()) == [
        "3_state.pt", "iter.txt", "latest_state.pt"]


def test_failed_write_leaves_the_previous_checkpoint(tmp_path, monkeypatch):
    cfg_kw = dict(TINY, style_norm_block_type="adain")
    steps = _steps(cfg_kw, {})
    save_checkpoint(tmp_path, "run", "latest", steps)
    good = (tmp_path / "run" / "latest_state.pt").read_bytes()
    steps.super_step(_batches(cfg_kw, 0))

    def torn_save(obj, path):
        with open(path, "wb") as f:
            f.write(b"half a checkpoint")
        raise OSError("disk full")

    monkeypatch.setattr(checkpoint.torch, "save", torn_save)
    with pytest.raises(OSError, match="disk full"):
        save_checkpoint(tmp_path, "run", "latest", steps)
    monkeypatch.undo()
    assert (tmp_path / "run" / "latest_state.pt").read_bytes() == good
    fresh = _steps(cfg_kw, {}, seed=3)
    load_checkpoint(tmp_path, "run", "latest", fresh)
    _assert_same_state(fresh, _steps(cfg_kw, {}))
