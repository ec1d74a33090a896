"""Checkpointing, counterpart of ``de_i2i_gan_tpu/train/checkpoint.py``.

The same semantics (the reference's models/networks/__init__.py:4-23 and
trainers/base_trainer.py:38-52), in torch's own format:
  * per-tag files ``ckpt_dir/<name>/<tag>_state.pt`` (an epoch number or
    ``latest``), written to a temporary file and renamed into place
  * ``iter.txt`` holding ``epoch,iters`` for --continue_training resume
  * cross-variant warm starts (spade -> sean, ...) by a key-filtered
    restore: entries restore where key and shape match, everything else
    keeps its fresh initialization (torch's strict=False)

The state of a ``DefectGanSteps`` (``train_state``) is one nested dict:
the ``state_dict`` of G, E, D and ema_G (parameters and buffers: BatchNorm
statistics, spectral u/v, SEAN statistics), each optimizer's update
``count`` (the learning-rate schedules read it) and its moments by
parameter name, and ``step``, the count of D updates. A
``StarGANv2Solver``'s has the same form over the nets and optimizers its
``STATE_NETS`` and ``STATE_OPTIMIZERS`` name (G, D, M, S, the EMA nets with
ema_G's SEAN statistics; ``step`` counts iterations), under
``ckpt_dir/starganv2/<%06d iteration | latest>_state.pt``. A ``ViTSteps``
holds its linear head and its optimizer.

MAE pretraining (an ``MAESteps``, or a ``StarGANv2Solver`` in pretrain
mode) keeps G as the bare generator's ``state_dict`` and the mask token as
an entry of its own, ``token``; the token's moments sit in ``tx_G`` under
``token.<name>``, since it trains with G's optimizer. A warm start from
such a checkpoint (strict=False) restores every generator tensor and
reports the token as unexpected.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import torch

NETS = ("G", "E", "D", "ema_G")
OPTIMIZERS = ("G", "E", "D")


def _ckpt_path(ckpt_dir: Path, name: str, tag: str) -> Path:
    return Path(ckpt_dir) / name / f"{tag}_state.pt"


def train_state(steps) -> Dict[str, Any]:
    """The live state of ``steps`` (a ``DefectGanSteps`` or a
    ``StarGANv2Solver``): tensors are views of its parameters, buffers and
    optimizer moments (not copies)."""
    state: Dict[str, Any] = {"step": steps.step}
    for net in getattr(steps, "STATE_NETS", NETS):
        module = getattr(steps, net)
        if module is not None:
            state[net] = module.state_dict()
    for net in getattr(steps, "STATE_OPTIMIZERS", OPTIMIZERS):
        tx = getattr(steps, f"tx_{net}")
        if tx is not None:
            names = {id(p): k for k, p in getattr(steps, net).named_parameters()}
            token = getattr(steps, "token", None)
            if net == "G" and token is not None:
                # an MAE mask token trains with G's optimizer
                names.update({id(p): f"token.{k}"
                              for k, p in token.named_parameters()})
            state[f"tx_{net}"] = {
                "count": tx.count,
                "moments": {names[id(p)]: dict(tx.opt.state[p])
                            for p in tx.params}}
    return state


def clone_state(state: Dict[str, Any]) -> Dict[str, Any]:
    """A detached copy of a ``train_state`` on the same devices."""
    return {k: (clone_state(v) if isinstance(v, dict) else
                v.detach().clone() if isinstance(v, torch.Tensor) else v)
            for k, v in state.items()}


def _new_stats() -> Dict[str, Any]:
    return {"restored": 0, "missing": [], "shape_mismatch": [], "skipped": [],
            "unexpected": []}


def _merge(target: Dict, loaded: Dict, path: str, stats: Dict,
           scalars: Dict, write: bool) -> None:
    """Walk ``target``; take each entry of ``loaded`` whose key and shape
    match (in place for tensors; ints into ``scalars``)."""
    for k, t in target.items():
        p = f"{path}/{k}" if path else k
        if k not in loaded:
            stats["missing"].append(p)
            continue
        v = loaded[k]
        if isinstance(t, dict):
            if isinstance(v, dict):
                _merge(t, v, p, stats, scalars, write)
            else:
                stats["skipped"].append(p)
        elif isinstance(t, torch.Tensor):
            if not isinstance(v, torch.Tensor) or v.shape != t.shape:
                stats["shape_mismatch"].append(p)
                continue
            if write:
                with torch.no_grad():
                    t.copy_(v)
            stats["restored"] += 1
        else:
            scalars[p] = int(v)
            stats["restored"] += 1
    stats["unexpected"] += [f"{path}/{k}" if path else k
                            for k in loaded if k not in target]


def load_train_state(steps, state: Dict[str, Any], strict: bool = True
                     ) -> Dict[str, Any]:
    """Fill ``steps`` from a ``train_state`` dict. Strict: every key and
    shape must match on both sides, or nothing is written and it raises.
    Not strict: the filtered merge; returns the counts
    (``restored``, and the lists ``missing``, ``shape_mismatch``,
    ``skipped``, ``unexpected``)."""
    target = train_state(steps)
    stats, scalars = _new_stats(), {}
    _merge(target, state, "", stats, scalars, write=False)
    faults = [f"{k} {stats[k][:5]}" for k in ("missing", "shape_mismatch",
                                              "skipped", "unexpected")
              if stats[k]]
    if strict and faults:
        raise KeyError("the state does not fit: " + "; ".join(faults))
    _merge(target, state, "", _new_stats(), scalars, write=True)
    for path, value in scalars.items():
        if path == "step":
            steps.step = value
        else:  # tx_<net>/count
            getattr(steps, path.split("/")[0]).count = value
    if getattr(steps, "ema_G", None) is not None and \
            hasattr(steps, "_sync_ema_state"):
        steps._sync_ema_state()  # DefectGAN's EMA generator shares G's state
    return stats


def save_checkpoint(ckpt_dir: Path, name: str, tag: Any, steps,
                    epoch: Optional[int] = None,
                    iters: Optional[int] = None) -> Path:
    """Write the state of ``steps`` under ``tag`` (an epoch number or
    'latest') and update iter.txt when (epoch, iters) is given."""
    path = _ckpt_path(ckpt_dir, name, str(tag))
    d = Path(ckpt_dir) / name
    d.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(".tmp")
    torch.save(train_state(steps), tmp)
    os.replace(tmp, path)
    if epoch is not None and iters is not None:
        (d / "iter.txt").write_text(f"{epoch},{iters}\n")
    return path


def read_checkpoint(ckpt_dir: Path, name: str, tag: Any) -> Dict[str, Any]:
    """The ``train_state`` dict saved under ``tag``, on the CPU."""
    return torch.load(_ckpt_path(ckpt_dir, name, str(tag)),
                      map_location="cpu", weights_only=True)


def read_iter_record(ckpt_dir: Path, name: str) -> Tuple[int, int]:
    """(first_epoch, iters) from iter.txt (base_trainer.py:43-44)."""
    txt = (Path(ckpt_dir) / name / "iter.txt").read_text().strip()
    epoch, iters = txt.split(",")
    return int(epoch), int(iters)


def load_checkpoint(ckpt_dir: Path, name: str, tag: Any, steps,
                    strict: bool = True, verbose: bool = True
                    ) -> Dict[str, Any]:
    """Restore ``steps`` from the ``tag`` checkpoint. strict=False performs
    the key-filtered warm start (networks/__init__.py:14-23 semantics) and
    reports what it restored."""
    stats = load_train_state(steps, read_checkpoint(ckpt_dir, name, tag),
                             strict=strict)
    if verbose and (stats["missing"] or stats["shape_mismatch"]):
        print(f"[checkpoint] filtered restore: {stats['restored']} entries, "
              f"{len(stats['missing'])} missing, "
              f"{len(stats['shape_mismatch'])} shape-mismatched")
    return stats


def latest_exists(ckpt_dir: Path, name: str) -> bool:
    return _ckpt_path(ckpt_dir, name, "latest").exists()
