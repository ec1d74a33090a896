"""The numbers ``correct`` rests on, worked out from readings of the
program (or of a control in its place) and of the reference.

Training, over the first ``steps`` steps of one object. A leaf whose
reference gradient is under ``FROZEN`` of the median leaf's is nought to
rounding (a bias before an instance norm) and left out of the leaves'
numbers.
  * ``loss_gap``: the largest relative gap of the first step's losses;
  * ``grad_gap``: each network's first gradient, read from Adam's first
    moment after the network's first update, by the worst leaf: the gap
    between the two norms of a leaf over the larger of the reference's
    norm of that leaf and of the median leaf;
  * ``grad_median_gap``: the same gap of the median leaf of the networks
    the cell names (or all);
  * ``change_gap``: the worst leaf's gap of its change over the steps.
Serving, over a sample of the answers:
  * ``out_max_gap`` and ``out_mean_gap``: the largest and the mean absolute
    gap of an answer's arrays, worst over the sample.
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, List, Sequence, Tuple

import torch

FROZEN = 1e-3


def norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """The float64 L2 norm of each tensor, in one transfer."""
    names = list(tensors)
    if not names:
        return {}
    values = torch.stack([torch.linalg.vector_norm(tensors[k].double())
                          for k in names]).cpu().tolist()
    return dict(zip(names, values))


def loss_gap(prog: Sequence[Dict[str, float]],
             ref: Sequence[Dict[str, float]]) -> Tuple[float, str]:
    worst, where = 0.0, ""
    for i, (p, r) in enumerate(zip(prog, ref, strict=True)):
        for k, rv in r.items():
            pv = p.get(k, math.nan)
            gap = abs(pv - rv) / max(abs(rv), 1e-12)
            if not math.isfinite(gap):
                return math.inf, f"step {i + 1} {k}"
            if gap > worst:
                worst, where = gap, f"step {i + 1} {k}"
    return worst, where


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              leaves: Sequence[str]) -> Dict[str, float]:
    floor = statistics.median(ref[k] for k in leaves)
    gaps = {k: abs(prog.get(k, math.nan) - ref[k]) / max(ref[k], floor, 1e-30)
            for k in leaves}
    return {k: (g if math.isfinite(g) else math.inf) for k, g in gaps.items()}


def worst(gaps: Dict[str, float]) -> Tuple[float, str]:
    k = max(gaps, key=gaps.get)
    return gaps[k], k


def median(gaps: Dict[str, float]) -> Tuple[float, str]:
    return statistics.median(gaps.values()), f"median of {len(gaps)} leaves"


def moved(ref_grad: Dict[str, float]) -> List[str]:
    """The leaves whose reference gradient is not nought to rounding."""
    floor = statistics.median(ref_grad.values())
    return [k for k, v in ref_grad.items() if v >= FROZEN * floor]


def training(prog: dict, ref: dict,
             median_nets=None) -> Dict[str, Tuple[float, str]]:
    """prog, ref: {"losses": [per step {loss: value}], "grad": {leaf:
    norm}, "change": {leaf: norm}}, leaves named ``<net>.<name>``. EMA
    leaves (``ema_<net>.<name>``) are kept where their net's leaf is."""
    kept = sorted(moved(ref["grad"]))
    change = [k for k in ref["change"]
              if k in kept or (k.startswith("ema_") and k[4:] in kept)]
    grads = leaf_gaps(prog["grad"], ref["grad"], kept)
    named = [k for k in kept if median_nets is None
             or k.split(".")[0] in median_nets]
    return {"loss_gap": loss_gap(prog["losses"][:1], ref["losses"][:1]),
            "grad_gap": worst(grads),
            "grad_median_gap": median(leaf_gaps(prog["grad"], ref["grad"], named)),
            "change_gap": worst(leaf_gaps(prog["change"], ref["change"], change))}


def answers(prog: Sequence[Sequence[torch.Tensor]],
            ref: Sequence[Sequence[torch.Tensor]]) -> Dict[str, Tuple[float, str]]:
    """Each answer a tuple of arrays; the program's are compared on the
    reference's device, in float32. A missing or misshapen array reads
    infinite."""
    worst_max, worst_mean = (0.0, ""), (0.0, "")
    for i, (p, r) in enumerate(zip(prog, ref, strict=True)):
        for j, rt in enumerate(r):
            pt = p[j] if j < len(p) else None
            if pt is None or tuple(pt.shape) != tuple(rt.shape):
                return {"out_max_gap": (math.inf, f"sample {i} array {j}"),
                        "out_mean_gap": (math.inf, f"sample {i} array {j}")}
            d = (pt.to(rt.device).float() - rt.float()).abs()
            mx, mean = d.max().item(), d.mean().item()
            if not (math.isfinite(mx) and math.isfinite(mean)):
                mx = mean = math.inf
            if mx >= worst_max[0]:
                worst_max = (mx, f"sample {i} array {j}")
            if mean >= worst_mean[0]:
                worst_mean = (mean, f"sample {i} array {j}")
    return {"out_max_gap": worst_max, "out_mean_gap": worst_mean}
