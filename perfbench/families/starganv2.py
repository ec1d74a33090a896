"""StarGAN v2 with AdaIN: the program's
``de_i2i_gan_torch.train.solver.StarGANv2Solver`` (``train_step`` for
training traffic, then its EMA) and the reference of
``perfbench/reference/starganv2``, built from the same drawn weights and
inputs.

The harness draws unit normals for every weight and one-hot or uniform
inputs; this module turns them into what the source uses: each weight
scaled to he_init's std sqrt(2 / fan_in), each domain the one-hot draw's
index, and ``z_ref``, ``z_ref2`` standard normal by the inverse normal CDF
of their uniform draws.

Both sides resume their Adams from one state (the configuration's
``resume``): the update count, and second moments drawn from the seed. A
fresh Adam with beta1 0 moves each weight by lr * sign(g) at its first
update, so where a gradient element is near 0 the two sides' rounding
picks the sign and D's first two updates scatter every later gradient by
2 * lr a weight; from a resumed state an update is continuous in the
gradient.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from perfbench.families import _port
from perfbench.lib import compare, inputs
from perfbench.reference.common import Ops
from perfbench.reference.starganv2.steps import (
    EMA_NETS, NETS, StarGANv2Reference, shapes)

# the smallest uniform draw the inverse CDF takes (torch.rand can give 0)
U_FLOOR = 2.0 ** -30
# the stream of --seed that Adam's second moments come from (lib/inputs.py
# uses 1 to 3)
ADAM_STATE = 4


def _normal(u: torch.Tensor) -> torch.Tensor:
    if u.device.type == "meta":
        return u
    return torch.special.ndtri(u.double().clamp_min(U_FLOOR)).float()


def make_pool(config: dict, traffic: dict, seed: int, device):
    rows = inputs.pool(config["inputs"][traffic["kind"]],
                       {"batch": traffic["batch"]}, traffic["pool"], seed, device)
    return [{k: (v.argmax(-1) if k.startswith("y_")
                 else _normal(v) if k.startswith("z_") else v)
             for k, v in r.items()} for r in rows]


def make_weights(config: dict, traffic: dict, seed: int, device):
    drawn = inputs.weights(shapes(config["model"]), config["init"], seed, device)
    for net in drawn.values():
        for t in net.values():
            if t.dim() >= 2 and t.device.type != "meta":
                t.mul_(math.sqrt(2.0 / math.prod(t.shape[1:])))
    return drawn


def make_adam_state(config: dict, seed: int, device):
    """Each network's Adam second moments, {net: {name: tensor}}, uniform in
    the configuration's ``resume`` range, drawn in one call."""
    r = config["resume"]["exp_avg_sq"]
    every = shapes(config["model"])
    if str(device) == "meta":
        return {n: {k: torch.empty(s, device="meta") for k, s in every[n].items()}
                for n in every}
    leaves = [(n, k, s) for n in sorted(every) for k, s in every[n].items()]
    flat = torch.empty(sum(math.prod(s) for _, _, s in leaves), device=device)
    flat.uniform_(r["low"], r["high"],
                  generator=inputs.generator(seed, ADAM_STATE, device))
    out: dict = {n: {} for n in every}
    start = 0
    for n, k, s in leaves:
        out[n][k] = flat[start:start + math.prod(s)].view(s)
        start += math.prod(s)
    return out


def units_per_step(config: dict, traffic: dict) -> int:
    """Samples an iteration consumes."""
    return traffic["batch"]


def loss_totals(config: dict, terms: dict, step: int) -> dict:
    """The loss each update minimizes, from the iteration's terms: D's and
    G's on the latent and on the reference pass."""
    t = config["train"]
    ds = max(0.0, t["lambda_ds"] * (1.0 - step / t["ds_iter"]))
    out = {}
    for tag in ("latent", "ref"):
        out[f"D_{tag}"] = (terms[f"D/{tag}_real"] + terms[f"D/{tag}_fake"]
                           + t["lambda_reg"] * terms[f"D/{tag}_reg"])
        out[f"G_{tag}"] = (terms[f"G/{tag}_adv"]
                           + t["lambda_sty"] * terms[f"G/{tag}_sty"]
                           - ds * terms[f"G/{tag}_ds"]
                           + t["lambda_cyc"] * terms[f"G/{tag}_cyc"])
    return out


class Program:
    """The program under test, with the drawn weights in its nets and their
    EMA copies; the pool of batches on the device."""

    def __init__(self, config: dict, traffic: dict, seed: int, device="cuda"):
        from de_i2i_gan_torch.train.solver import StarGANv2Config, StarGANv2Solver

        names = {f.name for f in dataclasses.fields(StarGANv2Config)}
        values = {**config["model"], **config["train"], "batch_size": traffic["batch"]}
        self.solver = StarGANv2Solver(
            StarGANv2Config(**{k: v for k, v in values.items() if k in names}),
            device=device)
        s = self.solver
        s.init_training()
        self.first: dict = {}
        for net in NETS:
            _port.watch_first(net, getattr(s, net), getattr(s, f"tx_{net}"),
                              self.first)
        weights = make_weights(config, traffic, seed, device)
        for net in NETS:
            _port.load(getattr(s, net), weights[net])
        for net in EMA_NETS:
            _port.load(getattr(s, f"ema_{net}"), weights[net])
        self._resume(config, seed, device)
        self.pool = make_pool(config, traffic, seed, device)

    @torch.no_grad()
    def _resume(self, config: dict, seed: int, device) -> None:
        count = config["resume"]["updates"]
        state = make_adam_state(config, seed, device)
        for net in NETS:
            opt = getattr(self.solver, f"tx_{net}").opt
            for name, p in getattr(self.solver, net).named_parameters():
                opt.state[p]["step"].fill_(count)
                opt.state[p]["exp_avg_sq"].copy_(state[net][name])

    def rows(self, i: int) -> dict:
        return self.pool[i % len(self.pool)]

    def step(self, i: int) -> dict:
        return self.solver.train_step(self.rows(i))

    def first_moment_norms(self) -> dict:
        return dict(self.first)

    def leaves(self) -> dict:
        s = self.solver
        out = {}
        for net in NETS:
            out.update(_port.leaves(net, getattr(s, net)))
        for net in EMA_NETS:
            out.update(_port.leaves(f"ema_{net}", getattr(s, f"ema_{net}")))
        return out

    def release(self) -> None:
        del self.solver, self.pool


class Reference:
    """The plain reference (``precision`` float32), the control (float8)
    or the witness (bfloat16) on the same weights and inputs."""

    def __init__(self, config: dict, traffic: dict, seed: int, device="cuda",
                 precision: str = "float32", norm_calls=None):
        self.pool = make_pool(config, traffic, seed, device)
        self.ref = StarGANv2Reference(
            config, make_weights(config, traffic, seed, device),
            Ops(precision, norm_calls))
        self.ref.resume(config["resume"]["updates"],
                        make_adam_state(config, seed, device))

    def rows(self, i: int) -> dict:
        return self.pool[i % len(self.pool)]

    def step(self, i: int) -> dict:
        return self.ref.train_step(self.rows(i))

    def first_moment_norms(self) -> dict:
        return compare.norms(self.ref.first_moments())

    def leaves(self) -> dict:
        return self.ref.leaves()
