"""DefectGAN: the program's ``de_i2i_gan_torch.train.steps.DefectGanSteps``
(``super_step`` for training traffic, ``generate`` for serving traffic)
and the reference of ``perfbench/reference/defectgan``, built from the same
drawn weights and inputs."""
from __future__ import annotations

import dataclasses

from perfbench.families import _port
from perfbench.lib import compare, inputs
from perfbench.reference.common import Ops
from perfbench.reference.defectgan.steps import DefectGanReference, shapes


def _nets(mode: str):
    return ("D", "E", "G") if mode == "train" else ("E", "G")


def _sizes(config: dict, traffic: dict) -> dict:
    return {"batch": traffic["batch"], "critics": config["train"]["num_critics"]}


def make_pool(config: dict, traffic: dict, seed: int, device):
    return inputs.pool(config["inputs"][traffic["kind"]],
                       _sizes(config, traffic), traffic["pool"], seed, device)


def make_weights(config: dict, traffic: dict, seed: int, device):
    every = shapes(config["model"])
    return inputs.weights({n: every[n] for n in _nets(traffic["kind"])},
                          config["init"], seed, device)


def units_per_step(config: dict, traffic: dict) -> int:
    """Samples a training step consumes, or images a request returns."""
    if traffic["kind"] == "train":
        return config["train"]["num_critics"] * traffic["batch"]
    return traffic["batch"]


def loss_totals(config: dict, terms: dict, step: int) -> dict:
    """The losses the two optimizers minimize, from the step's terms: D's
    (averaged over the critics) and G's."""
    w = config["train"]["loss_weight"]
    return {"D": terms["gan_D"] + w[0] * terms["clf_D"],
            "G": (terms["gan_G"] + w[1] * terms["clf_G"] + w[2] * terms["rec"]
                  + w[3] * terms["sd_cyc"] + w[4] * terms["sd_con"])}


def _fields(cls, values: dict) -> dict:
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: (tuple(v) if isinstance(v, list) else v)
            for k, v in values.items() if k in names}


class Program:
    """The program under test, with the drawn weights; serving inputs in
    host memory, training inputs on the device."""

    def __init__(self, config: dict, traffic: dict, seed: int, device="cuda"):
        from de_i2i_gan_torch.config import DefectGanConfig, TrainConfig
        from de_i2i_gan_torch.train.steps import DefectGanSteps

        self.mode = traffic["kind"]
        t = config["train"]
        cfg = DefectGanConfig(**_fields(DefectGanConfig, config["model"]))
        tcfg = TrainConfig(**_fields(TrainConfig, {**t, "batch_size": traffic["batch"]}))
        self.steps = DefectGanSteps(cfg, tcfg, device=device,
                                    iters_per_epoch=t["iters_per_epoch"],
                                    num_epochs=t["num_epochs"])
        self.first: dict = {}
        if self.mode == "train":
            self.steps.init_training()
            for net in ("D", "G", "E"):
                _port.watch_first(net, getattr(self.steps, net),
                                  getattr(self.steps, f"tx_{net}"), self.first)
        weights = make_weights(config, traffic, seed, device)
        for net in _nets(self.mode):
            _port.load(getattr(self.steps, net), weights[net])
        self.pool = make_pool(config, traffic, seed, device)
        if self.mode == "serve":
            self.pool = [{k: v.cpu() for k, v in r.items()} for r in self.pool]

    def rows(self, i: int) -> dict:
        return self.pool[i % len(self.pool)]

    def step(self, i: int) -> dict:
        return self.steps.super_step(self.rows(i))

    def answer(self, i: int):
        r = self.rows(i)
        out, prob = self.steps.generate(r["data"], r["labels"])
        return out.cpu(), prob.cpu()

    def first_moment_norms(self) -> dict:
        return dict(self.first)

    def leaves(self) -> dict:
        s = self.steps
        return {**_port.leaves("G", s.G), **_port.leaves("E", s.E),
                **_port.leaves("D", s.D)}

    def release(self) -> None:
        del self.steps, self.pool


class Reference:
    """The plain reference (``precision`` float32), the control (float8)
    or the witness (bfloat16) on the same weights and inputs."""

    def __init__(self, config: dict, traffic: dict, seed: int, device="cuda",
                 precision: str = "float32", norm_calls=None):
        self.pool = make_pool(config, traffic, seed, device)
        self.ref = DefectGanReference(
            config, make_weights(config, traffic, seed, device),
            Ops(precision, norm_calls), device)

    def rows(self, i: int) -> dict:
        return self.pool[i % len(self.pool)]

    def step(self, i: int) -> dict:
        return self.ref.super_step(self.rows(i))

    def answer(self, i: int):
        r = self.rows(i)
        return self.ref.generate(r["data"], r["labels"])

    def first_moment_norms(self) -> dict:
        return compare.norms(self.ref.first_moments())

    def leaves(self) -> dict:
        return self.ref.leaves()
