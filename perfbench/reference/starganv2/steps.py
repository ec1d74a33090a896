"""StarGAN v2's training iteration with AdaIN written out plainly, after
clovaai/stargan-v2 ``core/solver.py`` (``train``, ``compute_d_loss``,
``compute_g_loss``, ``r1_reg``, ``moving_average``):

  1. D on the latent pass: BCE(D(x_src) -> 1) + BCE(D(G(x_src, M(z_ref,
     y_ref))) -> 0) + lambda_reg * R1, R1 = 0.5 * E ||d sum D(x_src) /
     d x_src||^2, its gradient kept (a double backward); D's Adam.
  2. D on the reference pass, the style S(x_ref, y_ref).
  3. G on the latent pass: adv + lambda_sty * |S(x_fake) - s_trg| -
     lambda_ds * |x_fake - x_fake2| + lambda_cyc * |G(x_fake, S(x_src,
     y_src)) - x_src|, x_fake2 from z_ref2 without gradient; the Adams of
     G, M and S.
  4. G on the reference pass (styles from x_ref, x_ref2); G's Adam alone.
  5. EMA (beta 0.999) of G, M and S.

Adam (beta1 0, beta2 0.99), lr 1e-4 and f_lr 1e-6 for M, with weight decay
1e-4 added to the gradient (torch.optim.Adam's coupled decay); lambda_ds
decays linearly, 2 * (1 - iteration / ds_iter). The numbers come from the
configuration file.

Departures from the source, none of which changes the mathematics: the
batch is given (the source draws it from its loaders each iteration), the
iteration count starts at 0, no DiffAugment, checkpoint or sample is made,
and the Adams can be resumed from a given state (``resume``), as a run
resumed from a checkpoint is.
"""
from __future__ import annotations

from typing import Dict

import torch

from perfbench.reference.common import Adam, Ops, bce_logits, grads_of, l1
from perfbench.reference.starganv2 import nets

NETS = ("G", "M", "S", "D")
EMA_NETS = ("G", "M", "S")


def shapes(m: dict) -> Dict[str, Dict[str, tuple]]:
    """Parameter shapes by network and name."""
    return {"G": nets.generator_shapes(m), "M": nets.mapping_shapes(m),
            "S": nets.style_encoder_shapes(m),
            "D": nets.discriminator_shapes(m)}


class CoupledAdam(Adam):
    """Adam with L2 weight decay added to the gradient before the moments
    (torch.optim.Adam's ``weight_decay``, as the source's optimizers). It
    keeps its first moments after its first update here, whatever count it
    was resumed at."""

    def __init__(self, params, lr: float, betas, weight_decay: float):
        super().__init__(params, lr, betas)
        self.weight_decay = weight_decay

    def resume(self, count: int, exp_avg_sq: Dict[str, torch.Tensor]) -> None:
        """As after ``count`` updates, with the second moments
        ``exp_avg_sq`` by name; the first moments are left as they are,
        since with beta1 0 no update depends on them."""
        self.count = count
        for k, v in exp_avg_sq.items():
            self.exp_avg_sq[k].copy_(v)

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        first = self.first is None
        super().step({k: g + self.weight_decay * self.params[k]
                      for k, g in grads.items()})
        if first:
            self.first = {k: m.clone() for k, m in self.exp_avg.items()}


def r1(out: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """r1_reg (solver.py): 0.5 * the batch mean of ||d sum(out) / dx||^2,
    differentiable in D's parameters."""
    (g,) = torch.autograd.grad(out.sum(), x, create_graph=True)
    return 0.5 * g.square().sum() / x.shape[0]


class StarGANv2Reference:
    """Holds the parameters of G, M, S and D (float32, by network and name),
    the EMA copies of G, M and S, an Adam a network and the iteration
    count."""

    def __init__(self, config: dict, params: Dict[str, Dict[str, torch.Tensor]],
                 ops: Ops):
        self.m, self.t = config["model"], config["train"]
        self.ops = ops
        self.P = {n: {k: v.detach().clone().float().requires_grad_()
                      for k, v in params[n].items()} for n in NETS}
        self.E = {n: {k: v.detach().clone().float() for k, v in params[n].items()}
                  for n in EMA_NETS}
        t = self.t
        betas = (t["beta1"], t["beta2"])
        self.adam = {n: CoupledAdam(self.P[n], t["f_lr"] if n == "M" else t["lr"],
                                    betas, t["weight_decay"]) for n in NETS}
        self.count = 0

    def _g(self, x, s):
        return nets.generator(self.ops, self.m, self.P["G"], x, s)

    def _m(self, z, y):
        return nets.mapping(self.ops, self.m, self.P["M"], z, y)

    def _s(self, x, y):
        return nets.style_encoder(self.ops, self.m, self.P["S"], x, y)

    def _d(self, x, y):
        return nets.discriminator(self.ops, self.m, self.P["D"], x, y)

    def _style(self, b, which: str, latent: bool):
        if latent:
            return self._m(b[f"z_{which}"], b["y_ref"])
        return self._s(b[f"x_{which}"], b["y_ref"])

    def d_step(self, b, latent: bool) -> Dict[str, torch.Tensor]:
        x_real = b["x_src"].detach().requires_grad_()
        out = self._d(x_real, b["y_src"])
        real = bce_logits(out, 1.0)
        reg = r1(out, x_real)
        with torch.no_grad():
            x_fake = self._g(b["x_src"], self._style(b, "ref", latent))
        fake = bce_logits(self._d(x_fake, b["y_ref"]), 0.0)
        loss = real + fake + self.t["lambda_reg"] * reg
        self.adam["D"].step(grads_of(loss, self.P["D"]))
        return {"real": real.detach(), "fake": fake.detach(), "reg": reg.detach()}

    def lambda_ds(self) -> float:
        return max(0.0, self.t["lambda_ds"] * (1.0 - self.count / self.t["ds_iter"]))

    def g_step(self, b, latent: bool) -> Dict[str, torch.Tensor]:
        t = self.t
        x_real, y_org, y_trg = b["x_src"], b["y_src"], b["y_ref"]
        s_trg = self._style(b, "ref", latent)
        x_fake = self._g(x_real, s_trg)
        adv = bce_logits(self._d(x_fake, y_trg), 1.0)
        sty = l1(self._s(x_fake, y_trg), s_trg)
        with torch.no_grad():
            x_fake2 = self._g(x_real, self._style(b, "ref2", latent))
        ds = l1(x_fake, x_fake2)
        cyc = l1(self._g(x_fake, self._s(x_real, y_org)), x_real)
        loss = (adv + t["lambda_sty"] * sty - self.lambda_ds() * ds
                + t["lambda_cyc"] * cyc)
        updated = ("G", "M", "S") if latent else ("G",)
        params = {(n, k): v for n in updated for k, v in self.P[n].items()}
        grads = grads_of(loss, params)
        for n in updated:
            self.adam[n].step({k: grads[(n, k)] for k in self.P[n]})
        return {"adv": adv.detach(), "sty": sty.detach(), "ds": ds.detach(),
                "cyc": cyc.detach()}

    @torch.no_grad()
    def ema(self) -> None:
        beta = self.t["ema_beta"]
        for n in EMA_NETS:
            for k, e in self.E[n].items():
                e.lerp_(self.P[n][k], 1.0 - beta)

    def train_step(self, b: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One iteration on the batch ``b`` (NHWC ``x_src``, ``x_ref``,
        ``x_ref2``, int64 ``y_src``, ``y_ref``, ``z_ref``, ``z_ref2``): the
        loss terms under the program's names."""
        out: Dict[str, torch.Tensor] = {}
        for latent, tag in ((True, "latent"), (False, "ref")):
            out.update({f"D/{tag}_{k}": v for k, v in self.d_step(b, latent).items()})
        for latent, tag in ((True, "latent"), (False, "ref")):
            out.update({f"G/{tag}_{k}": v for k, v in self.g_step(b, latent).items()})
        self.ema()
        self.count += 1
        return out

    def resume(self, count: int,
               exp_avg_sq: Dict[str, Dict[str, torch.Tensor]]) -> None:
        """Each network's Adam as after ``count`` updates, with the second
        moments ``exp_avg_sq`` by network and name."""
        for n in NETS:
            self.adam[n].resume(count, exp_avg_sq[n])

    def first_moments(self) -> Dict[str, torch.Tensor]:
        """Adam's first moments by ``net.name``, each right after its
        network's first update by this object."""
        return {f"{n}.{k}": v for n in NETS for k, v in self.adam[n].first.items()}

    def leaves(self) -> Dict[str, torch.Tensor]:
        """The trained parameters and the EMA copies by ``net.name`` and
        ``ema_<net>.name``."""
        out = {f"{n}.{k}": v for n in NETS for k, v in self.P[n].items()}
        out.update({f"ema_{n}.{k}": v for n in EMA_NETS for k, v in self.E[n].items()})
        return out
