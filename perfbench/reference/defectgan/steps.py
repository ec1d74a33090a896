"""DefectGAN's training super-step and serving call, written out plainly:
``num_critics`` discriminator updates, one per row of the super-batch, then
one generator-and-extractor update on the last row (the double cycle
normal -> defect -> normal and defect -> normal -> defect in one 2B forward
a hop, BatchNorm statistics kept a direction), with Adam (0.5, 0.999) at
the configured learning rates. Serving: E encodes the image, G paints the
label's defect.
"""
from __future__ import annotations

from typing import Dict

import torch

from perfbench.reference.common import Adam, Ops, bce_logits, grads_of, l1
from perfbench.reference.defectgan import nets

NETS = ("G", "E", "D")


def shapes(m: dict) -> Dict[str, Dict[str, tuple]]:
    """Parameter shapes by network and name."""
    return {"G": nets.generator_shapes(m), "E": nets.extractor_shapes(m),
            "D": nets.discriminator_shapes(m)}


class DefectGanReference:
    """Holds the parameters (float32, by network and name), G's BatchNorm
    statistics and an optimizer for each network given (serving gives G
    and E alone)."""

    def __init__(self, config: dict, params: Dict[str, Dict[str, torch.Tensor]],
                 ops: Ops, device):
        self.m, self.t = config["model"], config["train"]
        self.ops = ops
        self.P = {n: {k: v.detach().clone().float().requires_grad_()
                      for k, v in params[n].items()} for n in NETS if n in params}
        self.B = nets.generator_buffers(self.m, device)
        lr = self.t["lr"]
        betas = tuple(self.t["betas"])
        self.adam = {n: Adam(self.P[n], lr[0] if n == "D" else lr[-1], betas)
                     for n in self.P}

    def _g(self, x, style, train=False, groups=1):
        return nets.generator(self.ops, self.m, self.P["G"], self.B, x, style,
                              train, groups)

    def _e(self, x):
        return nets.extractor(self.ops, self.m, self.P["E"], x)

    def _d(self, x):
        return nets.discriminator(self.ops, self.m, self.P["D"], x)

    def generate(self, data, labels):
        """Eval-mode serving: (out, prob) NHWC."""
        with torch.no_grad():
            return self._g(data, self._e(data))

    def d_step(self, bg, df, df_labels) -> Dict[str, torch.Tensor]:
        w = self.t["loss_weight"]
        nm_labels = nets.normal_labels(df_labels)
        b = bg.shape[0]
        with torch.no_grad():
            nm_feat, df_feat = self._e(bg), self._e(df)
            fakes, _ = self._g(nets.cat(bg, df), nets.cat(df_feat, nm_feat))
        src, cls = self._d(nets.cat(fakes[:b], fakes[b:], df, bg))
        fd, fn, rd, rn = src.split(b)
        gan = (bce_logits(fd, 0.0) + bce_logits(fn, 0.0) + bce_logits(rd, 1.0)
               + bce_logits(rn, 1.0)) / 4.0
        clf = (bce_logits(cls[2 * b:3 * b], df_labels)
               + bce_logits(cls[3 * b:], nm_labels)) / 2.0
        self.adam["D"].step(grads_of(gan + clf * w[0], self.P["D"]))
        return {"gan_D": gan.detach(), "clf_D": clf.detach()}

    def g_step(self, bg, df, df_labels) -> Dict[str, torch.Tensor]:
        _, w_clf, w_rec, w_cyc, w_con = self.t["loss_weight"]
        nm_labels = nets.normal_labels(df_labels)
        b = bg.shape[0]
        nm_feat, df_feat = self._e(bg), self._e(df)
        h1, h1_p = self._g(nets.cat(bg, df), nets.cat(df_feat, nm_feat), True, 2)
        h2, h2_p = self._g(h1, nets.cat(nm_feat, df_feat), True, 2)
        fake_df, fake_nm = h1[:b], h1[b:]
        p_df, p_nm = h1_p[:b], h1_p[b:]
        rec_nm, rec_df = h2[:b], h2[b:]
        p_rec_df, p_rec_nm = h2_p[:b], h2_p[b:]
        src, cls = self._d(nets.cat(fake_df, fake_nm))
        gan = (bce_logits(src[:b], 1.0) + bce_logits(src[b:], 1.0)) / 2.0
        clf = (bce_logits(cls[:b], df_labels)
               + bce_logits(cls[b:], nm_labels)) / 2.0
        rec = (l1(rec_df, df) + l1(rec_nm, bg)) / 2.0
        sd_cyc = (l1(p_df, p_rec_df) + l1(p_nm, p_rec_nm)) / 2.0
        sd_con = (p_df.abs().mean() + p_nm.abs().mean() + p_rec_df.abs().mean()
                  + p_rec_nm.abs().mean()) / 4.0
        loss = gan + clf * w_clf + rec * w_rec + sd_cyc * w_cyc + sd_con * w_con
        params = {**{("G", k): v for k, v in self.P["G"].items()},
                  **{("E", k): v for k, v in self.P["E"].items()}}
        grads = grads_of(loss, params)
        for net in ("G", "E"):
            self.adam[net].step({k: grads[(net, k)] for k in self.P[net]})
        return {"gan_G": gan.detach(), "clf_G": clf.detach(),
                "rec": rec.detach(), "sd_cyc": sd_cyc.detach(),
                "sd_con": sd_con.detach()}

    def super_step(self, rows: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """rows: ``bg``, ``df`` (critics, B, H, W, C) and ``df_labels``
        (critics, B, label_nc). Returns the D terms averaged over the
        critics and the G terms."""
        n = rows["bg"].shape[0]
        d = [self.d_step(rows["bg"][i], rows["df"][i], rows["df_labels"][i])
             for i in range(n)]
        out = {k: torch.stack([x[k] for x in d]).mean() for k in d[0]}
        out.update(self.g_step(rows["bg"][-1], rows["df"][-1],
                               rows["df_labels"][-1]))
        return out

    def first_moments(self) -> Dict[str, torch.Tensor]:
        """Adam's first moments by ``net.name``, each right after its
        network's first update."""
        return {f"{n}.{k}": v for n in self.adam
                for k, v in self.adam[n].first.items()}

    def leaves(self) -> Dict[str, torch.Tensor]:
        """The trained parameters by ``net.name``."""
        return {f"{n}.{k}": v for n in self.P for k, v in self.P[n].items()}
