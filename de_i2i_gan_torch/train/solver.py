"""StarGAN v2 solver, counterpart of ``de_i2i_gan_tpu/train/solver.py``.

Mirrors stargan-v2/core/solver.py:
  * per-net Adam (betas 0/0.99, coupled weight decay 1e-4; ``f_lr`` for the
    mapping network; solver.py:48-56, main.py defaults)
  * D loss = BCE(real->1) + BCE(fake->0) + lambda_reg * R1 (solver.py:467-491)
  * G loss = adv + lambda_sty * style-recon - lambda_ds * diversity +
    lambda_cyc * cycle (solver.py:494-546)
  * AdaIN runs a latent-guided and a reference-guided pass an iteration
    (solver.py:266-298); SEAN runs the reference pass only
  * EMA of G (and M, S for AdaIN) with beta 0.999 (solver.py:549-563), and
    of SEAN's statistics; lambda_ds decays linearly to 0 over ds_iter
    iterations, read from the step counter
  * FusedProp (``cfg.fused_prop``, opt-in): each D+G pair shares one fake
    forward, with simultaneous-update semantics

The solver holds the generator G, the mapping network M and the style
encoder S (AdaIN only) and their EMA copies on one device; the first
training call builds the discriminator D and the four optimizers
(``init_training``), so a solver that only serves holds neither. Style
codes (core/utils.py:485-516 get_style_code): AdaIN takes M(z, y) for a
latent style or S(x_ref, y) for a reference style; SEAN takes the caller's
frozen-ViT embeddings of the reference images (``s_ref``, ``s_ref2``,
``s_src`` in the batch), or noise that samples its running styles
(``inference_stats``). SEAN's running styles are buffers of each
generator: G's hold the JAX state's ``G.state["sean_stats"]``, ``ema_G``'s
its ``ema_sean_stats``.

JAX threads an immutable ``SolverState`` through pure functions; here the
modules and optimizers hold the state and the steps update it in place.
``step`` counts iterations, as ``state.step`` does. DiffAugment draws come
from the ``generator`` a call is given, or torch's default generator of the
device. The serving methods (``style``, ``generate``, ``track_stats_step``,
``finalize_ema_stats``) run under ``torch.inference_mode()``.

The frozen nets (``set_frozen_nets``, JAX :145): with the ViT, SEAN's
lambda_sty term embeds x_fake through it (solver.py:515), its gradient
reaching G through x_fake and never the ViT's parameters; with the FAN and
``w_hpf > 0``, ``train_step`` takes the masks of x_src (the reference's
``fan.get_heatmap(x_real)``, solver.py:263) and the cycle pass those of
x_fake (solver.py:529), both without gradients. Without them SEAN and the
masked cycle need ``allow_degraded_losses``, as in JAX.

MAE pretraining (solver.py:98-204, compute_mae_{d,g}_loss :413-464, the
JAX solver's ``pretrain_step``): ``init_pretrain`` adds a mask token that
trains with G's optimizer, and ``pretrain_step`` runs D latent, D ref, G
latent, G ref on the repair of ``x_ref`` (shifted patch masks, the token's
fill, G with the style of the pass), R1 on the real images, lambda_ds from
the step, then the EMA of G. Its checkpoint keeps G as the bare
generator's and the token apart, so ``--pretrain_dir`` restores G and
``ema_G`` into a train run (the JAX state nests them under ``net`` and
restores neither). SEAN pretrains on the reference pass alone, its style
term through the frozen ViT when one is attached (else none, as in JAX).
"""
from __future__ import annotations

import copy
import dataclasses
import logging
from typing import Dict, Optional, Tuple

import torch

from de_i2i_gan_torch.losses.common import bce_logits, l1, r1_penalty
from de_i2i_gan_torch.models import wing
from de_i2i_gan_torch.models.starganv2 import (
    Generator, MappingNetwork, SEANv2, StarGANv2Discriminator, StyleEncoder,
    sean_v2_update_stats)
from de_i2i_gan_torch.nn.blocks import MaskToken
from de_i2i_gan_torch.nn.conv_grad import differentiated_twice
from de_i2i_gan_torch.train import graphed
from de_i2i_gan_torch.train.optim import ema_update, make_solver_optimizer
from de_i2i_gan_torch.utils import profiling
from de_i2i_gan_torch.utils.diffaug import diff_augment
from de_i2i_gan_torch.utils.masks import generate_shifted_mask

Batch = Dict[str, torch.Tensor]
SEAN_STATS = ("mean", "std", "sum", "sumsq", "count")


@dataclasses.dataclass(frozen=True)
class StarGANv2Config:
    """main.py:150-267 defaults; the same fields and defaults as the JAX
    package's, with ``dtype`` a ``torch.dtype``."""

    img_size: int = 256
    num_domains: int = 2
    latent_dim: int = 16
    hidden_nc: int = 256
    style_dim: int = 64
    embed_nc: int = 768
    norm_type: str = "adain"  # adain | sean
    w_hpf: float = 1.0
    max_conv_dim: int = 512
    lambda_reg: float = 1.0
    lambda_cyc: float = 1.0
    lambda_sty: float = 1.0
    lambda_ds: float = 1.0
    lambda_rec: float = 10.0  # MAE pretrain reconstruction (main.py:175)
    ds_iter: int = 100_000
    total_iters: int = 100_000
    batch_size: int = 8
    lr: float = 1e-4
    f_lr: float = 1e-6
    beta1: float = 0.0
    beta2: float = 0.99
    weight_decay: float = 1e-4
    num_embeds: int = 5
    diff_aug: str = ""
    ema_beta: float = 0.999
    fused_prop: bool = False
    compute_dtype: str = "float32"
    allow_degraded_losses: bool = False

    @property
    def dtype(self) -> torch.dtype:
        dt = getattr(torch, self.compute_dtype, None)
        if not isinstance(dt, torch.dtype):
            raise ValueError(f"unknown compute_dtype {self.compute_dtype!r}")
        return dt

    def replace(self, **kw) -> "StarGANv2Config":
        return dataclasses.replace(self, **kw)


class StarGANv2Solver:
    """The nets, their EMA copies and the optimizers of StarGAN v2; see the
    module's docstring.

    On a CUDA device, without a process group, with AdaIN and neither
    FusedProp nor a high-pass (``w_hpf`` 0), ``train_step`` replays its
    iteration (``_super_step``: the four updates with each net's Adam, R1's
    create-graph gradient and its double backward, the EMA) as one CUDA
    graph (``train/graphed.py``): a batch shape's first call runs eagerly,
    its second captures the iteration and replays it, later calls replay;
    other shapes, SEAN, FusedProp, the FAN's masks, data parallel and
    ``pretrain_step`` run eagerly. The G loss's ``lambda_ds`` decays with
    ``step`` every iteration; read as a Python float it would be baked into
    the graph at its capture value, so the graph reads it from a device
    slot (``graph_scalars``) that the host fills from ``_lambda_ds(step)``
    before every replay, as it fills each learning rate."""

    # what a checkpoint holds (train/checkpoint.py::train_state)
    STATE_NETS = ("G", "D", "M", "S", "ema_G", "ema_M", "ema_S")
    STATE_OPTIMIZERS = ("G", "D", "M", "S")
    dp_group = None  # the ranks' group (parallel/mesh.py::make_parallel_step)

    def __init__(self, cfg: StarGANv2Config, device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        adain = cfg.norm_type == "adain"
        self.G = Generator(cfg.img_size, cfg.style_dim, cfg.max_conv_dim,
                           cfg.w_hpf, cfg.norm_type, cfg.embed_nc,
                           cfg.num_domains, cfg.hidden_nc, dtype=cfg.dtype)
        self.M = MappingNetwork(cfg.latent_dim, cfg.style_dim, cfg.num_domains,
                                dtype=cfg.dtype) if adain else None
        self.S = StyleEncoder(cfg.img_size, cfg.style_dim, cfg.num_domains,
                              cfg.max_conv_dim, dtype=cfg.dtype) if adain else None
        for name in ("G", "M", "S"):
            net = getattr(self, name)
            if net is not None:
                net.to(self.device).eval()
            ema = copy.deepcopy(net)
            setattr(self, f"ema_{name}",
                    None if ema is None else ema.requires_grad_(False))
        self.D = None
        self.tx_G = self.tx_D = self.tx_M = self.tx_S = None
        self.token = None  # the MAE mask token, in pretrain mode
        self.vit = self.fan = None  # the frozen nets (set_frozen_nets)
        self.step = 0  # iterations
        self._warned = set()
        self._graph = graphed.SuperStepGraph()

    def set_frozen_nets(self, vit=None, fan=None) -> None:
        """Attach the frozen ViT (``models/vit.py::ViTEncoder``, run in the
        solver's compute dtype, as the JAX solver builds it) and/or the FAN
        (``models/wing.py::FAN``) so that the G loss is the reference's:
        SEAN's style reconstruction embeds x_fake through the ViT, and with
        ``w_hpf > 0`` the masks come from the FAN."""
        if vit is not None:
            vit = vit.to(self.device).requires_grad_(False)
            if vit.dtype != self.cfg.dtype:
                vit = vit.frozen_copy(self.cfg.dtype)
            self.vit = vit.eval()
        if fan is not None:
            self.fan = fan.to(self.device).eval().requires_grad_(False)

    def _embed_fake(self, x_fake: torch.Tensor) -> torch.Tensor:
        """The frozen ViT's CLS embedding of x_fake, (N, 1, hidden) (JAX
        :174); differentiable in x_fake only. Its ops run in the profiler
        range ``solver.embed_fake``."""
        with profiling.span("solver.embed_fake"):
            return self.vit(x_fake)[:, 0, :][:, None, :]

    def _heatmaps(self, x: torch.Tensor):
        """FAN get_heatmap of NHWC x (wing.py:248-261, JAX ``_heatmaps_fake``
        :186): the two masks, without gradients, in the profiler range
        ``solver.heatmaps``."""
        with profiling.span("solver.heatmaps"):
            return wing.fan_masks(self.fan, x.detach())

    def nets(self) -> Dict[str, torch.nn.Module]:
        """The solver's serving networks by name: G, M, S and their EMA
        copies."""
        return {name: getattr(self, name)
                for name in ("G", "M", "S", "ema_G", "ema_M", "ema_S")
                if getattr(self, name) is not None}

    def _as(self, t: Optional[torch.Tensor], dtype=None):
        return None if t is None else torch.as_tensor(t, dtype=dtype,
                                                      device=self.device)

    # ------------------------------------------------------------- serving
    @torch.inference_mode()
    def style(self, batch: Dict[str, torch.Tensor], y_trg: torch.Tensor, *,
              which: str = "ref", latent: bool, use_ema: bool = False
              ) -> torch.Tensor:
        """get_style_code (utils.py:485-516; the JAX solver's ``_style``):
        AdaIN maps ``batch["z_<which>"]`` through M (``latent``) or encodes
        the NHWC images ``batch["x_<which>"]`` through S; SEAN returns the
        embeddings ``batch["s_<which>"]``. ``use_ema`` takes the EMA nets, as
        sampling does."""
        y_trg = self._as(y_trg, torch.int64)
        if self.cfg.norm_type == "adain":
            if latent:
                net = self.ema_M if use_ema else self.M
                return net(self._as(batch[f"z_{which}"]), y_trg)
            net = self.ema_S if use_ema else self.S
            return net(self._as(batch[f"x_{which}"]), y_trg)
        return self._as(batch[f"s_{which}"])

    @torch.inference_mode()
    def generate(self, x: torch.Tensor, s: torch.Tensor, y: torch.Tensor,
                 masks=None, use_ema: bool = True, **kw) -> torch.Tensor:
        """Translate the NHWC images ``x`` to domains ``y`` with style ``s``;
        ``use_ema`` takes the EMA generator and its running styles. ``kw``:
        ``layer_split_index``, and for SEAN ``inference_stats``,
        ``std_weight`` and ``mix_alpha``."""
        G = self.ema_G if use_ema else self.G
        return G(self._as(x), self._as(s), masks,
                 labels=self._as(y, torch.int64), **kw)

    @torch.inference_mode()
    def track_stats_step(self, x: torch.Tensor, s: torch.Tensor,
                         y: torch.Tensor, masks=None) -> None:
        """One tracking forward of the EMA generator, the body of the
        ``update_stats`` CLI mode (solver.py:379-406): the style codes land
        in ``ema_G``'s SEANv2 accumulators."""
        self.ema_G(self._as(x), self._as(s), masks,
                   labels=self._as(y, torch.int64), track_stats=True)

    @torch.inference_mode()
    def finalize_ema_stats(self) -> None:
        """Finalize the EMA running styles after an update_stats sweep (over
        the ranks' sweeps, with a process group)."""
        sean_v2_update_stats(self.ema_G, group=self.dp_group)

    # ------------------------------------------------------------ training
    def init_training(self) -> None:
        """Build D and the optimizers; a no-op once they exist."""
        if self.D is not None:
            return
        cfg = self.cfg
        self.D = StarGANv2Discriminator(cfg.img_size, cfg.num_domains,
                                        cfg.max_conv_dim, dtype=cfg.dtype
                                        ).to(self.device).eval()

        def adam(params, lr):
            return make_solver_optimizer(params, lr, (cfg.beta1, cfg.beta2),
                                         cfg.weight_decay)

        # a mask token (pretrain mode) trains with G's optimizer
        token = self.token.parameters() if self.token is not None else ()
        self.tx_G = adam([*self.G.parameters(), *token], cfg.lr)
        self.tx_D = adam(self.D.parameters(), cfg.lr)
        if self.M is not None:
            self.tx_M = adam(self.M.parameters(), cfg.f_lr)
            self.tx_S = adam(self.S.parameters(), cfg.lr)

    def _batch(self, batch) -> Batch:
        """The batch's arrays on the device, domain labels as int64, the
        masks a list."""
        def on(v):
            if isinstance(v, (list, tuple)):
                return [torch.as_tensor(m, device=self.device) for m in v]
            return torch.as_tensor(v, device=self.device)

        return {k: on(v).long() if k.startswith("y_") else on(v)
                for k, v in batch.items()}

    def _warn_once(self, key: str, msg: str) -> None:
        if key not in self._warned:
            self._warned.add(key)
            logging.getLogger(__name__).warning(msg)

    def _code(self, batch: Batch, y: torch.Tensor, which: str,
              latent: bool) -> torch.Tensor:
        """The training nets' style code (the JAX ``_style``)."""
        if self.cfg.norm_type == "adain":
            if latent:
                return self.M(batch[f"z_{which}"], y)
            return self.S(batch[f"x_{which}"], y)
        return batch[f"s_{which}"]

    def _lambda_ds(self, step: int) -> float:
        cfg = self.cfg
        return max(0.0, cfg.lambda_ds * (1.0 - step / max(cfg.ds_iter, 1)))

    @staticmethod
    def _r1(out: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """R1 of D's output ``out`` on ``x``, its ``create_graph`` gradient
        in the span ``sgv2.r1``."""
        with profiling.span("sgv2.r1"):
            return r1_penalty(out, x)

    def _d_grads(self, loss: torch.Tensor):
        """D's gradients of ``loss`` (R1's double backward included), in the
        span ``train.backward``."""
        with profiling.span("train.backward"):
            return torch.autograd.grad(loss, self.tx_D.params)

    def d_loss_fn(self, batch: Batch, *, latent: bool,
                  x_fake: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """As the JAX ``d_loss_fn``: (loss, {real, fake, reg}) with D's graph.
        R1 takes the gradient of D's real logits w.r.t. the augmented real
        images in one D forward, which runs inside
        ``differentiated_twice()`` (``nn/conv_grad.py``: R1's double
        backward takes its weight terms from cuDNN's wgrad). The fakes come
        from G without gradients unless ``x_fake`` (FusedProp's shared
        forward, detached) is given."""
        cfg = self.cfg
        x_real, y_org, y_trg = batch["x_src"], batch["y_src"], batch["y_ref"]
        x_real_aug = diff_augment(x_real, cfg.diff_aug, generator
                                  ).detach().requires_grad_()
        with differentiated_twice():
            out_real = self.D(x_real_aug, y_org)
        loss_real = bce_logits(out_real, torch.ones_like(out_real))
        loss_reg = self._r1(out_real, x_real_aug)
        if x_fake is None:
            with torch.no_grad():
                s_trg = self._code(batch, y_trg, "ref", latent)
                x_fake = self.G(x_real, s_trg, batch.get("masks"), labels=y_trg)
        x_fake = diff_augment(x_fake.detach(), cfg.diff_aug, generator)
        out_fake = self.D(x_fake, y_trg)
        loss_fake = bce_logits(out_fake, torch.zeros_like(out_fake))
        loss = loss_real + loss_fake + cfg.lambda_reg * loss_reg
        return loss, {"real": loss_real, "fake": loss_fake, "reg": loss_reg}

    def g_loss_fn(self, batch: Batch, *, latent: bool,
                  shared_fake: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                  generator: Optional[torch.Generator] = None
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """As the JAX ``g_loss_fn``: (loss, {adv, sty, ds, cyc}) with the graph
        of G (and M, S for AdaIN). D and S score the fakes; D's parameters
        are not differentiated by the caller. The SEAN reference pass tracks
        its statistics on x_fake and x_fake2. ``shared_fake``: FusedProp's
        (s_trg, x_fake)."""
        cfg = self.cfg
        adain = cfg.norm_type == "adain"
        x_real, y_org, y_trg = batch["x_src"], batch["y_src"], batch["y_ref"]
        masks = batch.get("masks")
        track = not latent and not adain
        if shared_fake is None:
            s_trg = self._code(batch, y_trg, "ref", latent)
            x_fake = self.G(x_real, s_trg, masks, labels=y_trg,
                            track_stats=track)
        else:
            s_trg, x_fake = shared_fake
        out = self.D(diff_augment(x_fake, cfg.diff_aug, generator), y_trg)
        loss_adv = bce_logits(out, torch.ones_like(out))

        # style reconstruction (solver.py:515-517)
        if adain:
            loss_sty = l1(self.S(x_fake, y_trg), s_trg)
        elif self.vit is not None:
            # the frozen ViT's embedding of x_fake, (N, 1, E) against the
            # (N, k, E) reference embeddings
            loss_sty = l1(self._embed_fake(x_fake), s_trg)
        else:
            s_pred = batch.get("s_fake_pred")
            if s_pred is None:
                msg = ("sean mode without the frozen ViT: the lambda_sty "
                       "style-reconstruction loss is INACTIVE (reference "
                       "solver.py:515 embeds x_fake through it)")
                if not cfg.allow_degraded_losses:
                    raise ValueError(
                        msg + ". Refusing to train with a silently zeroed "
                        "loss term; pass --vit_path (or set_frozen_nets), or "
                        "set StarGANv2Config.allow_degraded_losses to "
                        "proceed.")
                self._warn_once("sean_sty", msg)
                loss_sty = torch.zeros((), device=self.device)
            else:
                loss_sty = l1(s_pred, s_trg)

        # diversity-sensitive loss (solver.py:519-527); x_fake2 takes no
        # gradient (the JAX stop_gradient), so its forward keeps no graph
        with torch.no_grad():
            x_fake2 = self.G(x_real, self._code(batch, y_trg, "ref2", latent),
                             masks, labels=y_trg, track_stats=track)
        loss_ds = l1(x_fake, x_fake2)

        # cycle consistency (solver.py:529-533): the reference recomputes
        # the masks from x_fake
        if cfg.w_hpf > 0 and self.fan is not None:
            masks_fake = self._heatmaps(x_fake)
        else:
            if cfg.w_hpf > 0 and masks is not None \
                    and "masks_fake" not in batch:
                msg = ("w_hpf > 0 without the FAN: the cycle pass reuses the "
                       "SOURCE masks instead of fan.get_heatmap(x_fake) "
                       "(reference solver.py:529)")
                if not cfg.allow_degraded_losses:
                    raise ValueError(
                        msg + ". Refusing to train with wrong cycle masks; "
                        "pass --wing_ckpt (or set_frozen_nets), or set "
                        "StarGANv2Config.allow_degraded_losses to proceed.")
                self._warn_once("cyc_masks", msg)
            masks_fake = batch.get("masks_fake", masks)
        s_org = self.S(x_real, y_org) if adain else batch["s_src"]
        x_rec = self.G(x_fake, s_org, masks_fake, labels=y_org)
        loss_cyc = l1(x_rec, x_real)

        loss = (loss_adv + cfg.lambda_sty * loss_sty -
                self._lambda_ds(self.step) * loss_ds +
                cfg.lambda_cyc * loss_cyc)
        return loss, {"adv": loss_adv, "sty": loss_sty, "ds": loss_ds,
                      "cyc": loss_cyc}

    def _step_generators(self, loss: torch.Tensor, latent: bool) -> None:
        """Update G, and M and S on the AdaIN latent pass (solver.py:283-298)
        only; the reference pass's S gradient is not taken."""
        txs = [self.tx_G]
        if latent and self.M is not None:
            txs += [self.tx_M, self.tx_S]
        with profiling.span("train.backward"):
            grads = torch.autograd.grad(
                loss, [p for tx in txs for p in tx.params],
                allow_unused=True, materialize_grads=True)
        start = 0
        for tx in txs:
            tx.step(grads[start:start + len(tx.params)])
            start += len(tx.params)

    def d_step(self, batch: Batch, latent: bool,
               generator: Optional[torch.Generator] = None
               ) -> Dict[str, torch.Tensor]:
        """One D update on the pass ``latent`` picks, in the span
        ``train.d_step``; the loss terms."""
        with profiling.span("train.d_step"):
            loss, metrics = self.d_loss_fn(batch, latent=latent,
                                           generator=generator)
            self.tx_D.step(self._d_grads(loss))
            return {k: v.detach() for k, v in metrics.items()}

    def g_step(self, batch: Batch, latent: bool,
               generator: Optional[torch.Generator] = None
               ) -> Dict[str, torch.Tensor]:
        """One G (and M, S) update against the current D, in the span
        ``train.g_step``; the loss terms."""
        with profiling.span("train.g_step"):
            loss, metrics = self.g_loss_fn(batch, latent=latent,
                                           generator=generator)
            self._step_generators(loss, latent)
            return {k: v.detach() for k, v in metrics.items()}

    def fused_pair_step(self, batch: Batch, latent: bool,
                        generator: Optional[torch.Generator] = None
                        ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        """FusedProp D+G pair (arxiv 2004.03335): one fake forward shared by
        both terms; D's gradients from the D term on the detached fakes,
        G's (and M's, S's) from the G term, each taken by its own
        ``torch.autograd.grad`` before any update (simultaneous-update
        semantics: the G term sees the D before its update)."""
        cfg = self.cfg
        x_real, y_trg = batch["x_src"], batch["y_ref"]
        track = not latent and cfg.norm_type == "sean"
        s_trg = self._code(batch, y_trg, "ref", latent)
        x_fake = self.G(x_real, s_trg, batch.get("masks"), labels=y_trg,
                        track_stats=track)
        ld, dm = self.d_loss_fn(batch, latent=latent, x_fake=x_fake.detach(),
                                generator=generator)
        lg, gm = self.g_loss_fn(batch, latent=latent,
                                shared_fake=(s_trg, x_fake), generator=generator)
        d_grads = self._d_grads(ld)
        self._step_generators(lg, latent)
        self.tx_D.step(d_grads)
        return ({k: v.detach() for k, v in dm.items()},
                {k: v.detach() for k, v in gm.items()})

    @torch.no_grad()
    def _ema(self) -> None:
        """EMA of the nets (solver.py:549-563) and of all five SEAN
        statistics of G (accumulators included), in the span ``sgv2.ema``."""
        beta = self.cfg.ema_beta
        with profiling.span("sgv2.ema"):
            for name in ("G", "M", "S"):
                net = getattr(self, name)
                if net is not None:
                    ema_update(getattr(self, f"ema_{name}").parameters(),
                               net.parameters(), beta)
            for e, g in zip(self.ema_G.modules(), self.G.modules()):
                if isinstance(g, SEANv2):
                    for stat in SEAN_STATS:
                        getattr(e, stat).lerp_(getattr(g, stat), 1.0 - beta)

    def train_step(self, batch, generator: Optional[torch.Generator] = None
                   ) -> Dict[str, torch.Tensor]:
        """One reference iteration (solver.py:258-313): AdaIN runs D latent,
        D ref, G latent, G ref; SEAN D ref and G ref; FusedProp a pair per
        pass. Then the EMA updates and the step count. ``batch``: NHWC
        ``x_src``, ``x_ref``, ``x_ref2``, domains ``y_src``, ``y_ref``, and
        ``z_ref``, ``z_ref2`` (AdaIN) or ``s_ref``, ``s_ref2``, ``s_src``
        (SEAN), and the two NHWC ``masks`` of ``w_hpf > 0``, which the FAN
        makes from x_src when attached and the batch has none. Returns the
        loss terms under the JAX names as 0-d tensors. The iteration is the
        span ``train.super_step``, the root of the spans inside it. Where
        ``train/graphed.py`` finds the call eligible, it replays the
        iteration as a CUDA graph captured on an earlier call of the same
        shapes (see the class's docstring)."""
        self.init_training()
        with profiling.span("train.super_step"):
            batch = self._batch(batch)
            if self.cfg.w_hpf > 0 and self.fan is not None \
                    and "masks" not in batch:
                batch["masks"] = self._heatmaps(batch["x_src"])
            metrics = None
            if graphed.eligible(self, generator):
                metrics = self._graph(self, batch, generator)
            if metrics is None:
                graphed.count_eager()
                metrics = self._super_step(batch, generator)
        self.step += 1
        metrics["G/lambda_ds"] = torch.tensor(self._lambda_ds(self.step))
        return metrics

    def _super_step(self, batch: Batch, generator: Optional[torch.Generator]
                    ) -> Dict[str, torch.Tensor]:
        """The iteration's body, eager: the updates of each pass, then the
        EMA; what a graph captures."""
        passes = ((True, "latent"), (False, "ref")) if self.M is not None \
            else ((False, "ref"),)
        metrics = {}
        if self.cfg.fused_prop:
            for latent, tag in passes:
                dm, gm = self.fused_pair_step(batch, latent, generator)
                metrics.update({f"D/{tag}_{k}": v for k, v in dm.items()})
                metrics.update({f"G/{tag}_{k}": v for k, v in gm.items()})
        else:
            for latent, tag in passes:
                m = self.d_step(batch, latent, generator)
                metrics.update({f"D/{tag}_{k}": v for k, v in m.items()})
            for latent, tag in passes:
                m = self.g_step(batch, latent, generator)
                metrics.update({f"G/{tag}_{k}": v for k, v in m.items()})
        self._ema()
        return metrics

    def graph_ready(self) -> bool:
        """What ``graphed.eligible`` asks of the solver besides the call:
        AdaIN (SEAN's statistics and frozen ViT are not held to a replay),
        no FusedProp, and ``w_hpf`` 0 (no FAN heatmaps inside the
        iteration, no masks in the batch)."""
        cfg = self.cfg
        return (cfg.norm_type == "adain" and not cfg.fused_prop
                and cfg.w_hpf == 0)

    def graph_optimizers(self):
        """The four optimizers, by net."""
        return [(n, getattr(self, f"tx_{n}")) for n in self.STATE_OPTIMIZERS
                if getattr(self, f"tx_{n}") is not None]

    def graph_scalars(self):
        """The G loss's ``lambda_ds``, a host float of ``step`` that a
        graph reads from a slot (see the class's docstring)."""
        return [(self, "_lambda_ds", self.step)]

    @torch.no_grad()
    def update_sean_stats(self) -> None:
        """Finalize G's SEAN running styles (solver.py:552), after the
        iteration's EMA of the statistics (over the ranks' codes, with a
        process group)."""
        sean_v2_update_stats(self.G, group=self.dp_group)

    # ------------------------------------------------------------- pretrain
    def init_pretrain(self, mask_ratio: float = 0.75, patch_size: int = 8,
                      mask_token_type: str = "position") -> None:
        """Pretrain mode (the JAX ``init_pretrain_state``): a mask token
        over 3-channel images of ``img_size``, trained by ``tx_G``, and in
        the checkpoint as ``token``. Call before the first training call."""
        if self.D is not None:
            raise RuntimeError("init_pretrain comes before init_training: "
                               "G's optimizer must hold the token")
        self._mae = (mask_ratio, patch_size)
        self.token = MaskToken(mask_token_type, mask_ratio, 3,
                               self.cfg.img_size).to(self.device)
        self.STATE_NETS = (*type(self).STATE_NETS, "token")

    def _repair(self, x_real: torch.Tensor, s: torch.Tensor, y: torch.Tensor,
                masks, generator: Optional[torch.Generator]) -> torch.Tensor:
        """The repair of ``x_real`` (utils.py repair_mask :579-585): a shifted
        patch mask, the token's fill, G with style ``s`` for domains ``y``."""
        mask_ratio, patch_size = self._mae
        b, h, w, _ = x_real.shape
        mae_mask = generate_shifted_mask(b, h, w, patch_size, mask_ratio,
                                         generator, x_real.device)
        return self.G(self.token(x_real, mae_mask), s, masks, labels=y)

    def mae_d_loss_fn(self, batch: Batch, *, latent: bool,
                      generator: Optional[torch.Generator] = None
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """As the JAX ``mae_d_loss_fn``: (loss, {real, fake, reg}) with D's
        graph; R1 on the real ``x_ref`` (no augmentation; its D forward
        inside ``differentiated_twice()``), the repair without gradients."""
        cfg = self.cfg
        x_real, y_org = batch["x_ref"], batch["y_ref"]
        x_req = x_real.detach().requires_grad_()
        with differentiated_twice():
            out_real = self.D(x_req, y_org)
        loss_real = bce_logits(out_real, torch.ones_like(out_real))
        loss_reg = self._r1(out_real, x_req)
        with torch.no_grad():
            s = self._code(batch, y_org, "ref", latent)
            x_fake = self._repair(x_real, s, y_org, batch.get("masks"),
                                  generator)
        out_fake = self.D(x_fake, y_org)
        loss_fake = bce_logits(out_fake, torch.zeros_like(out_fake))
        loss = loss_real + loss_fake + cfg.lambda_reg * loss_reg
        return loss, {"real": loss_real, "fake": loss_fake, "reg": loss_reg}

    def mae_g_loss_fn(self, batch: Batch, *, latent: bool,
                      generator: Optional[torch.Generator] = None
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """As the JAX ``mae_g_loss_fn``: (loss, {adv, sty, rec, ds}) with the
        graph of G, the token, M and S: adv + lambda_sty * style
        reconstruction of the repaired image + lambda_rec * L1 to x_ref +
        lambda_ds * |S(x_ref) - S(x_ref2)|. SEAN's style term embeds the
        repair through the frozen ViT (none without it), and it has no
        diversity term."""
        cfg = self.cfg
        x_real, y_org = batch["x_ref"], batch["y_ref"]
        s = self._code(batch, y_org, "ref", latent)
        x_fake = self._repair(x_real, s, y_org, batch.get("masks"), generator)
        out = self.D(x_fake, y_org)
        loss_adv = bce_logits(out, torch.ones_like(out))
        zero = torch.zeros((), device=self.device)
        # style reconstruction on the repaired image (solver.py:444-446)
        if cfg.norm_type == "adain":
            s_pred = (self.M(batch["z_ref"], y_org) if latent
                      else self.S(x_fake, y_org))
            loss_sty = l1(s_pred, s)
            loss_ds = l1(self.S(x_real, y_org), self.S(batch["x_ref2"], y_org))
        else:
            loss_sty = (l1(self._embed_fake(x_fake), s) if self.vit is not None
                        else zero)
            loss_ds = zero
        loss_rec = l1(x_fake, x_real)
        # the reference's MAE G loss weighs rec with lambda_rec (solver.py:457)
        loss = (loss_adv + cfg.lambda_sty * loss_sty +
                cfg.lambda_rec * loss_rec +
                self._lambda_ds(self.step) * loss_ds)
        return loss, {"adv": loss_adv, "sty": loss_sty, "rec": loss_rec,
                      "ds": loss_ds}

    def pretrain_step(self, batch, generator: Optional[torch.Generator] = None
                      ) -> Dict[str, torch.Tensor]:
        """One pretraining iteration (solver.py:98-204): D latent, D ref, G
        latent, G ref (M and S updated on the latent pass only), then the
        EMA of G (the JAX EMA also averages the token, which nothing reads)
        and the step count; SEAN runs the reference passes alone. ``batch``:
        NHWC ``x_ref``, ``x_ref2``, domains ``y_ref`` and ``z_ref`` (AdaIN)
        or the embeddings ``s_ref`` (SEAN). Returns the loss terms under the
        JAX names as 0-d tensors."""
        if self.token is None:
            raise RuntimeError("pretrain_step needs init_pretrain first")
        self.init_training()
        batch = self._batch(batch)
        passes = ((True, "latent"), (False, "ref")) if self.M is not None \
            else ((False, "ref"),)
        metrics = {}
        for latent, tag in passes:
            loss, m = self.mae_d_loss_fn(batch, latent=latent,
                                         generator=generator)
            self.tx_D.step(self._d_grads(loss))
            metrics.update({f"D/{tag}_{k}": v.detach() for k, v in m.items()})
        for latent, tag in passes:
            loss, m = self.mae_g_loss_fn(batch, latent=latent,
                                         generator=generator)
            self._step_generators(loss, latent)
            metrics.update({f"G/{tag}_{k}": v.detach() for k, v in m.items()})
        ema_update(self.ema_G.parameters(), self.G.parameters(),
                   self.cfg.ema_beta)
        self.step += 1
        return metrics
