"""Conditional normalization, counterpart of ``de_i2i_gan_tpu/nn/normalization.py``,
in NCHW: the param-free ``instance_norm``, ``SPADE``, ``AdaIN`` and ``SEAN``
with its running per-label style statistics (``sean_update_stats``).

AdaIN and SEAN end in the fused modulated instance norm
(``ops/fused.py``), which runs the CUDA kernel for CUDA tensors when
``use_pallas`` is set. SPADE modulates per pixel after the param-free
instance norm and runs no kernel of its own.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from de_i2i_gan_torch.nn.layers import Conv2d, Dense
from de_i2i_gan_torch.ops.fused import modulated_instance_norm

# per SEAN layer of one forward: the (latent, embed) distillation terms
DistillTerms = List[Tuple[torch.Tensor, torch.Tensor]]


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Param-free instance norm over H, W of NCHW x (nn.InstanceNorm2d(affine=False)).

    Two passes with float32 accumulation, as the JAX package: the centered
    tensor stays in x's dtype, only the statistics accumulate in float32.
    """
    mean = x.mean(dim=(2, 3), keepdim=True, dtype=torch.float32)
    xc = x - mean.to(x.dtype)
    var = xc.float().square().mean(dim=(2, 3), keepdim=True)
    return xc * torch.rsqrt(var + eps).to(x.dtype)


def _expand_from_tile(tile: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Expand an (N, C, 7, 7) conv-on-constant-input result to (N, C, H, W),
    H, W >= 7: tile rows 0-2, row 3 repeated H - 6 times, rows 4-6 (the same
    along W). Slices and a broadcast, so the backward is a sum over the
    repeats; an index gather would scatter back through one duplicated
    index per pixel."""
    def along(t, dim, n):
        mid = list(t.shape)
        mid[dim] = n - 6
        return torch.cat([t.narrow(dim, 0, 3), t.narrow(dim, 3, 1).expand(mid),
                          t.narrow(dim, 4, 3)], dim=dim)
    return along(along(tile, 2, h), 3, w)


def resize_nearest(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """NCHW nearest resize as ``jax.image.resize(method="nearest")`` samples:
    source index floor((i + 0.5) * in / out) in float32 (half-pixel
    centres, which ``F.interpolate(mode="nearest")`` does not use)."""
    for dim, out in ((2, h), (3, w)):
        m = x.shape[dim]
        if m != out:
            pos = (torch.arange(out, dtype=torch.float32, device=x.device)
                   + 0.5) * m / out
            x = x.index_select(dim, torch.floor(pos).long())
    return x


class SPADE(nn.Module):
    """Spatially-adaptive denormalization: the param-free instance norm,
    modulated per pixel by gamma/beta maps that two stacked 3x3 convs make
    from the segmentation map.

    A 2-D (N, label_nc) label vector is a spatially constant segmap. At
    H, W >= 7 the convs run on a 7x7 tile of it and the result is expanded:
    zero-padded 3x3 convs tell pixels apart only by their distance to the
    border, clipped at 2, so this equals the full-resolution maps exactly.
    Smaller maps, and 4-D (N, label_nc, h, w) segmaps (resized to x's size
    first), take the full-resolution convs.
    """

    def __init__(self, norm_nc: int, label_nc: int, hidden_nc: int = 128,
                 kernel_size: int = 3, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.label_nc = label_nc
        self.dtype = dtype
        ks = (kernel_size, kernel_size)
        conv = dict(padding="same", use_bias=True, dtype=dtype)
        self.mlp_shared = Conv2d(label_nc, hidden_nc, ks, **conv)
        self.mlp_gamma = Conv2d(hidden_nc, norm_nc, ks, **conv)
        self.mlp_beta = Conv2d(hidden_nc, norm_nc, ks, **conv)

    def _mlp(self, seg: torch.Tensor):
        actv = F.relu(self.mlp_shared(seg))
        return self.mlp_gamma(actv), self.mlp_beta(actv)

    def forward(self, x: torch.Tensor, segmap: torch.Tensor) -> torch.Tensor:
        n, _, h, w = x.shape
        normalized = instance_norm(x)
        if segmap.dim() == 2 and h >= 7 and w >= 7:
            seg = segmap[:, :, None, None].to(self.dtype).expand(
                n, self.label_nc, 7, 7)
            g7, b7 = self._mlp(seg)
            scale = _expand_from_tile(1.0 + g7, h, w)
            beta = _expand_from_tile(b7, h, w)
        else:
            if segmap.dim() == 2:
                segmap = segmap[:, :, None, None]
            gamma, beta = self._mlp(resize_nearest(segmap, h, w).to(self.dtype))
            scale = 1.0 + gamma
        return (normalized * scale + beta).to(x.dtype)


class AdaIN(nn.Module):
    """Adaptive instance norm driven by a style vector: two dense heads give
    per-(n, c) gamma and beta for the fused modulated instance norm."""

    def __init__(self, norm_nc: int, hidden_nc: int = 128,
                 dtype: torch.dtype = torch.float32, use_pallas: bool = True):
        super().__init__()
        self.hidden_nc = hidden_nc
        self.use_pallas = use_pallas
        self.mlp_gamma = Dense(hidden_nc, norm_nc, dtype=dtype)
        self.mlp_beta = Dense(hidden_nc, norm_nc, dtype=dtype)

    def forward(self, x: torch.Tensor, style_feat: torch.Tensor) -> torch.Tensor:
        n = x.shape[0]
        if style_feat is None or tuple(style_feat.shape) != (n, self.hidden_nc):
            got = None if style_feat is None else tuple(style_feat.shape)
            raise ValueError(
                f"style feature must be ({n}, {self.hidden_nc}), got {got}")
        gamma = self.mlp_gamma(style_feat)
        beta = self.mlp_beta(style_feat)
        return modulated_instance_norm(x, gamma, beta,
                                       use_kernel=self.use_pallas)


def sean_label_index(labels: torch.Tensor) -> torch.Tensor:
    """Map multilabel one-hot rows (N, L) to indices in [0, 2**L)."""
    powers = 2 ** torch.arange(labels.shape[-1], device=labels.device)
    return (labels.to(torch.int64) * powers).sum(dim=-1)


def _kl_with_logits(p: torch.Tensor, q: torch.Tensor,
                    t: float = 4.0) -> torch.Tensor:
    """KL(softmax(p/t) || softmax(q/t)) * t^2, batch mean."""
    logp = F.log_softmax(p / t, dim=1)
    logq = F.log_softmax(q / t, dim=1)
    kl = (logp.exp() * (logp - logq)).sum(dim=1)
    return kl.mean() * t * t


class SEAN(nn.Module):
    """Semantic region-adaptive normalization: per-(n, c) gamma/beta for the
    fused modulated instance norm, from a style code that mixes a label
    latent with frozen-ViT style embeddings.

    The style code by call:
      * ``feat`` None: the label latent ``relu(mlp_latent(labels))``;
      * ``inference_stats``: ``feat`` is (N, hidden_nc) noise, and the code
        ``feat * std * 1.5 + mean`` samples the running statistics of the
        row's label combination;
      * otherwise ``feat`` is (N, num_embeds, embed_nc) embeddings: the code
        is the mean over embeddings of ``relu(mlp_shared(feat)) + latent``,
        and a code that is exactly zero falls back to the latent.
        ``track_stats`` adds the code to the accumulators of its label
        combination; a ``distill`` list (when ``style_distill``) receives
        the layer's two distillation terms.

    The running statistics are float32 buffers named as the flax
    ``sean_stats`` collection: ``mean``, ``std`` (finalized, stored the
    right way round), ``sum``, ``sumsq`` (2**label_nc, hidden_nc) and
    ``count`` (2**label_nc,) accumulating until ``sean_update_stats``.
    """

    def __init__(self, embed_nc: int, norm_nc: int, label_nc: int,
                 hidden_nc: int = 128, style_distill: bool = False,
                 dtype: torch.dtype = torch.float32, use_pallas: bool = True):
        super().__init__()
        self.style_distill = style_distill
        self.dtype = dtype
        self.use_pallas = use_pallas
        self.mlp_latent = Dense(label_nc, hidden_nc, dtype=dtype)
        self.mlp_shared = Dense(embed_nc, hidden_nc, dtype=dtype)
        self.mlp_gamma = Dense(hidden_nc, norm_nc, dtype=dtype)
        self.mlp_beta = Dense(hidden_nc, norm_nc, dtype=dtype)
        combos = 2 ** label_nc
        for name in ("mean", "std", "sum", "sumsq"):
            self.register_buffer(name, torch.zeros(combos, hidden_nc))
        self.register_buffer("count", torch.zeros(combos))

    def forward(self, x: torch.Tensor, labels: torch.Tensor,
                feat: Optional[torch.Tensor] = None, *,
                track_stats: bool = False, inference_stats: bool = False,
                distill: Optional[DistillTerms] = None) -> torch.Tensor:
        dt = self.dtype
        if labels.dim() == 4:
            labels = labels.reshape(x.shape[0], -1)
        latent = F.relu(self.mlp_latent(labels.to(dt)))
        if feat is None:
            mix = latent
        elif inference_stats:
            idx = sean_label_index(labels)
            mix = (feat.to(dt) * self.std[idx].to(dt) * 1.5
                   + self.mean[idx].to(dt))
        else:
            enc = F.relu(self.mlp_shared(feat.to(dt)))
            mix = enc + latent[:, None, :]
            if mix.dim() == 3:
                mix = mix.mean(dim=1)
            if track_stats:
                idx = sean_label_index(labels)
                tracked = mix.detach().float()
                self.sum.index_add_(0, idx, tracked)
                self.sumsq.index_add_(0, idx, tracked.square())
                self.count.index_add_(0, idx, torch.ones_like(tracked[:, 0]))
            zero_rows = (mix == 0).all(dim=1, keepdim=True)
            mix = torch.where(zero_rows, latent, mix)
            if self.style_distill and distill is not None:
                target = mix.detach().float()
                distill.append((_kl_with_logits(latent.float(), target),
                                _kl_with_logits(enc.mean(dim=1).float(), target)))
        gamma = self.mlp_gamma(mix)
        beta = self.mlp_beta(mix)
        return modulated_instance_norm(x, gamma, beta, use_kernel=self.use_pallas)


@torch.no_grad()
def sean_update_stats(module: nn.Module, eps: float = 1e-5,
                      group=None) -> None:
    """Finalize the running statistics of every SEAN layer in ``module``, in
    place (once an epoch): the mean and the unbiased std, sqrt(var + eps),
    of the codes tracked since the last call; a label combination with no
    tracked code keeps its previous mean and std; the accumulators reset.
    With a process ``group`` the ranks' accumulators are summed first
    (``parallel/mesh.py::reduce_running_styles``)."""
    if group is not None:
        from de_i2i_gan_torch.parallel.mesh import reduce_running_styles
        reduce_running_styles(module, group)
    for m in module.modules():
        if isinstance(m, SEAN):
            finalize_running_stats(m, eps)


def finalize_running_stats(m: nn.Module, eps: float = 1e-5) -> None:
    """One layer's ``mean``/``std`` buffers from its ``sum``, ``sumsq`` and
    ``count`` accumulators (rows with no count keep theirs); the
    accumulators reset."""
    count = m.count[:, None]
    seen = count > 0
    n = count.clamp_min(1.0)
    mean = torch.where(seen, m.sum / n, m.mean)
    var = (m.sumsq - n * mean.square()) / (count - 1.0).clamp_min(1.0)
    m.std.copy_(torch.where(seen, (var.clamp_min(0.0) + eps).sqrt(), m.std))
    m.mean.copy_(mean)
    for acc in (m.sum, m.sumsq, m.count):
        acc.zero_()
