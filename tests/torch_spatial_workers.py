"""Rank functions for the port's height-sharded inference tests: CPU ranks
over gloo (``de_i2i_gan_torch.parallel.distributed.launch``). Spawned ranks
import this module afresh, so it imports torch and the port only, and every
function a rank runs lives at module level.

``generator_case`` builds a tiny generator and its inputs from a seed, the
same in the test process and in every rank; ``band_ranks`` is a rank's side:
each case's generator with this rank's ``HeightShard`` attached, on its band
of the global batch, the bands gathered on rank 0.
"""
from __future__ import annotations

import torch

from de_i2i_gan_torch.config import DefectGanConfig, TrainConfig
from de_i2i_gan_torch.nn.blocks import BatchNorm, NoiseInjection
from de_i2i_gan_torch.parallel.spatial import (
    make_height_shard, spatial_sharded_inference)
from de_i2i_gan_torch.train.jax_import import init_weights
from de_i2i_gan_torch.train.steps import DefectGanSteps

# the tiny bench.py CPU config (ngf=ndf=8, num_res 2, hidden_nc 16)
TINY = dict(image_size=32, label_nc=4, ngf=8, ndf=8, num_res=2, hidden_nc=16,
            num_layers=2, embed_nc=12, num_embeds=2, compute_dtype="float32")
BATCH = 2


def generator_case(style: str, seed: int, **kw):
    """(G in eval mode, images, labels, style input) of one case: weights
    from ``seed`` with BatchNorm statistics and noise weights off their init
    values; NHWC images in [-1, 1]; one-hot labels, or for ``segmap`` a
    (N, label_nc, 8, 8) one-hot map (SPADE resizes it at every scale)."""
    segmap = kw.pop("segmap", False)
    cfg = DefectGanConfig(**TINY, style_norm_block_type=style, **kw)
    steps = DefectGanSteps(cfg, TrainConfig(), device="cpu")
    init_weights(steps, seed)
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for m in steps.G.modules():
            if isinstance(m, BatchNorm):
                m.running_mean.normal_(0, 0.1, generator=gen)
                m.running_var.uniform_(0.5, 1.5, generator=gen)
            elif isinstance(m, NoiseInjection):
                m.weight.fill_(0.5)
    size = cfg.image_size
    images = torch.rand((BATCH, size, size, 3), generator=gen) * 2 - 1
    idx = torch.randint(0, cfg.label_nc, (BATCH,), generator=gen)
    labels = torch.eye(cfg.label_nc)[idx]
    if segmap:
        cells = torch.randint(0, cfg.label_nc, (BATCH, 8, 8), generator=gen)
        labels = torch.eye(cfg.label_nc)[cells].permute(0, 3, 1, 2)
    style_feat = (torch.randn((BATCH, cfg.hidden_nc), generator=gen)
                  if style == "adain" else None)
    return steps.G.eval(), images, labels, style_feat


def band_ranks(spatial: int, cases):
    """A rank's side: each case's generator on this rank's band, its noise
    from a generator seeded 0; rank 0 returns the gathered outputs."""
    torch.set_num_threads(1)
    shard = make_height_shard(spatial)
    outs = []
    with torch.no_grad():
        for style, seed, kw in cases:
            G, images, labels, style_feat = generator_case(style, seed, **kw)
            fn = spatial_sharded_inference(G, shard)
            outs.append(fn(images, labels, style_feat,
                           torch.Generator().manual_seed(0)))
    return outs
