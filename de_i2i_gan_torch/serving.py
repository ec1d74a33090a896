"""Serving export: ``torch.export`` artifacts of the trained generators,
counterpart of ``de_i2i_gan_tpu/serving.py``.

Each exporter traces the eval-mode forward with ``torch.export.export``,
with a symbolic batch dimension (``torch.export.Dim``, 1 to ``MAX_BATCH``),
so one artifact serves any batch. The weights go into the artifact.
``save_exported`` writes it as a ``.pt2`` file (``torch.export.save``) and
``load_exported`` reads it back; a loaded program runs as
``program.module()(*args)``.

An exported program holds the device it was traced on: export on the card
to serve on the card. There, the graph holds the norm kernels as the custom
op ``de_i2i_gan_torch::modulated_instance_norm_fwd`` (8 nodes a DefectGAN
AdaIN or SEAN generator, 12 a StarGAN v2 one at 256²) and DefectGAN's
reflect pads as ``de_i2i_gan_torch::reflect_pad2d``, and no decomposition
is run, so the served graph launches the kernels eager runs.
On the CPU the graph holds the plain version's aten ops, as eager runs
them. Loading a CUDA artifact on a machine without a card raises.

The DefectGAN program takes a ``seed`` (an int64 scalar tensor) that keys
its in-graph noise (``add_noise`` and AdaIN's latent draw when
``sean_alpha == 0``): ``SeededNoise`` hashes (seed, draw, element) with
tensor ops into standard normals, so a served request varies its noise
without a ``torch.Generator``, which a graph cannot take. The same seed
gives the same output; the draws are not ``jax.random``'s.

Entry point: ``cli/export_model.py``.
"""
from __future__ import annotations

import math
from pathlib import Path
from typing import Optional, Sequence

import torch
from torch import nn

__all__ = [
    "SeededNoise",
    "defectgan_serving_module",
    "defectgan_example_args",
    "export_defectgan_generator",
    "export_sgv2_generator",
    "export_sgv2_style_encoder",
    "export_sgv2_mapping",
    "save_exported",
    "load_exported",
    "kernel_nodes",
]

_M32 = 0xFFFFFFFF
EXAMPLE_BATCH = 2  # the traced batch
# the largest batch a program serves: traced on the card in float32, an
# aten op guards the batch at 65535, and a program must admit its guards
MAX_BATCH = 65535


def _hash32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer mix (xor-shift-multiply rounds) of int64 ``x`` in
    [0, 2**32); the multipliers stay below 2**31, so no product overflows
    int64."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x4C8DA6B5) & _M32
    return x ^ (x >> 16)


class SeededNoise:
    """Standard-normal draws keyed on an int64 ``seed`` tensor, in tensor
    ops only: draw ``k`` of a forward hashes (seed, k) into a key, each
    element hashes (key, its index) into two uniforms, and Box-Muller turns
    them into a normal. Handed down where eager code takes a
    ``torch.Generator`` (``nn/layers.py::randn``)."""

    def __init__(self, seed: torch.Tensor):
        self.seed = seed.to(torch.int64)
        self.draws = 0

    def normal(self, shape: Sequence[int], dtype: torch.dtype,
               device) -> torch.Tensor:
        numel = math.prod(shape)
        stream = (0x632BE5AB * (self.draws + 1)) & _M32
        self.draws += 1
        key = _hash32((self.seed.to(device) & _M32) ^ stream)
        idx = torch.arange(numel, dtype=torch.int64, device=device) * 2
        u1 = (_hash32((idx ^ key) & _M32) >> 8).double() + 0.5
        u2 = (_hash32(((idx + 1) ^ key) & _M32) >> 8).double() + 0.5
        u1, u2 = u1 / 2.0 ** 24, u2 / 2.0 ** 24
        z = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(2.0 * math.pi * u2)
        return z.to(dtype).reshape(shape)


class _DefectGanServing(nn.Module):
    """The eval-mode generate of ``train/steps.py`` with the noise keyed on
    ``seed``: AdaIN's style from E when no style is given."""

    def __init__(self, G: nn.Module, E: Optional[nn.Module]):
        super().__init__()
        self.G, self.E = G, E

    def run(self, bg, labels, feat, seed):
        noise = SeededNoise(seed)
        if feat is None and self.E is not None:
            feat = self.E(bg, labels, generator=noise)
        return self.G(bg, labels, feat, generator=noise)


class _DefectGanSean(_DefectGanServing):
    def forward(self, bg, labels, feat, seed):
        return self.run(bg, labels, feat, seed)


class _DefectGanPlain(_DefectGanServing):
    def forward(self, bg, labels, seed):
        return self.run(bg, labels, None, seed)


class _Sgv2Generator(nn.Module):
    def __init__(self, G: nn.Module):
        super().__init__()
        self.G = G

    def forward(self, x, s, y):
        return self.G(x, s, None, labels=y)


def _export(module: nn.Module, args, batched: Sequence[bool]
            ) -> "torch.export.ExportedProgram":
    """Export ``module`` on ``args`` with dimension 0 of each ``batched``
    argument one symbolic batch of 1 to ``MAX_BATCH``. On the card the
    trace is size-oblivious, which keeps batch 1 in the range: otherwise a
    float32 graph there specializes it to 2 and up. On the CPU no such
    guard arises, and a size-oblivious trace would add one (a view that
    asserts more than one row)."""
    from torch.fx.experimental import _config as fx_config

    batch = torch.export.Dim("batch", min=1, max=MAX_BATCH)
    shapes = tuple({0: batch} if b else None for b in batched)
    on_card = any(torch.is_tensor(a) and a.is_cuda for a in args)
    with torch.no_grad(), fx_config.patch(backed_size_oblivious=on_card):
        return torch.export.export(module, tuple(args), dynamic_shapes=shapes,
                                   strict=False)


def defectgan_serving_module(steps, *, use_ema: bool = False) -> nn.Module:
    """The module ``export_defectgan_generator`` traces:
    ``fn(bg_imgs, labels[, style_feat], seed) -> (out, prob)``; run eagerly
    it is the live forward an artifact is held against."""
    G = steps.ema_G if (use_ema and steps.ema_G is not None) else steps.G
    if steps.cfg.style_norm_block_type == "sean":
        return _DefectGanSean(G, steps.E)
    return _DefectGanPlain(G, steps.E)


def defectgan_example_args(steps, batch: int = EXAMPLE_BATCH, seed: int = 0,
                           generator: Optional[torch.Generator] = None):
    """Arguments of the DefectGAN serving program: ``batch`` images (zeros,
    or uniform in [-1, 1] from ``generator``), one-hot labels cycling over
    the classes, SEAN's zero style features, and the seed."""
    cfg, dev = steps.cfg, steps.device
    shape = (batch, cfg.image_size, cfg.image_size, 3)
    bg = (torch.zeros(shape) if generator is None
          else torch.rand(shape, generator=generator) * 2 - 1)
    args = [bg.to(dev),
            torch.eye(cfg.label_nc)[torch.arange(batch) % cfg.label_nc].to(dev)]
    if cfg.style_norm_block_type == "sean":
        args.append(torch.zeros((batch, cfg.num_embeds, cfg.embed_nc),
                                device=dev))
    args.append(torch.tensor(seed, dtype=torch.int64, device=dev))
    return args


def export_defectgan_generator(steps, *, use_ema: bool = False
                               ) -> "torch.export.ExportedProgram":
    """Export the DefectGAN compositional forward (defectgan_model.py:302-314
    eval path) as ``fn(bg_imgs, labels[, style_feat], seed) -> (out, prob)``
    on ``steps.device``: NHWC float32 images in [-1, 1], (b, label_nc)
    one-hot labels, for SEAN the (b, num_embeds, embed_nc) style features
    (zeros: the running-statistics styles, as
    ``metrics.evaluator.defectgan_generator_fn``), and an int64 scalar seed
    that keys the in-graph noise."""
    args = defectgan_example_args(steps)
    return _export(defectgan_serving_module(steps, use_ema=use_ema), args,
                   [True] * (len(args) - 1) + [False])


def export_sgv2_generator(solver, *, use_ema: bool = True
                          ) -> "torch.export.ExportedProgram":
    """Export the StarGAN v2 generator ``fn(x_src, s, y_trg) -> image``
    (core/model.py Generator eval path, EMA weights by default): NHWC
    float32 images, the style (b, style_dim) from either exported companion
    program, or SEAN's (b, num_embeds, embed_nc) embeddings, and int64
    domain ids. ``w_hpf > 0`` needs the FAN masks and is refused."""
    cfg, dev = solver.cfg, solver.device
    if getattr(cfg, "w_hpf", 0.0) > 0:
        raise ValueError(
            "export_sgv2_generator: w_hpf > 0 needs in-graph FAN masks; "
            "serving export supports w_hpf == 0 configs")
    b = EXAMPLE_BATCH
    s_tail = ((cfg.num_embeds, cfg.embed_nc) if cfg.norm_type == "sean"
              else (cfg.style_dim,))
    args = (torch.zeros((b, cfg.img_size, cfg.img_size, 3), device=dev),
            torch.zeros((b, *s_tail), device=dev),
            torch.arange(b, device=dev) % cfg.num_domains)
    G = solver.ema_G if use_ema else solver.G
    return _export(_Sgv2Generator(G), args, [True] * 3)


def export_sgv2_style_encoder(solver) -> "torch.export.ExportedProgram":
    """Export ``fn(x_ref, y_ref) -> s`` (the EMA style encoder)."""
    cfg, dev = solver.cfg, solver.device
    b = EXAMPLE_BATCH
    args = (torch.zeros((b, cfg.img_size, cfg.img_size, 3), device=dev),
            torch.arange(b, device=dev) % cfg.num_domains)
    return _export(solver.ema_S, args, [True] * 2)


def export_sgv2_mapping(solver) -> "torch.export.ExportedProgram":
    """Export ``fn(z, y) -> s`` (the EMA mapping network)."""
    cfg, dev = solver.cfg, solver.device
    b = EXAMPLE_BATCH
    args = (torch.zeros((b, cfg.latent_dim), device=dev),
            torch.arange(b, device=dev) % cfg.num_domains)
    return _export(solver.ema_M, args, [True] * 2)


def kernel_nodes(program: "torch.export.ExportedProgram") -> int:
    """The graph's calls of the forward kernel's custom op,
    ``de_i2i_gan_torch::modulated_instance_norm_fwd``."""
    want = "de_i2i_gan_torch.modulated_instance_norm_fwd"
    return sum(1 for n in program.graph.nodes
               if n.op == "call_function" and str(n.target).startswith(want))


def save_exported(program: "torch.export.ExportedProgram", path) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.export.save(program, path)
    return path


def load_exported(path) -> "torch.export.ExportedProgram":
    """Read a ``.pt2`` artifact; the kernels' ops (norm, reflect pad) are
    registered first, so a graph that holds them loads."""
    import de_i2i_gan_torch.ops.cuda.norm_kernels  # noqa: F401
    import de_i2i_gan_torch.ops.cuda.pad_kernels  # noqa: F401
    return torch.export.load(Path(path))
