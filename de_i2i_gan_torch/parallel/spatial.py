"""Height-sharded generator inference, counterpart of
``de_i2i_gan_tpu/parallel/mesh.py::spatial_sharded_inference`` (:155-164)
and the 'spatial' axis of its ``make_mesh(n, spatial)`` (:29-53).

GSPMD shards the JAX forward's image height over the mesh's 'spatial' axis
and inserts the convolutions' halo exchanges and the norms' reductions
across the shards. The port does both by hand. ``make_height_shard(S)``
splits the ranks into ``n_ranks // S`` data groups of S consecutive ranks,
each a spatial group (``dist.new_group``): rank s of a group holds rows
[s·H/S, (s+1)·H/S) of its data group's images at every scale. A
``HeightShard`` attached to the generator (``attach``) makes its modules run
on their band:

  * ``Conv2d`` pads H with its neighbours' rows (``HeightShard.pad``):
    (k-1)/2 for a 'same' conv, 1 above and 1 below for the 4x4 stride-2
    encoder (bands start on even rows); at the image's top and bottom edges
    it pads as before (reflect, zeros); W pads as before;
  * every norm takes the moments of the whole image: SPADE's param-free
    instance norm all-reduces its f32 sum, then the f32 sum of squares of
    the centred band (two passes, as GSPMD compiles the JAX function);
    AdaIN and SEAN go through ``ops/fused.py::sharded_modulated_instance_norm``
    (the moments kernel, one all-reduce of the (2, N, C) sums, the apply
    kernel);
  * SPADE builds its band's rows of the scale and shift maps by global row;
  * ``NoiseInjection`` draws the noise of the whole global batch at full
    height from the same generator on every rank and keeps its own rows, so
    the ranks draw what one process draws.

The halo travels over NCCL as device tensors (``batch_isend_irecv``); over
gloo (CPU ranks, or ranks sharing a card: ``distributed.backend_for``),
whose point-to-point ops take CPU tensors only, through host memory. The
exchanges run in the profiler range ``spatial.halo``, the reductions in
``spatial.moments``. Inference only: a generator in train mode (its
BatchNorm would need the global batch's statistics) is refused, as the JAX
path is eval-only.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from de_i2i_gan_torch.nn.layers import Pads, pad_image
from de_i2i_gan_torch.utils import profiling

# the widest halo a band of the DefectGAN generator sends at full
# resolution (the 7x7 stem) and at every lower scale (3x3 convs; the 4x4
# stride-2 encoder takes 1)
STEM_HALO, SCALE_HALO = 3, 1


@dataclasses.dataclass(frozen=True)
class HeightShard:
    """This rank's band of the image height: band ``index`` of ``size`` in a
    spatial group (``group``, its global ``ranks`` by band), which is data
    group ``data_index`` of ``data_size``. ``host_staged``: the halo goes
    through host memory (gloo)."""

    group: Any
    index: int
    size: int
    ranks: Tuple[int, ...]
    data_index: int = 0
    data_size: int = 1
    host_staged: bool = True

    def rows(self, h: int) -> Tuple[int, int]:
        """(first global row, image rows) of a band of ``h`` rows."""
        return h * self.index, h * self.size

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the spatial group, in place."""
        with profiling.span("spatial.moments"):
            dist.all_reduce(t, group=self.group)
        return t

    def exchange(self, to_prev: torch.Tensor, to_next: torch.Tensor
                 ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
        """Send ``to_prev`` to the band above and ``to_next`` to the band
        below; returns (the rows the band above sent, the rows the band below
        sent), None at the image's top and bottom. Every band sends the same
        shapes, so each receives the shape it sends the other way."""
        with profiling.span("spatial.halo"):
            device = to_prev.device
            prev = self.ranks[self.index - 1] if self.index > 0 else None
            nxt = self.ranks[self.index + 1] if self.index + 1 < self.size else None

            def staged(t):
                t = t.contiguous()
                return t.cpu() if self.host_staged else t

            def buffer(like):
                return torch.empty(like.shape, dtype=like.dtype,
                                   device="cpu" if self.host_staged else device)

            ops, got = [], {}
            for peer, send, key, like in ((prev, to_prev, "prev", to_next),
                                          (nxt, to_next, "next", to_prev)):
                if peer is None:
                    continue
                if send.shape[2]:
                    ops.append(dist.P2POp(dist.isend, staged(send), peer,
                                          self.group))
                if like.shape[2]:
                    got[key] = buffer(like)
                    ops.append(dist.P2POp(dist.irecv, got[key], peer,
                                          self.group))
            if ops:
                for work in dist.batch_isend_irecv(ops):
                    work.wait()
            return tuple(got[k].to(device) if k in got else None
                         for k in ("prev", "next"))

    def pad(self, x: torch.Tensor, pads: Pads, mode: str) -> torch.Tensor:
        """``pad_image`` of this band: H padded with the neighbours' rows,
        and as ``mode`` pads at the image's edges; W as before."""
        (pt, pb), _ = pads
        if pt == pb == 0:
            return pad_image(x, pads, mode)
        h = x.shape[2]
        if h <= max(pt, pb):
            raise ValueError(
                f"a band of {h} rows (image height {h * self.size} over "
                f"{self.size} ranks) cannot pad {max(pt, pb)} rows from its "
                "own and its neighbours' rows: shard a taller image, or over "
                "fewer ranks")
        above, below = self.exchange(x[:, :, :pb], x[:, :, h - pt:])
        return pad_band(x, pads, mode, above, below)

    def take(self, full: torch.Tensor, n: int, h: int) -> torch.Tensor:
        """This rank's rows of a tensor of the global batch (axis 0) at full
        height (axis 2): batch rows of its data group, ``h`` rows of its
        band."""
        return full[self.data_index * n:(self.data_index + 1) * n, :,
                    self.index * h:(self.index + 1) * h]

    def check_generator(self, module: nn.Module, h: int, num_scales: int
                        ) -> None:
        """Refuse a generator in train mode, and a band whose rows do not
        halve ``num_scales`` times."""
        if module.training:
            raise ValueError(
                "height-sharded inference runs the generator in eval mode: "
                "train-mode BatchNorm needs the statistics of the global "
                "batch (call .eval())")
        check_height(h * self.size, self.size, num_scales)


def _edge(x: torch.Tensor, p: int, mode: str, top: bool) -> torch.Tensor:
    """The ``p`` rows ``pad_image`` puts above (``top``) or below x."""
    h = x.shape[2]
    if p == 0:
        return x[:, :, :0]
    if mode == "zeros":
        return x.new_zeros((x.shape[0], x.shape[1], p, x.shape[3]))
    if mode == "replicate":
        return (x[:, :, :1] if top else x[:, :, h - 1:]).expand(-1, -1, p, -1)
    if mode == "reflect":
        return (x[:, :, 1:p + 1] if top else x[:, :, h - 1 - p:h - 1]).flip(2)
    raise ValueError(f"unknown padding mode {mode}")


def pad_band(x: torch.Tensor, pads: Pads, mode: str,
             above: Optional[torch.Tensor] = None,
             below: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Pad a band of rows of NCHW images: H with ``above`` and ``below``
    (the neighbouring bands' rows), or where one is None (an edge of the
    image) as ``pad_image`` pads in ``mode``; W as ``pad_image``. Needs
    more rows than the pad at an edge that reflects."""
    (pt, pb), (pl, pr) = pads
    top = above if above is not None else _edge(x, pt, mode, True)
    bottom = below if below is not None else _edge(x, pb, mode, False)
    x = torch.cat([t for t in (top, x, bottom) if t.shape[2]], dim=2)
    return pad_image(x, ((0, 0), (pl, pr)), mode)


def check_height(height: int, spatial: int, num_scales: int) -> None:
    """Refuse an image height that does not split into ``spatial`` bands
    halving ``num_scales`` times, or whose bands hold no more rows than
    the halo a band sends at some scale (the reflect edges need one more)."""
    step = spatial * 2 ** num_scales
    if height % step:
        raise ValueError(
            f"image height {height} is not divisible by --spatial {spatial} "
            f"x 2**num_scales ({2 ** num_scales}) = {step}")
    for scale in range(num_scales + 1):
        rows = height // (spatial * 2 ** scale)
        halo = STEM_HALO if scale == 0 else SCALE_HALO
        if rows <= halo:
            raise ValueError(
                f"image height {height} over --spatial {spatial} leaves "
                f"bands of {rows} rows at scale 1/{2 ** scale}, which must "
                f"hold more than the {halo}-row halo they send")


def make_height_shard(spatial: int) -> HeightShard:
    """Split the ranks into data groups of ``spatial`` consecutive ranks, each
    one spatial group, and return this rank's ``HeightShard``. Every rank
    calls it (every rank creates every group, in one order)."""
    world, rank = dist.get_world_size(), dist.get_rank()
    if spatial < 2 or world % spatial:
        raise ValueError(f"--spatial {spatial} does not divide {world} ranks "
                         "into spatial groups")
    mine = None
    for d in range(world // spatial):
        ranks = tuple(range(d * spatial, (d + 1) * spatial))
        group = dist.new_group(list(ranks))
        if rank in ranks:
            mine = (d, ranks, group)
    d, ranks, group = mine
    return HeightShard(group, rank - d * spatial, spatial, ranks, d,
                       world // spatial, dist.get_backend(group) == "gloo")


def attach(module: nn.Module, shard: Optional[HeightShard]) -> nn.Module:
    """Attach ``shard`` to every submodule of ``module`` that runs on a band
    (the classes that declare a ``shard`` attribute: ``Conv2d``, SPADE,
    AdaIN, SEAN, ``NoiseInjection``, ``DefectGanGenerator``); None detaches.
    Returns ``module``."""
    for m in module.modules():
        if hasattr(type(m), "shard"):
            m.shard = shard
    return module


@contextlib.contextmanager
def attached(module: nn.Module, shard: Optional[HeightShard]):
    """``module`` with ``shard`` attached inside the block."""
    attach(module, shard)
    try:
        yield module
    finally:
        attach(module, None)


def band_of(images: torch.Tensor, shard: HeightShard) -> torch.Tensor:
    """This rank's part of a global NHWC batch: its data group's images,
    its band's rows."""
    n = images.shape[0] // shard.data_size
    h = images.shape[1] // shard.size
    return images[shard.data_index * n:(shard.data_index + 1) * n,
                  shard.index * h:(shard.index + 1) * h]


def gather_bands(band: torch.Tensor, shard: HeightShard
                 ) -> Optional[torch.Tensor]:
    """The global NHWC batch from every rank's ``band``, on rank 0 (on its
    device); None on the other ranks. Rank q holds band q % S of data group
    q // S (``make_height_shard``)."""
    t = band.contiguous()
    t = t.cpu() if shard.host_staged else t
    primary = dist.get_rank() == 0
    parts = ([torch.empty_like(t) for _ in range(dist.get_world_size())]
             if primary else None)
    dist.gather(t, parts, dst=0)
    if not primary:
        return None
    n, h = band.shape[:2]
    out = band.new_empty((n * shard.data_size, h * shard.size, *band.shape[2:]))
    for q, part in enumerate(parts):
        d, s = divmod(q, shard.size)
        out[d * n:(d + 1) * n, s * h:(s + 1) * h] = part.to(band.device)
    return out


def spatial_sharded_inference(G: nn.Module, shard: HeightShard) -> Callable:
    """The counterpart of the JAX function: ``fn(images, labels, style_feat,
    generator)`` runs ``G`` (in eval mode) with ``shard`` attached on this
    rank's band of the global NHWC ``images`` (every rank holds the same
    global batch and labels) and returns the generator's first output for
    the global batch on rank 0, None on the others."""
    def fn(images: torch.Tensor, labels: torch.Tensor,
           style_feat: Optional[torch.Tensor] = None,
           generator: Optional[torch.Generator] = None):
        n = images.shape[0] // shard.data_size
        rows = slice(shard.data_index * n, (shard.data_index + 1) * n)
        with attached(G, shard):
            out, _ = G(band_of(images, shard), labels[rows],
                       None if style_feat is None else style_feat[rows],
                       generator=generator)
        return gather_bands(out, shard)

    return fn
