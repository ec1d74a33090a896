"""Height-sharded inference (``parallel/spatial.py``) on the CPU.

In one process, each operation's band version on a seeded tensor cut into 2
and 4 bands (the halos sliced from the whole tensor) against the whole-image
op, exactly: the 7x7, 3x3 and 4x4 stride-2 reflect convolutions and a 3x3
zero-padded one; the split norm (each band's moments summed equal the
whole image's within rtol 1e-6, one band through moments and apply equals
``modulated_instance_norm_ref`` within rtol 1e-6); SPADE's tile rows (the
JAX package's ``_border_index``) and resize by global row; the noise of a
band and of a data group. Then two and four CPU ranks over gloo run tiny
generators on their bands (AdaIN, SEAN with noise and skip connections,
SPADE with noise and with a 4-D segmap at every scale), gathered on rank 0,
against one process within 5e-4 (DESIGN.md §7's forward bound, f32: the
split norm takes the kernel's single-pass variance, E[x^2] - mean^2, where
one process's plain version takes two passes; measured 2.5e-5). The
refusals: a generator in train mode, heights that do not split.
"""
import numpy as np
import pytest
import torch

from de_i2i_gan_tpu.nn.normalization import _border_index
from de_i2i_gan_torch.nn.blocks import NoiseInjection
from de_i2i_gan_torch.nn.layers import Conv2d
from de_i2i_gan_torch.nn.normalization import (
    _expand_from_tile, _tile_rows, resize_nearest)
from de_i2i_gan_torch.ops import fused
from de_i2i_gan_torch.parallel import distributed
from de_i2i_gan_torch.parallel.spatial import (
    HeightShard, attach, check_height, pad_band)
from tests import torch_spatial_workers as workers

torch.set_num_threads(1)

RTOL = 1e-6  # the split norm's moments against the whole row's
G_TOL = 5e-4  # a sharded generator against one process (f32)


class _Slices:
    """A band's neighbours sliced from the whole tensor, in place of a
    ``HeightShard``'s exchange: the band version of an op, in one process."""

    def __init__(self, full, index, size):
        self.full, self.index, self.size = full, index, size

    def pad(self, x, pads, mode):
        (pt, pb), _ = pads
        h = x.shape[2]
        lo, hi = self.index * h, (self.index + 1) * h
        above = self.full[:, :, lo - pt:lo] if self.index else None
        below = (self.full[:, :, hi:hi + pb] if self.index + 1 < self.size
                 else None)
        return pad_band(x, pads, mode, above, below)


def _bands(x, size, dim=2):
    return list(x.chunk(size, dim=dim))


@pytest.mark.parametrize("size", [2, 4])
@pytest.mark.parametrize("conv", [
    dict(kernel_size=(7, 7), strides=(1, 1), padding="same", padding_mode="reflect"),
    dict(kernel_size=(3, 3), strides=(1, 1), padding="same", padding_mode="reflect"),
    dict(kernel_size=(4, 4), strides=(2, 2), padding=1, padding_mode="reflect"),
    dict(kernel_size=(3, 3), strides=(1, 1), padding="same", padding_mode="zeros"),
], ids=["7x7", "3x3", "4x4s2", "3x3zeros"])
def test_band_convolution_matches_whole(conv, size):
    torch.manual_seed(0)
    x = torch.randn(2, 3, 32, 12)
    layer = Conv2d(3, 5, use_bias=True, **conv)
    with torch.no_grad():
        layer.bias.normal_()
        whole = layer(x)
        got = torch.cat([layer.run(band, _Slices(x, r, size))
                         for r, band in enumerate(_bands(x, size))], dim=2)
    assert torch.equal(got, whole)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", [None, "relu", "leaky_relu"])
def test_moments_split(act, dtype):
    gen = torch.Generator().manual_seed(1)
    x = (torch.randn((3, 5, 16, 12), generator=gen) * 2 + 1).to(dtype)
    g = torch.randn((3, 5), generator=gen) * 0.5
    b = torch.randn((3, 5), generator=gen) * 0.5
    whole = fused.modulated_instance_norm_moments_ref(x)
    assert whole.shape == (2, 3, 5) and whole.dtype == torch.float32
    for size in (2, 4):
        parts = sum(fused.modulated_instance_norm_moments_ref(band)
                    for band in _bands(x, size))
        torch.testing.assert_close(parts, whole, rtol=RTOL, atol=RTOL)
    # one band: moments, the stats, apply against the fused plain version
    ry, rmean, rinv = fused.modulated_instance_norm_ref(x, g, b, act)
    mean, inv = fused.moments_to_stats(whole, 16 * 12)
    torch.testing.assert_close(mean, rmean, rtol=RTOL, atol=RTOL)
    torch.testing.assert_close(inv, rinv, rtol=RTOL, atol=RTOL)
    y = fused.modulated_instance_norm_apply_ref(x, mean, inv, g, b, act)
    assert y.dtype == dtype
    if dtype == torch.float32:
        torch.testing.assert_close(y, ry, rtol=RTOL, atol=RTOL)
    else:  # the same f32 value within rounding, then one bf16 rounding
        torch.testing.assert_close(y.float(), ry.float(), rtol=2 ** -8, atol=0)
    # the dispatch without a shard, on the CPU
    torch.testing.assert_close(
        fused.sharded_modulated_instance_norm(x, g, b, act), y, rtol=0, atol=0)


@pytest.mark.parametrize("n", [7, 8, 13, 32])
def test_spade_tile_rows_by_global_row(n):
    tile = torch.randn(2, 3, 7, 7)
    whole = _expand_from_tile(tile, n, 9)
    for size in (1, 2, 4):
        if n % size:
            continue
        h = n // size
        for r in range(size):
            rows = _tile_rows(n, r * h, h, "cpu")
            np.testing.assert_array_equal(
                rows.numpy(), _border_index(n)[r * h:(r + 1) * h])
            assert torch.equal(_expand_from_tile(tile, n, 9, (r * h, h)),
                               whole[:, :, r * h:(r + 1) * h])


@pytest.mark.parametrize("src,out", [(8, 32), (5, 16), (32, 8)])
def test_resize_by_global_row(src, out):
    seg = torch.randn(2, 4, src, 6)
    whole = resize_nearest(seg, out, 10)
    for size in (2, 4):
        h = out // size
        got = torch.cat([resize_nearest(seg, out, 10, (r * h, h))
                         for r in range(size)], dim=2)
        assert torch.equal(got, whole)


def test_noise_bands_are_one_process_draws():
    """Each band of each data group draws the global batch's full-height
    noise from the same stream and keeps its rows."""
    x = torch.randn(4, 3, 16, 6)
    layer = NoiseInjection()
    with torch.no_grad():
        layer.weight.fill_(0.7)
    whole = layer(x, torch.Generator().manual_seed(3))
    for data_size, size in ((1, 2), (1, 4), (2, 2)):
        n, h = 4 // data_size, 16 // size
        for d in range(data_size):
            for r in range(size):
                attach(layer, HeightShard(None, r, size, tuple(range(size)),
                                          d, data_size))
                band = x[d * n:(d + 1) * n, :, r * h:(r + 1) * h]
                got = layer(band, torch.Generator().manual_seed(3))
                assert torch.equal(got, whole[d * n:(d + 1) * n, :,
                                              r * h:(r + 1) * h])
    attach(layer, None)
    assert torch.equal(layer(x, torch.Generator().manual_seed(3)), whole)


CASES = [("adain", 0, {}),
         ("sean", 1, dict(add_noise=True, skip_conn=True)),
         ("spade", 2, dict(add_noise=True)),
         ("spade", 3, dict(segmap=True))]


@pytest.mark.parametrize("ranks", [2, 4])
def test_sharded_generator_matches_one_process(ranks):
    """``ranks`` CPU ranks, spatial groups of 2 (4 ranks: 2 data groups)."""
    outs = distributed.launch(workers.band_ranks, ("cpu",) * ranks, 2, CASES)
    assert all(o is None for r in outs[1:] for o in r)
    with torch.no_grad():
        for (style, seed, kw), got in zip(CASES, outs[0]):
            G, images, labels, style_feat = workers.generator_case(
                style, seed, **kw)
            want, _ = G(images, labels, style_feat,
                        generator=torch.Generator().manual_seed(0))
            assert got.shape == want.shape == (workers.BATCH, 32, 32, 3)
            torch.testing.assert_close(got, want, rtol=G_TOL, atol=G_TOL,
                                       msg=lambda m: f"{style} {kw}: {m}")


def test_sharded_generator_refuses_train_mode():
    G = workers.generator_case("sean", 0)[0].train()
    attach(G, HeightShard(None, 0, 2, (0, 1)))
    with pytest.raises(ValueError, match="eval mode"):
        G(torch.zeros(1, 16, 32, 3), torch.eye(4)[:1])


@pytest.mark.parametrize("height,spatial,scales,match", [
    (36, 2, 2, "not divisible by --spatial 2 x 2\\*\\*num_scales \\(4\\) = 8"),
    (16, 4, 2, "bands of 1 rows at scale 1/4"),
    (6, 2, 0, "bands of 3 rows at scale 1/1, which must hold more than the 3-row"),
])
def test_heights_that_do_not_split(height, spatial, scales, match):
    with pytest.raises(ValueError, match=match):
        check_height(height, spatial, scales)
    check_height(32, 2, 2)


def test_band_too_thin_for_its_halo():
    shard = HeightShard(None, 0, 2, (0, 1))
    with pytest.raises(ValueError, match="a band of 3 rows"):
        shard.pad(torch.zeros(1, 2, 3, 8), ((3, 3), (3, 3)), "reflect")
