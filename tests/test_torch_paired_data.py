"""The paired data of the port against the JAX package's, bit for bit:
``SyntheticPairedDataset``, ``AlignedDataset`` over a folder that
``write_aligned_folder`` writes (the port writes its PNGs with its own
writer, the JAX package with PIL: the same pixels), ``PairedLoader``
(shuffle, drop_last, the iters_per_launch axis, epochs), the paired native
feed (``make_paired_native_loader``: the 6-channel cache, u8 ``pair``
batches from ``aug_mode=2``, the crop fraction, the pair's halves against the JAX host split) and
``make_native_loader``'s epochs, each with one C++ thread and one seed.

Both packages build their own copy of ``dataloader.cc`` with g++; the
native tests skip, as the JAX suite's ``tests/test_native_loader.py`` does,
where the JAX package cannot build its copy.
"""
import numpy as np
import pytest
import torch

from de_i2i_gan_tpu.data import paired as jpaired
from de_i2i_gan_tpu.data.synthetic import SyntheticDefectDataset as JaxSynthetic
from de_i2i_gan_tpu.runtime import native_loader as jnative
from de_i2i_gan_tpu.runtime.native_loader import native_available
from de_i2i_gan_torch.data import paired
from de_i2i_gan_torch.data.synthetic import SyntheticDefectDataset
from de_i2i_gan_torch.ops.fused import batch_images_to_float
from de_i2i_gan_torch.runtime import native_loader

torch.set_num_threads(1)

native = pytest.mark.skipif(not native_available(),
                            reason="no native toolchain")


def _same(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_synthetic_pairs_match_jax():
    port = paired.SyntheticPairedDataset(image_size=24, length=6, seed=3)
    ref = jpaired.SyntheticPairedDataset(image_size=24, length=6, seed=3)
    assert len(port) == len(ref) == 6
    for i in range(6):
        for a, b in zip(port[i], ref[i]):
            if isinstance(a, str):
                assert a == b
            else:
                assert a.dtype == b.dtype == np.float32
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("direction,flip", [("AtoB", True), ("BtoA", False)])
def test_aligned_dataset_matches_jax(direction, flip, tmp_path):
    pytest.importorskip("PIL")
    src = paired.SyntheticPairedDataset(image_size=20, length=4, seed=1)
    root = paired.write_aligned_folder(src, tmp_path / "port")
    jroot = jpaired.write_aligned_folder(src, tmp_path / "jax")
    kw = dict(load_size=24, crop_size=16, flip=flip, direction=direction,
              seed=9)
    port = paired.AlignedDataset(root, "train", **kw)
    ref = jpaired.AlignedDataset(jroot, "train", **kw)
    for epoch in (0, 1):
        port._epoch_salt = ref._epoch_salt = epoch
        for i in range(len(ref)):
            a, b = port[i], ref[i]
            np.testing.assert_array_equal(a[0], b[0])
            np.testing.assert_array_equal(a[1], b[1])
    # the writers' pixels are the same
    from PIL import Image
    for p, q in zip(sorted((root / "train").iterdir()),
                    sorted((jroot / "train").iterdir())):
        np.testing.assert_array_equal(np.asarray(Image.open(p)),
                                      np.asarray(Image.open(q)))


@pytest.mark.parametrize("ipl,shuffle,drop_last", [
    (1, True, True), (3, True, True), (1, False, False)])
def test_paired_loader_matches_jax(ipl, shuffle, drop_last):
    kw = dict(shuffle=shuffle, drop_last=drop_last, seed=4,
              iters_per_launch=ipl)
    port = paired.PairedLoader(
        paired.SyntheticPairedDataset(image_size=16, length=13, seed=2), 2, **kw)
    ref = jpaired.PairedLoader(
        jpaired.SyntheticPairedDataset(image_size=16, length=13, seed=2), 2, **kw)
    assert len(port) == len(ref)
    for _ in range(2):  # two epochs: the shuffle moves with the epoch
        got, want = list(port), list(ref)
        assert len(got) == len(want) > 0
        for a, b in zip(got, want):
            _same(a, b)


def _pairs(length=8, size=20):
    return (paired.SyntheticPairedDataset(image_size=size, length=length, seed=6),
            jpaired.SyntheticPairedDataset(image_size=size, length=length, seed=6))


@native
@pytest.mark.parametrize("ipl,augment,split", [
    (1, True, False), (2, True, False), (1, False, False), (2, True, True)])
def test_paired_native_batches_match_jax(ipl, augment, split, tmp_path):
    """u8 pairs at the CLI's crop (256 of 286: one crop of 256/286 of the
    side and one flip for both halves, aug_mode=2), or center crops; 3
    epochs. With ``split`` the JAX loader splits on the host, and the
    port's pair halves equal its input and target. (The JAX package sets
    its crop fraction after the C++ threads start, so only at the default
    fraction are its batches the same on every run; the port's at any,
    below.)"""
    port_ds, jax_ds = _pairs(4, 256)
    kw = dict(load_size=286, seed=7, num_threads=1, iters_per_launch=ipl,
              augment=augment)
    port = native_loader.make_paired_native_loader(port_ds, tmp_path / "port",
                                                   256, 2, **kw)
    ref = jnative.make_paired_native_loader(jax_ds, tmp_path / "jax", 256, 2,
                                            split_on_host=split, **kw)
    for name in ("images.u8", "index.bin", "meta.json"):
        assert ((tmp_path / "port" / name).read_bytes()
                == (tmp_path / "jax" / name).read_bytes())
    assert len(port) == len(ref) == 4 // 2 // ipl
    try:
        for _ in range(3):
            got, want = list(port), list(ref)
            assert len(got) == len(want) == len(port)
            for a, b in zip(got, want):
                lead = (ipl,) if ipl > 1 else ()
                assert sorted(a) == ["pair"]
                assert a["pair"].shape == (*lead, 2, 256, 256, 6)
                assert a["pair"].dtype == np.uint8
                if split:
                    a = {"input": a["pair"][..., :3],
                         "target": a["pair"][..., 3:]}
                _same(a, b)
    finally:
        port.close()
        ref.loader.close()


@native
def test_paired_native_crop_fraction_holds_from_the_first_batch(tmp_path):
    """Another crop (16 of 24): two loaders with one seed give the same
    batches from the first on, over two epochs (the fraction is set before
    the C++ threads start)."""
    port_ds, _ = _pairs()
    loaders = [native_loader.make_paired_native_loader(
        port_ds, tmp_path, 16, 2, load_size=24, seed=7, num_threads=1)
        for _ in range(2)]
    try:
        one, two = ([b for _ in range(2) for b in ld] for ld in loaders)
        assert len(one) == len(two) == 8
        for x, y in zip(one, two):
            assert x["pair"].shape == (2, 16, 16, 6)
            _same(x, y)
    finally:
        for ld in loaders:
            ld.close()


@native
def test_paired_pair_splits_on_the_device(tmp_path):
    """A ``pair`` batch reaches the steps as the input and target halves,
    normalized to [-1, 1]: the host slices of the same draws."""
    port_ds, _ = _pairs()
    loader = native_loader.make_paired_native_loader(
        port_ds, tmp_path, 16, 2, load_size=24, seed=8, num_threads=1)
    try:
        n = 0
        for a in loader:
            got = batch_images_to_float({k: torch.from_numpy(v)
                                         for k, v in a.items()})
            halves = {"input": a["pair"][..., :3], "target": a["pair"][..., 3:]}
            for k in ("input", "target"):
                want = torch.from_numpy(halves[k].copy()).float() / 127.5 - 1.0
                assert torch.equal(got[k], want), k
            n += 1
        assert n == len(loader) > 0
    finally:
        loader.close()


@native
@pytest.mark.parametrize("u8", [True, False])
def test_make_native_loader_matches_jax(u8, tmp_path):
    """``make_native_loader``'s epochs (an ``EpochView`` of len(dataset) //
    batch batches over the infinite stream): random resized crops, flips and
    jitter from the cache of the untransformed images."""
    port_ds = SyntheticDefectDataset(32, 4, 10, "defects", seed=3)
    jax_ds = JaxSynthetic(32, 4, 10, "defects", seed=3)
    kw = dict(seed=5, num_threads=1, output_u8=u8)
    port = native_loader.make_native_loader(port_ds, tmp_path / "port", 16, 3,
                                            **kw)
    ref = jnative.make_native_loader(jax_ds, tmp_path / "jax", 16, 3, **kw)
    assert len(port) == len(ref) == 3
    try:
        for _ in range(2):
            got, want = list(port), list(ref)
            assert len(got) == len(want) == 3
            for (img, lbl, paths), (jimg, jlbl, jpaths) in zip(got, want):
                assert img.dtype == (np.uint8 if u8 else np.float32)
                assert img.shape == (3, 16, 16, 3)
                np.testing.assert_array_equal(img, jimg)
                np.testing.assert_array_equal(lbl, jlbl)
                assert paths == jpaths == []
    finally:
        port.loader.close()
        ref.loader.close()
