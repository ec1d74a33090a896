"""The port's C++ input feed (``de_i2i_gan_torch/runtime``) against the JAX
package's: the same cache bytes, the same batches (float32 and u8) and the
same dual-stream super-batches, bit for bit, with one loader thread and one
seed; a build that cannot happen raises; the train CLI trains through it on
the CPU.

Both packages build their own copy of ``dataloader.cc`` with g++; the tests
skip, as the JAX suite's ``tests/test_native_loader.py`` does, where the
JAX package cannot build its copy.
"""
import numpy as np
import pytest
import torch

from de_i2i_gan_tpu.data.synthetic import SyntheticDefectDataset as JaxSynthetic
from de_i2i_gan_tpu.runtime import native_loader as jnative
from de_i2i_gan_tpu.runtime.native_loader import native_available
from de_i2i_gan_torch.cli import train_defectgan
from de_i2i_gan_torch.data.synthetic import SyntheticDefectDataset
from de_i2i_gan_torch.runtime import native_loader
from de_i2i_gan_torch.train import trainer as trainer_module
from de_i2i_gan_torch.train.steps import DefectGanSteps

pytestmark = pytest.mark.skipif(not native_available(),
                                reason="no native toolchain")

torch.set_num_threads(1)

BATCHES = 4  # batches drawn from each loader


def _datasets(size=32, length=16, data_type="defects"):
    return (SyntheticDefectDataset(size, 6, length, data_type, seed=5),
            JaxSynthetic(size, 6, length, data_type, seed=5))


class _Bright:
    """A [-1, 1]-coded image whose minimum is above -0.01: the range guess
    reads it as [0, 1]."""

    def __len__(self):
        return 3

    def __getitem__(self, i):
        img = np.full((8, 10, 3), 0.25 * i, np.float32)
        return img, np.eye(3, dtype=np.float32)[i], f"bright://{i}"


CACHE_CASES = {
    "synthetic": dict(),
    "max_side": dict(max_side=20),  # shrunk with PIL
    "bright_pm1": dict(value_range="pm1"),
    "bright_guess": dict(),
    "grey": dict(channels=3),
}


def _cache_dataset(case):
    if case.startswith("bright"):
        return _Bright(), _Bright()
    if case == "grey":
        class Grey(_Bright):
            def __getitem__(self, i):
                img, lbl, p = super().__getitem__(i)
                return (img[..., 0] * 255).astype(np.uint8), lbl, p
        return Grey(), Grey()
    return _datasets()


@pytest.mark.parametrize("case", sorted(CACHE_CASES))
def test_build_cache_bytes_match_jax(case, tmp_path):
    port_ds, jax_ds = _cache_dataset(case)
    kw = CACHE_CASES[case]
    port = native_loader.build_cache(port_ds, tmp_path / "port", **kw)
    ref = jnative.build_cache(jax_ds, tmp_path / "jax", **kw)
    for a, b in zip(port, ref):
        assert a.read_bytes() == b.read_bytes(), a.name
    assert ((tmp_path / "port" / "meta.json").read_text()
            == (tmp_path / "jax" / "meta.json").read_text())


def test_build_cache_reuses_only_a_matching_cache(tmp_path):
    small, _ = _datasets(size=16, length=8)
    cache, _ = native_loader.build_cache(small, tmp_path)
    size16 = cache.stat().st_size
    bigger, _ = _datasets(size=24, length=8)
    cache, _ = native_loader.build_cache(bigger, tmp_path)
    assert cache.stat().st_size != size16, "a stale cache was reused"
    mtime = cache.stat().st_mtime_ns
    native_loader.build_cache(bigger, tmp_path)
    assert cache.stat().st_mtime_ns == mtime


@pytest.mark.parametrize("u8", [False, True], ids=["f32", "u8"])
@pytest.mark.parametrize("augment", [True, False], ids=["augment", "center"])
def test_batches_match_jax(u8, augment, tmp_path):
    port_ds, jax_ds = _datasets(size=40, length=12)
    cache, index = native_loader.build_cache(port_ds, tmp_path / "port")
    jcache, jindex = jnative.build_cache(jax_ds, tmp_path / "jax")
    kw = dict(image_size=32, batch_size=3, num_threads=1, seed=11,
              augment=augment, output_u8=u8)
    port = native_loader.NativeDataLoader(cache, index, **kw)
    ref = jnative.NativeDataLoader(jcache, jindex, **kw)
    assert (port.label_nc, port.n_items) == (ref.label_nc, ref.n_items) == (
        6, 12)
    try:
        for _ in range(BATCHES):  # past an epoch: the reshuffle too
            img, lbl, _ = next(port)
            jimg, jlbl, _ = next(ref)
            assert img.dtype == (np.uint8 if u8 else np.float32)
            assert img.shape == (3, 32, 32, 3) and lbl.shape == (3, 6)
            np.testing.assert_array_equal(img, jimg)
            np.testing.assert_array_equal(lbl, jlbl)
    finally:
        port.close()
        ref.close()


def test_dual_stream_super_batches_match_jax(tmp_path):
    port_df, jax_df = _datasets(size=48, length=20)
    port_bg, jax_bg = _datasets(size=48, length=12, data_type="background")
    kw = dict(image_size=32, batch_size=2, num_critics=3, seed=4,
              num_threads=1)
    port = native_loader.make_native_dual_stream(port_df, port_bg,
                                                 tmp_path / "port", **kw)
    ref = jnative.make_native_dual_stream(jax_df, jax_bg, tmp_path / "jax", **kw)
    try:
        assert len(port) == len(ref) == 20 // 2 // 3
        for _ in range(2):  # two epochs
            got, want = list(port), list(ref)
            assert len(got) == len(want) == len(port)
            for b, jb in zip(got, want):
                assert sorted(b) == ["bg", "df", "df_labels"]
                assert b["df"].dtype == b["bg"].dtype == np.uint8
                assert b["df"].shape == (3, 2, 32, 32, 3)
                for k in b:
                    np.testing.assert_array_equal(b[k], jb[k], err_msg=k)
            # every super-batch is a fresh buffer
            assert got[0]["df"].ctypes.data != got[1]["df"].ctypes.data
    finally:
        port.close()
        ref.close()


def _fresh_build(monkeypatch, tmp_path):
    monkeypatch.setattr(native_loader, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native_loader, "_lib", None)


def test_missing_compiler_raises(monkeypatch, tmp_path):
    _fresh_build(monkeypatch, tmp_path)
    monkeypatch.setattr(native_loader, "CXX", "no-such-g++")
    ds, _ = _datasets(length=4)
    cache, index = native_loader.build_cache(ds, tmp_path / "cache")
    with pytest.raises(RuntimeError, match="no-such-g\\+\\+ not found"):
        native_loader.NativeDataLoader(cache, index, 32, 2)
    assert native_loader._lib is None
    assert not list((tmp_path / "build").glob("*"))


def test_failed_build_raises_with_the_compiler_output(monkeypatch, tmp_path):
    _fresh_build(monkeypatch, tmp_path)
    bad = tmp_path / "dataloader.cc"
    bad.write_text("int dl_create( {\n")
    monkeypatch.setattr(native_loader, "SOURCE", bad)
    with pytest.raises(RuntimeError, match=r"(?s)g\+\+ failed .*error: expected"):
        native_loader.build()
    assert not list((tmp_path / "build").glob("*.so"))


def test_library_built_once_and_named_by_source(monkeypatch, tmp_path):
    _fresh_build(monkeypatch, tmp_path)
    path = native_loader.build()
    assert path.parent == tmp_path / "build" and path.exists()
    assert path == native_loader._library_path()
    src = tmp_path / "dataloader.cc"
    src.write_text(native_loader.SOURCE.read_text() + "\n// edited\n")
    monkeypatch.setattr(native_loader, "SOURCE", src)
    assert native_loader._library_path() != path


def test_cli_native_loader_trains_one_epoch(tmp_path, monkeypatch):
    """``--native_loader --gpu_ids -1`` at tiny widths: one epoch of the JAX
    CLI's iteration count (the native super-batch count times the critics),
    u8 super-batches reaching the step, checkpoints written."""
    writer = trainer_module.TBWriter
    monkeypatch.setattr(trainer_module, "TBWriter", lambda _: writer(None))
    seen = []
    real = DefectGanSteps.super_step

    def super_step(self, batches, generator=None):
        seen.append({k: (v.dtype, v.device.type) for k, v in batches.items()})
        return real(self, batches, generator)

    monkeypatch.setattr(DefectGanSteps, "super_step", super_step)
    critics, batch = 8, 16
    argv = ["--name", "nat", "--ckpt_dir", str(tmp_path / "ckpt"),
            "--log_dir", str(tmp_path / "logs"), "--dataset_name",
            "synthetic", "--image_size", "32", "--label_nc", "4",
            "--batch_size", str(batch), "--ngf", "8", "--ndf", "8",
            "--num_scales", "2", "--num_res", "2", "--hidden_nc", "16",
            "--num_layers", "2", "--gpu_ids", "-1",
            "--style_norm_block_type", "adain", "--num_epochs", "1",
            "--num_critics", str(critics), "--save_ckpt_freq", "1",
            "--native_loader"]
    tr = train_defectgan.main(argv)
    # the JAX CLI's count: its native loader's length over the same
    # synthetic datasets, times the critics
    jds = [JaxSynthetic(32, 4, 512, dt, seed=123)
           for dt in ("defects", "background")]
    jloader = jnative.make_native_dual_stream(*jds, tmp_path / "jax_cache", 32,
                                              batch, critics, num_threads=1)
    jax_super_steps = len(jloader)
    jloader.close()
    assert tr.iters == jax_super_steps * critics == 32
    assert len(seen) == jax_super_steps
    assert all(s["df"] == s["bg"] == (torch.uint8, "cpu") for s in seen)
    run = tmp_path / "ckpt" / "nat"
    assert (run / "iter.txt").read_text() == "1,32\n"
    assert (run / "1_state.pt").exists() and (run / "latest_state.pt").exists()
    cache = tmp_path / "ckpt" / "native_cache" / "nat"
    assert sorted(p.name for p in cache.iterdir()) == ["background", "defects"]
    for p in tr.steps.G.parameters():
        assert torch.isfinite(p).all()
