"""The port's input layer against the JAX package's.

The datasets, transforms and loaders are numpy copies, so they must give the
JAX package's arrays bit for bit (``np.array_equal``, no tolerance) for the
same seeds. ``device_prefetch`` on the CPU must hand out the loader's
batches unchanged and re-raise a loader error. The SEAN embedding bank must
read and write the JAX package's ``.npz`` layout, and sample only rows of
each label's own bank (exact equality of the picked rows).
"""
import numpy as np
import pytest
import torch

from de_i2i_gan_tpu.data import datasets as jdatasets
from de_i2i_gan_tpu.data import pipeline as jpipeline
from de_i2i_gan_tpu.data import transforms as jtransforms
from de_i2i_gan_tpu.data.embeddings import EmbeddingBank as JaxBank
from de_i2i_gan_tpu.data.synthetic import SyntheticDefectDataset as JaxSynthetic
from de_i2i_gan_torch.data import datasets, pipeline, transforms
from de_i2i_gan_torch.data.embeddings import EmbeddingBank, attach_embeddings
from de_i2i_gan_torch.data.synthetic import SyntheticDefectDataset
from de_i2i_gan_torch.nn.normalization import sean_label_index
from de_i2i_gan_torch.utils import seed as seed_utils
from de_i2i_gan_tpu.utils import seed as jseed_utils

torch.set_num_threads(1)


def _equal_items(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y)
        else:
            assert x == y


@pytest.mark.parametrize("data_type", ["defects", "background", "fusion"])
def test_synthetic_items_match_jax(data_type):
    for size, label_nc in ((32, 4), (40, 6)):
        ours = SyntheticDefectDataset(size, label_nc, 6, data_type, seed=5)
        ref = JaxSynthetic(size, label_nc, 6, data_type, seed=5)
        assert len(ours) == len(ref) and ours.clf_loss_type == ref.clf_loss_type
        for i in range(len(ref)):
            _equal_items(ours[i], ref[i])


def _batches(loader, epochs=2):
    return [b for _ in range(epochs) for b in loader]


@pytest.mark.parametrize("kw", [dict(), dict(shuffle=False, drop_last=False),
                                dict(num_samples=11)])
def test_dataloader_batches_match_jax(kw):
    """Two epochs: the shuffle is reseeded per epoch."""
    ours = pipeline.DataLoader(SyntheticDefectDataset(16, 4, 9), 2, seed=3, **kw)
    ref = jpipeline.DataLoader(JaxSynthetic(16, 4, 9), 2, seed=3, **kw)
    assert len(ours) == len(ref)
    got, want = _batches(ours), _batches(ref)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        _equal_items(g, w)


def _dual(pkg, synthetic, critics=2):
    df = pkg.DataLoader(synthetic(16, 4, 10, "defects", seed=2), 2, seed=7)
    bg = pkg.DataLoader(synthetic(16, 4, 6, "background", seed=2), 2, seed=8)
    return pkg.DualStreamLoader(df, bg, critics)


def test_dual_stream_loader_matches_jax():
    """Super-batches (num_critics, B, ...); the background stream restarts
    (6 images against 10 defects) as JAX's does."""
    ours, ref = _dual(pipeline, SyntheticDefectDataset), _dual(jpipeline, JaxSynthetic)
    assert len(ours) == len(ref) == 2
    got, want = _batches(ours), _batches(ref)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w) == ["bg", "df", "df_labels"]
        for k in w:
            assert g[k].shape[:2] == (2, 2) and np.array_equal(g[k], w[k]), k


def test_super_batch_loader_matches_jax():
    ours = pipeline.SuperBatchLoader(
        pipeline.DataLoader(SyntheticDefectDataset(16, 4, 12), 2, seed=1), 3)
    ref = jpipeline.SuperBatchLoader(
        jpipeline.DataLoader(JaxSynthetic(16, 4, 12), 2, seed=1), 3)
    got, want = list(ours), list(ref)
    assert len(got) == len(want) == len(ref) == 2
    for g, w in zip(got, want):
        for k in w:
            assert np.array_equal(g[k], w[k]), k


@pytest.fixture
def pil():
    return pytest.importorskip("PIL.Image")


def test_transforms_match_jax(pil):
    rng = np.random.default_rng(0)
    img = pil.fromarray(rng.integers(0, 255, (30, 44, 3), dtype=np.uint8))
    for ours, ref in ((transforms.TrainTransform(24), jtransforms.TrainTransform(24)),
                      (transforms.TrainTransform(24, randcrop_prob=0.5),
                       jtransforms.TrainTransform(24, randcrop_prob=0.5)),
                      (transforms.EvalTransform(24), jtransforms.EvalTransform(24)),
                      (transforms.EvalTransform(48), jtransforms.EvalTransform(48))):
        r_ours, r_ref = np.random.default_rng(11), np.random.default_rng(11)
        for _ in range(4):
            got, want = ours(img, r_ours), ref(img, r_ref)
            assert got.dtype == want.dtype == np.float32
            assert np.array_equal(got, want)


def _write_pngs(pil, d, n, rng):
    d.mkdir(parents=True)
    for i in range(n):
        pil.fromarray(rng.integers(0, 255, (40, 48, 3), dtype=np.uint8)
                      ).save(d / f"{d.name}_{i}.png")


def test_folder_datasets_match_jax(tmp_path, pil):
    """CodeBrim (metadata made from annotations.csv) and MVTec layouts on
    PNGs written here, read through the train transform."""
    rng = np.random.default_rng(5)
    root = tmp_path / "data"
    for phase in ("train", "test"):
        _write_pngs(pil, root / "codebrim" / phase / "defects", 3, rng)
        _write_pngs(pil, root / "codebrim" / phase / "background", 2, rng)
        for lbl in ("normal", "scratch", "crack"):
            _write_pngs(pil, root / "mtvec" / "pill" / phase / lbl, 2, rng)
    (root / "codebrim" / "annotations.csv").write_text("".join(
        f"defects_{i}.png,0,1,{i % 2},0\n" for i in range(3)))
    cases = [("codebrim", "fusion", {"label_nc": 4}),
             ("codebrim", "defects", {"label_nc": 4}),
             ("mtvec", "defects", {"dataset_data_type": "pill"}),
             ("mtvec", "fusion", {"dataset_data_type": "pill"})]
    for name, data_type, kw in cases:
        ours = datasets.find_dataset_using_name(name)(
            root, name, "train", data_type, transform=transforms.TrainTransform(24),
            seed=4, **kw)
        ref = jdatasets.find_dataset_using_name(name)(
            root, name, "train", data_type,
            transform=jtransforms.TrainTransform(24), seed=4, **kw)
        assert len(ours) == len(ref) > 0
        assert ours.clf_loss_type == ref.clf_loss_type
        for i in range(len(ref)):
            _equal_items(ours[i], ref[i])


def test_device_prefetch_on_cpu_yields_the_loader_batches():
    host = _batches(_dual(pipeline, SyntheticDefectDataset), epochs=1)
    got = list(pipeline.device_prefetch(_dual(pipeline, SyntheticDefectDataset),
                                        device="cpu"))
    assert len(got) == len(host) == 2
    for g, h in zip(got, host):
        assert sorted(g) == sorted(h)
        for k in h:
            assert isinstance(g[k], torch.Tensor) and g[k].device.type == "cpu"
            assert np.array_equal(g[k].numpy(), h[k])


def test_device_prefetch_reraises_loader_error():
    def loader():
        yield {"x": np.zeros(3, np.float32)}
        raise OSError("disk gone")

    it = pipeline.device_prefetch(loader(), device="cpu")
    assert torch.equal(next(it)["x"], torch.zeros(3))
    with pytest.raises(OSError, match="disk gone"):
        next(it)


def test_device_prefetch_abandoned_consumer_stops_the_producer():
    """A consumer that stops after one batch leaves no producer blocked."""
    import threading
    before = set(threading.enumerate())
    it = pipeline.device_prefetch(({"x": np.full(2, i)} for i in range(100)),
                                  device="cpu", depth=1)
    assert next(it)["x"].tolist() == [0, 0]
    producers = set(threading.enumerate()) - before
    assert len(producers) == 1
    it.close()
    for t in producers:
        t.join(timeout=5)
        assert not t.is_alive()


def _bank_dict(rng, label_nc=3, embed_nc=5):
    keys = [(1, 0, 0), (0, 1, 0), (0, 1, 1)]
    return {k: [rng.normal(size=embed_nc).astype(np.float32)
                for _ in range(2 + i)] for i, k in enumerate(keys)}


def test_embedding_bank_npz_round_trip_matches_jax(tmp_path):
    d = _bank_dict(np.random.default_rng(0))
    ours = EmbeddingBank.from_dict(d, 3, capacity=8)
    ref = JaxBank.from_dict(d, 3, capacity=8)
    assert np.array_equal(ours.bank, ref.bank)
    assert np.array_equal(ours.counts, ref.counts)
    ours.save(tmp_path / "ours.npz")
    ref.save(tmp_path / "ref.npz")
    for read in (JaxBank.load(tmp_path / "ours.npz"),
                 EmbeddingBank.load(tmp_path / "ref.npz")):
        assert (read.label_nc, read.embed_nc, read.capacity) == (3, 5, 8)
        assert np.array_equal(read.bank, ref.bank)
        assert np.array_equal(read.counts, ref.counts)


def test_embedding_bank_samples_rows_of_the_label():
    """Every sampled row is one of its label's bank rows; a label with no
    embeddings gets zeros. attach_embeddings fills both streams."""
    d = _bank_dict(np.random.default_rng(1))
    bank = EmbeddingBank.from_dict(d, 3, capacity=8)
    gen = torch.Generator().manual_seed(0)
    labels = torch.tensor([[1, 0, 0], [0, 1, 0], [0, 1, 1], [0, 0, 1]],
                          dtype=torch.float32)
    out = bank.sample(labels, 4, gen)
    assert out.shape == (4, 4, 5)
    for row, key in zip(out, [(1, 0, 0), (0, 1, 0), (0, 1, 1), None]):
        if key is None:
            assert torch.equal(row, torch.zeros_like(row))
            continue
        allowed = torch.from_numpy(np.stack(d[key]))
        for e in row:
            assert (allowed == e).all(dim=1).any()
    batch = {"df_labels": labels.reshape(2, 2, 3)}
    full = attach_embeddings(batch, bank, 3, gen)
    assert full["df_embeds"].shape == full["nm_embeds"].shape == (2, 2, 3, 5)
    nm_rows = torch.from_numpy(np.stack(d[(1, 0, 0)]))
    for e in full["nm_embeds"].reshape(-1, 5):
        assert (nm_rows == e).all(dim=1).any()
    assert torch.equal(sean_label_index(labels), torch.tensor([1, 2, 6, 4]))


def test_seed_helpers_match_jax():
    """fix_rand_seed pins numpy and random as JAX's does, and torch besides;
    worker_rng draws the same stream."""
    import random
    draws = []
    for fix in (seed_utils.fix_rand_seed, jseed_utils.fix_rand_seed):
        fix(7)
        draws.append((np.random.rand(3).tolist(), random.random()))
    assert draws[0] == draws[1]
    seed_utils.fix_rand_seed(7)
    a = torch.rand(3)
    seed_utils.fix_rand_seed(7)
    assert torch.equal(a, torch.rand(3))
    assert np.array_equal(seed_utils.worker_rng(3, 2).random(4),
                          jseed_utils.worker_rng(3, 2).random(4))
