"""StarGAN v2 FusedProp, the solver's checkpoints and the data copy, against
the JAX package on the CPU.

* ``fused_pair_step``: one AdaIN ``train_step`` with ``fused_prop`` in both
  packages from one continued JAX ``SolverState``
  (``tests/test_torch_starganv2_train_step.py``), held as the alternating
  step is: metrics rtol 2e-4, each net's update and Adam moments per tensor
  (``STEP_REL``), counts, EMA nets, step. Each pair shares one fake
  forward; D's gradient comes from the D term on the detached fakes, G's,
  M's and S's from the G term, both before either update.
* Checkpoints: the solver's whole state (every net's ``state_dict``, each
  optimizer's count and moments by parameter name, ``step``) written to
  ``<dir>/starganv2/<tag>_state.pt`` and read back exactly; a strict load
  refuses a state that does not fit.
* ``data/starganv2_data.py``: batches from one image tree bit-identical to
  the JAX package's, z draws included.
"""
import numpy as np
import pytest
import torch

from de_i2i_gan_tpu.data import starganv2_data as jdata
from de_i2i_gan_tpu.data import transforms as jtransforms
from de_i2i_gan_torch.data import starganv2_data as data
from de_i2i_gan_torch.data import transforms
from de_i2i_gan_torch.train import checkpoint
from de_i2i_gan_torch.train.solver import StarGANv2Config, StarGANv2Solver
from tests.test_torch_starganv2_train import config, make_batch, torch_batch
from tests.test_torch_starganv2_train_step import check_step, step_run

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def fused_run():
    return step_run("adain", fused_prop=True)


def test_fused_train_step_matches_jax(fused_run):
    check_step(*fused_run)


def test_fused_pair_step_launches_one_fake_forward_a_pass(fused_run, monkeypatch):
    """Three G forwards a pass (the shared fake, x_fake2, x_rec), not the
    four of a D step plus a G step."""
    port = fused_run[3]
    calls = []
    real = type(port.G).forward

    def counted(self, *args, **kw):
        calls.append(self)
        return real(self, *args, **kw)

    monkeypatch.setattr(type(port.G), "forward", counted)
    batch = port._batch(torch_batch(make_batch(9)))
    counts = (port.tx_G.count, port.tx_D.count, port.tx_M.count)
    port.fused_pair_step(batch, latent=False)
    assert len(calls) == 3 and all(c is port.G for c in calls)
    assert (port.tx_G.count, port.tx_D.count, port.tx_M.count) == (
        counts[0] + 1, counts[1] + 1, counts[2])


# ----------------------------------------------------------- checkpoints


def test_checkpoint_round_trip_is_exact(fused_run, tmp_path):
    port = fused_run[3]
    path = checkpoint.save_checkpoint(tmp_path, "starganv2", "000007", port)
    assert path == tmp_path / "starganv2" / "000007_state.pt"
    assert sorted(p.name for p in path.parent.iterdir()) == ["000007_state.pt"]
    state = checkpoint.read_checkpoint(tmp_path, "starganv2", "000007")
    assert set(state) == {"step", "G", "D", "M", "S", "ema_G", "ema_M",
                          "ema_S", "tx_G", "tx_D", "tx_M", "tx_S"}
    assert state["step"] == port.step and state["tx_M"]["count"] == port.tx_M.count
    fresh = StarGANv2Solver(StarGANv2Config(**config("adain", fused_prop=True)),
                            device="cpu")
    fresh.init_training()
    checkpoint.load_checkpoint(tmp_path, "starganv2", "000007", fresh)
    want = checkpoint.clone_state(checkpoint.train_state(port))
    got = checkpoint.train_state(fresh)
    flat_w, flat_g = _flat(want), _flat(got)
    assert flat_w.keys() == flat_g.keys()
    for k, v in flat_w.items():
        same = torch.equal(v, flat_g[k]) if isinstance(v, torch.Tensor) \
            else v == flat_g[k]
        assert same, k
    assert fresh.step == port.step and fresh.tx_S.count == port.tx_S.count


def test_sean_checkpoint_keeps_the_ema_statistics(tmp_path):
    """SEAN's G and ema_G keep their own statistics through a round trip
    (ema_G's are not synced from G's, as DefectGAN's EMA generator is)."""
    kw = config("sean")
    solver = StarGANv2Solver(StarGANv2Config(**kw), device="cpu")
    solver.init_training()
    with torch.no_grad():
        for i, b in enumerate(solver.ema_G.buffers()):
            b.fill_(float(i + 1))
    checkpoint.save_checkpoint(tmp_path, "starganv2", "latest", solver)
    fresh = StarGANv2Solver(StarGANv2Config(**kw), device="cpu")
    fresh.init_training()
    checkpoint.load_checkpoint(tmp_path, "starganv2", "latest", fresh)
    for a, b in zip(fresh.ema_G.buffers(), solver.ema_G.buffers()):
        assert torch.equal(a, b)
    assert not any(b.any() for b in fresh.G.buffers())


def test_strict_load_refuses_another_layout(fused_run, tmp_path):
    checkpoint.save_checkpoint(tmp_path, "starganv2", "latest", fused_run[3])
    sean = StarGANv2Solver(StarGANv2Config(**config("sean")), device="cpu")
    sean.init_training()
    with pytest.raises(KeyError, match="does not fit"):
        checkpoint.load_checkpoint(tmp_path, "starganv2", "latest", sean)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


# ------------------------------------------------------------------ data


def _image_tree(root, seed, domains=("cat", "dog", "wild"), per_domain=5):
    """PNGs of varied sizes from a seed under root/<domain>/."""
    from PIL import Image
    rng = np.random.default_rng(seed)
    for d in domains:
        (root / d).mkdir(parents=True)
        for i in range(per_domain + (d == "dog")):
            h, w = rng.integers(40, 72, 2)
            arr = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            Image.fromarray(arr).save(root / d / f"{i:03d}.png")
    return root


def _fetchers(pkg, tf_mod, root, batch, seed, randcrop_prob):
    tf = tf_mod.TrainTransform(48, jitter=False, vflip=False,
                               randcrop_prob=randcrop_prob)
    src = pkg.BalancedLoader(pkg.ImageFolderDataset(root, tf, seed), batch,
                             seed=seed, num_threads=1)
    ref = pkg.make_reference_loader(pkg.ReferenceDataset(root, tf, seed),
                                    batch, seed=seed + 1, num_threads=1)
    return pkg.InputFetcher(src, ref, latent_dim=4, seed=seed)


@pytest.mark.parametrize("randcrop_prob", [0.5, 1.0])
def test_input_fetcher_batches_are_the_jax_packages_bit_for_bit(
        tmp_path, randcrop_prob):
    """Ten batches of 3 from 16 images in 3 domains (more than an epoch of
    each loader): images, domains, reference pairs and z draws."""
    root = _image_tree(tmp_path, 0)
    assert data.list_domains(root) == jdata.list_domains(root) == [
        "cat", "dog", "wild"]
    ours = _fetchers(data, transforms, root, 3, 5, randcrop_prob)
    theirs = _fetchers(jdata, jtransforms, root, 3, 5, randcrop_prob)
    for _ in range(10):
        a, b = next(ours), next(theirs)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def test_reference_datasets_and_balanced_indices_match_jax(tmp_path):
    root = _image_tree(tmp_path, 1)
    tf = transforms.EvalTransform(32)
    jtf = jtransforms.EvalTransform(32)
    ours = data.RandomReferenceDataset(root, 3, tf, seed=2)
    theirs = jdata.RandomReferenceDataset(root, 3, jtf, seed=2)
    for i in (0, 7, 15):
        a, b = ours[i], theirs[i]
        assert a[0].shape == (3, 32, 32, 3) and np.array_equal(a[0], b[0])
        assert a[1] == b[1] and a[2] == b[2]
    assert np.array_equal(data.ReferenceDataset(root, tf, 4).pairs,
                          jdata.ReferenceDataset(root, jtf, 4).pairs)
    labels = np.asarray([0, 0, 0, 1, 2, 2])
    assert np.array_equal(
        data.balanced_indices(labels, 50, np.random.default_rng(3)),
        jdata.balanced_indices(labels, 50, np.random.default_rng(3)))
