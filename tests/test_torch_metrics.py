"""The port's metric nets and math (``metrics/inception.py``,
``metrics/lpips.py``, ``metrics/fid.py``) against the JAX package's on the
CPU.

InceptionV3 runs at 75², the smallest input it takes, with
``resize_input`` off (the JAX suite compiles it at 299² elsewhere; here a
compile of the whole net at 75² is enough), its flax variables carried
into the port by ``train/jax_import.py::load_jax_inception``, BatchNorm
statistics and scales moved off their init so that every leaf is tested.
Tolerances: the taps within 1e-4 relative L2 (float32 through 94 layers
in two conv libraries); LPIPS within 5e-4 (DESIGN.md section 7); the
torchvision-keyed loaders against ``tests/torch_ref_nets.py`` within 1e-5
(the same torch convolutions); the numpy math within 1e-10 relative (the
same code).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from de_i2i_gan_tpu.metrics import fid as jfid
from de_i2i_gan_tpu.metrics.inception import InceptionV3 as JaxInception
from de_i2i_gan_tpu.metrics.lpips import LPIPS as JaxLPIPS
from de_i2i_gan_torch.metrics import fid
from de_i2i_gan_torch.metrics.inception import (
    InceptionV3, load_torch_inception_weights, seeded_inception)
from de_i2i_gan_torch.metrics.lpips import (
    LPIPS, load_torch_lpips_weights, pairwise_lpips, seeded_lpips)
from de_i2i_gan_torch.train.jax_import import load_jax_inception, load_jax_lpips

torch.set_num_threads(1)

REL_L2 = 1e-4
LPIPS_TOL = 5e-4
REF_TOL = 1e-5


def images(seed, n, size):
    return np.random.default_rng(seed).uniform(
        -1, 1, (n, size, size, 3)).astype(np.float32)


def rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _moved(tree, seed):
    """Every leaf of a flax tree nudged from its init, so that none of them
    goes untested."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32) + rng.normal(
            0, 0.05, np.shape(a)).astype(np.float32), tree)


def _inception_variables(v, seed):
    """The flax init moved so the features neither vanish nor saturate
    through the ReLU stack: kernels at He scale (the init is LeCun's),
    BatchNorm's statistics and affine drawn near the identity."""
    rng = np.random.default_rng(seed)

    def move(path, a):
        a = np.asarray(a, np.float32)
        leaf = path[-1].key
        if leaf == "kernel":
            return a * np.sqrt(2.0)
        if leaf in ("scale", "var"):
            return rng.uniform(0.8, 1.2, a.shape).astype(np.float32)
        return rng.normal(0, 0.02, a.shape).astype(np.float32)  # bias, mean
    return jax.tree_util.tree_map_with_path(move, v)


@pytest.fixture(scope="module")
def inception_pair():
    net = JaxInception(output_blocks=(0, 1, 2, 3), resize_input=False)
    v = _inception_variables(
        net.init(jax.random.PRNGKey(3), jnp.zeros((1, 75, 75, 3))), 1)
    port = InceptionV3((0, 1, 2, 3), resize_input=False).eval()
    load_jax_inception(port, v)
    return net, v, port


def test_inception_taps_match_jax(inception_pair):
    """Every tap (64, 192, 768 maps NHWC; the 2048 pool) at 75²."""
    net, v, port = inception_pair
    x = images(0, 2, 75)
    want = jax.jit(net.apply)(v, jnp.asarray(x))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert sorted(got) == [0, 1, 2, 3]
    for block in range(4):
        assert got[block].shape == want[block].shape, block
        assert rel_l2(got[block], want[block]) < REL_L2, block
    # the features depend on the input
    assert np.abs(np.asarray(got[3][0] - got[3][1])).mean() > 1e-3


def test_inception_stops_at_the_last_tap():
    port = InceptionV3((1,), resize_input=False)
    assert not hasattr(port, "Mixed_5b")
    out = port.eval()(torch.zeros(1, 75, 75, 3))
    assert list(out) == [1] and out[1].shape == (1, 7, 7, 192)


def test_inception_resizes_to_299():
    """resize_input: a 64² input becomes 299² first (block 0 at 73²)."""
    port = seeded_inception((0,), seed=1, device="cpu")
    out = port(torch.from_numpy(images(1, 1, 64)))[0]
    assert out.shape == (1, 73, 73, 64)


def test_lpips_matches_jax():
    net = JaxLPIPS()
    x, y = images(4, 3, 64), images(5, 3, 64)
    v = net.init(jax.random.PRNGKey(5), jnp.zeros((1, 64, 64, 3)),
                 jnp.zeros((1, 64, 64, 3)))
    v = {"params": _moved(v["params"], 6)}
    want = np.asarray(jax.jit(net.apply)(v, jnp.asarray(x), jnp.asarray(y)))
    port = LPIPS().eval()
    load_jax_lpips(port, v)
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    assert got.shape == (3,) and (want > 0).all()
    np.testing.assert_allclose(got, want, rtol=LPIPS_TOL, atol=LPIPS_TOL)
    with torch.no_grad():
        pair = float(pairwise_lpips(port, torch.from_numpy(x)))
        want_pair = port(torch.from_numpy(x[[0, 0, 1]]),
                         torch.from_numpy(x[[1, 2, 2]])).mean()
    assert pair == pytest.approx(float(want_pair), rel=1e-6)


def _he_init(net, seed):
    torch.manual_seed(seed)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, torch.nn.Conv2d):
                torch.nn.init.kaiming_normal_(m.weight, nonlinearity="relu")
                if m.bias is not None:
                    m.bias.uniform_(-0.1, 0.1)
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.uniform_(-0.2, 0.2)
                m.running_var.uniform_(0.5, 1.5)
                m.weight.uniform_(0.8, 1.2)
                m.bias.uniform_(-0.1, 0.1)
    return net


def test_torchvision_keyed_inception_loads(tmp_path):
    """A state dict under torchvision's keys (the reference nets of
    tests/torch_ref_nets.py) loads key for key and computes the same
    pool features."""
    from tests.torch_ref_nets import FIDInceptionTorch
    ref = _he_init(FIDInceptionTorch(), 123).eval()
    path = tmp_path / "fid_inception.pth"
    torch.save(ref.state_dict(), path)
    port = load_torch_inception_weights(
        path, InceptionV3((3,), resize_input=False)).eval()
    x = images(7, 2, 75)
    with torch.no_grad():
        want = ref(torch.from_numpy(x.transpose(0, 3, 1, 2).copy())).numpy()
        got = port(torch.from_numpy(x))[3].numpy()
    assert rel_l2(got, want) < REF_TOL
    with pytest.raises(KeyError, match="no weights"):
        torch.save({"fc.weight": torch.zeros(1)}, tmp_path / "bad.pth")
        load_torch_inception_weights(tmp_path / "bad.pth", InceptionV3())


def test_torchvision_keyed_lpips_loads(tmp_path):
    from tests.torch_ref_nets import AlexNetFeaturesTorch
    alex = _he_init(AlexNetFeaturesTorch(), 9).eval()
    torch.save(alex.state_dict(), tmp_path / "alexnet.pth")
    lins = {f"lin{i}.model.1.weight":
            torch.rand(1, c, 1, 1, generator=torch.Generator().manual_seed(i))
            for i, c in enumerate((64, 192, 384, 256, 256))}
    torch.save(lins, tmp_path / "alex.pth")
    port = load_torch_lpips_weights(tmp_path / "alexnet.pth",
                                    tmp_path / "alex.pth", LPIPS()).eval()
    x = images(8, 2, 64)
    with torch.no_grad():
        xn = (torch.from_numpy(x).permute(0, 3, 1, 2) - port.shift) / port.scale
        want = alex(xn)
        got = port.alex(xn)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert rel_l2(g, w) < REF_TOL
    for i in range(5):
        np.testing.assert_array_equal(getattr(port, f"lin{i}").detach().numpy(),
                                      lins[f"lin{i}.model.1.weight"].reshape(-1))


def test_seeded_nets_repeat_and_depend_on_input():
    a, b = seeded_lpips(3, "cpu"), seeded_lpips(3, "cpu")
    x, y = torch.from_numpy(images(9, 2, 64)), torch.from_numpy(images(10, 2, 64))
    d = a(x, y)
    assert torch.equal(d, b(x, y)) and (d > 0).all()
    assert torch.equal(a(x, x), torch.zeros(2))


# ------------------------------------------------------------- fid.py math
def _acts(seed, n=40, d=8):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, d)) @ rng.normal(size=(d, d)) * 0.3


@pytest.mark.parametrize("name", ["stats", "frechet", "inception_score",
                                  "mfid", "npz"])
def test_fid_math_matches_jax(name, tmp_path):
    a, b = _acts(0), _acts(1) + 0.5
    if name == "stats":
        st, jst = fid.ActivationStats(8), jfid.ActivationStats(8)
        for part in (a[:15], a[15:]):
            st.update(part)
            jst.update(part)
        for got, want in zip(st.finalize(), jst.finalize()):
            np.testing.assert_allclose(got, want, rtol=1e-10)
        np.testing.assert_allclose(st.finalize()[1], np.cov(a, rowvar=False),
                                   rtol=1e-10, atol=1e-12)
    elif name == "frechet":
        s1, s2 = fid.ActivationStats(8), fid.ActivationStats(8)
        s1.update(a)
        s2.update(b)
        got = fid.frechet_distance(*s1.finalize(), *s2.finalize())
        want = jfid.frechet_distance(*s1.finalize(), *s2.finalize())
        assert got == pytest.approx(want, rel=1e-10) and got > 0
    elif name == "inception_score":
        logits = np.random.default_rng(2).normal(size=(50, 10))
        probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
        assert fid.inception_score(probs) == pytest.approx(
            jfid.inception_score(probs), rel=1e-10)
    elif name == "mfid":
        s = fid.ActivationStats(8)
        s.update(a)
        real = {"1": s.finalize(), "2": s.finalize()}
        fake = {"1": b, "2": a, "3": b}
        got, want = fid.mfid_from_class_stats(real, fake), \
            jfid.mfid_from_class_stats(real, fake)
        assert got.keys() == want.keys() == {"1", "2", "mean"}
        for k in got:
            assert got[k] == pytest.approx(want[k], rel=1e-10, abs=1e-10)
    else:
        mu, sigma = a.mean(0), np.cov(a, rowvar=False)
        fid.save_stats_npz(tmp_path / "s.npz", mu, sigma)
        for got, want in zip(jfid.load_stats_npz(tmp_path / "s.npz"),
                             (mu, sigma)):
            np.testing.assert_array_equal(got, want)
