"""The port's FAN (``models/wing.py``) against the JAX package on the CPU.

FAN at a 64^2 input from a flax init whose every bias, scale and BatchNorm
statistic is moved off its init value, carried into the port by
``train/jax_import.py::load_jax_fan``; ``preprocess_heatmaps`` and the
argmax landmarks on the same numpy heatmaps in both packages (so that the
0.1 threshold and argmax near-ties cannot flip); the two-mask path at 256^2
from a fixed heatmap; the reference-checkpoint loader on a state dict the
test writes; ``FaceAligner`` from fixed landmarks. Float32; forward
tolerance 5e-4 (DESIGN.md section 7).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from de_i2i_gan_tpu.models import wing as jwing
from de_i2i_gan_torch.models import wing
from de_i2i_gan_torch.train.jax_import import load_jax_fan

torch.set_num_threads(1)

TOL = 5e-4


@pytest.fixture(scope="module")
def fans():
    jfan = jwing.FAN()
    v = jfan.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    rng = np.random.default_rng(1)

    def moved(tree, positive=False):
        def f(a):
            a = np.asarray(a)
            d = rng.normal(0, 0.1, a.shape).astype(np.float32)
            return np.abs(a + d) + 0.5 if positive else a + d
        return jax.tree_util.tree_map(f, tree)

    stats = dict(v["batch_stats"])
    stats = jax.tree_util.tree_map_with_path(
        lambda p, a: moved(a, positive=p[-1].key == "var"), stats)
    v = {"params": moved(v["params"]), "batch_stats": stats}
    port = wing.FAN()
    load_jax_fan(port, v)
    return jfan, v, port


def close(got, ref, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(ref), atol=tol, rtol=tol)


def test_fan_matches_flax(fans):
    jfan, v, port = fans
    x = np.random.default_rng(2).uniform(0, 1, (2, 64, 64, 3)).astype(
        np.float32)
    out, boundary = jfan.apply(v, jnp.asarray(x))
    with torch.no_grad():
        got, got_b = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert got.shape == (2, 99, 16, 16)
    scale = float(np.abs(np.asarray(out)).max())
    close(got.permute(0, 2, 3, 1) / scale, np.asarray(out) / scale)
    close(got_b.permute(0, 2, 3, 1), boundary)


def heatmaps(seed, size=64):
    """Landmark-like heatmaps: one bump a channel, above and below the
    0.1 threshold, away from ties."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:size, :size].astype(np.float32)
    cy, cx = rng.uniform(8, size - 8, (2, 98))
    width = rng.uniform(2, 6, 98)
    hm = np.exp(-((yy[..., None] - cy) ** 2 + (xx[..., None] - cx) ** 2)
                / (2 * width ** 2))
    hm = hm * rng.uniform(0.3, 1.2, 98) + rng.uniform(0, 0.02, hm.shape)
    return hm[None].astype(np.float32)


@pytest.mark.parametrize("size", [256, 512])
def test_preprocess_heatmaps_matches_jax(size):
    hm = np.concatenate([heatmaps(3, size), heatmaps(4, size)])
    ref = jwing.preprocess_heatmaps(jnp.asarray(hm))
    got = wing.preprocess_heatmaps(torch.from_numpy(hm))
    for g, r in zip(got, ref):
        assert g.shape == (2, size, size, 1)
        close(g, r, 1e-5)
    assert 0.01 < float(got[0].mean()) < 0.99  # the masks are not flat


def test_landmarks_and_masks_from_fixed_heatmaps(fans, monkeypatch):
    """The argmax landmarks and the two masks from the same FAN output in
    both packages: FAN's apply is replaced by one fixed heatmap."""
    jfan, v, port = fans
    hm = heatmaps(5, 64)
    out = np.concatenate([hm, np.zeros((1, 64, 64, 1), np.float32)], -1)
    monkeypatch.setattr(jwing.FAN, "apply",
                        lambda self, vv, x: (jnp.asarray(out).repeat(
                            x.shape[0], 0), None))
    monkeypatch.setattr(wing.FAN, "forward", lambda self, x: (
        torch.from_numpy(out).permute(0, 3, 1, 2).repeat(x.shape[0], 1, 1, 1),
        None))
    jh, ph = jwing.WingHeatmapper(v), wing.WingHeatmapper(port)
    x = np.random.default_rng(6).uniform(-1, 1, (1, 128, 128, 3)).astype(
        np.float32)
    np.testing.assert_array_equal(ph.get_landmarks(x),
                                  jh.get_landmarks(jnp.asarray(x)))
    for g, r in zip(ph.get_heatmap(x), jh.get_heatmap(jnp.asarray(x))):
        assert g.shape == (1, 256, 256, 1)
        close(g, r, 1e-5)


def test_heatmapper_runs_fan_at_256(fans):
    """The whole heatmap path on the port's FAN: the input resized to 256^2,
    the heatmaps before the threshold, finite masks in [0, 1]."""
    _, _, port = fans
    x = torch.rand(1, 64, 64, 3) * 2 - 1
    hm = wing.landmark_heatmaps(port, x)
    assert hm.shape == (1, 64, 64, 98) and torch.isfinite(hm).all()
    masks = wing.WingHeatmapper(port).get_heatmap(x)
    assert [tuple(m.shape) for m in masks] == [(1, 256, 256, 1)] * 2
    assert all(((m >= 0) & (m <= 1)).all() for m in masks)


def test_wing_checkpoint_loader(fans, tmp_path):
    """A state dict under the reference's names (``downsample.0`` / ``.2``,
    ``m0.b2_plus_1``, ``num_batches_tracked``), in a ``state_dict`` entry
    as wing.ckpt holds it: the JAX and the port loaders agree."""
    jfan, v, port = fans
    sd = wing.wing_state_dict(port)
    assert "m0.b2_plus_1.bn1.running_var" in sd
    assert "conv2.downsample.2.weight" in sd
    sd["bn1.num_batches_tracked"] = torch.tensor(3)
    path = tmp_path / "wing.ckpt"
    torch.save({"state_dict": sd}, path)
    fresh = wing.make_fan("cpu", seed=9, wing_ckpt=path)
    jv = jwing.load_torch_wing_weights(str(path), v)
    x = np.random.default_rng(7).uniform(0, 1, (1, 64, 64, 3)).astype(
        np.float32)
    out, _ = jfan.apply(jv, jnp.asarray(x))
    with torch.no_grad():
        got, _ = fresh(torch.from_numpy(x).permute(0, 3, 1, 2))
        ref, _ = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    torch.testing.assert_close(got, ref, rtol=0, atol=0)
    scale = float(np.abs(np.asarray(out)).max())
    close(got.permute(0, 2, 3, 1) / scale, np.asarray(out) / scale)
    del sd["m0.b2_plus_1.conv3.weight"]
    torch.save(sd, path)
    with pytest.raises(KeyError, match="b2_plus_1.conv3"):
        wing.make_fan("cpu", wing_ckpt=path)


def test_face_aligner_matches_jax(fans, tmp_path, monkeypatch):
    """The similarity warp to the mean landmarks from the same landmarks."""
    jfan, v, port = fans
    rng = np.random.default_rng(8)
    mean = rng.uniform(60, 200, (98, 2)).astype(np.float32)
    np.savez(tmp_path / "lm.npz", mean=mean)
    lms = (mean + rng.normal(0, 6, (2, 98, 2))).astype(np.float32)
    monkeypatch.setattr(jwing.WingHeatmapper, "get_landmarks",
                        lambda self, x: lms)
    monkeypatch.setattr(wing.WingHeatmapper, "get_landmarks",
                        lambda self, x: lms)
    imgs = rng.uniform(-1, 1, (2, 256, 256, 3)).astype(np.float32)
    ref = jwing.FaceAligner(jwing.WingHeatmapper(v), str(tmp_path / "lm.npz"),
                            256).align(imgs)
    got = wing.FaceAligner(wing.WingHeatmapper(port), str(tmp_path / "lm.npz"),
                           256).align(imgs)
    assert got.shape == imgs.shape and np.isfinite(got).all()
    assert not np.allclose(got, imgs, atol=0.1)  # the faces moved
    close(got, ref, 1e-5)
