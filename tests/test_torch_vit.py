"""The port's ViT (``models/vit.py``), its classifier workload
(``train/vit_steps.py``, ``models/discriminator.py::ViTClassifier``) and
its weight loaders against the JAX package on the CPU.

Tiny ViT sizes registered in both packages' ``SIZES`` under this file's own
names (a shared key would change what other test files build; see
``tests/test_vit.py``). Weights come from a flax init carried into the port
by ``train/jax_import.py::load_jax_vit`` (the unrolled ``block_<i>`` layout
and the scanned ``blocks_scan`` layout). Float32; forward tolerance 5e-4
(DESIGN.md section 7).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import de_i2i_gan_tpu.models.vit as jvit
from de_i2i_gan_tpu.config import TrainConfig as JaxTrainConfig
from de_i2i_gan_tpu.train.vit_steps import ViTSteps as JaxViTSteps
from de_i2i_gan_tpu.train.vit_steps import dump_embeddings as jax_dump
from de_i2i_gan_torch.config import TrainConfig
from de_i2i_gan_torch.models import vit
from de_i2i_gan_torch.train.jax_import import load_jax_module, load_jax_vit
from de_i2i_gan_torch.train.vit_steps import ViTSteps, dump_embeddings

torch.set_num_threads(1)

TOL = 5e-4
SIZE = "torch_vit_test"
for _sizes in (jvit.SIZES, vit.SIZES):
    _sizes[SIZE] = dict(hidden=32, layers=2, heads=2, mlp=64)


def images(seed, *shape):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, shape).astype(np.float32)


def jax_encoder(image_size=32, seed=1):
    net = jvit.ViTEncoder(model_size=SIZE, patch=16, image_size=image_size)
    v = net.init(jax.random.PRNGKey(seed),
                 jnp.zeros((1, image_size, image_size, 3)))
    # move the zero-initialized leaves off zero (the CLS token, biases,
    # LayerNorm) so that every one of them is tested
    leaves, tree = jax.tree_util.tree_flatten(v["params"])
    rng = np.random.default_rng(seed)
    leaves = [np.asarray(a) + rng.normal(0, 0.05, a.shape).astype(np.float32)
              for a in leaves]
    return net, {"params": jax.tree_util.tree_unflatten(tree, leaves)}


def port_encoder(params, image_size=32):
    net = vit.ViTEncoder(SIZE, patch=16, image_size=image_size)
    load_jax_vit(net, params)
    return net


def close(got, ref, tol=TOL):
    np.testing.assert_allclose(np.asarray(got.detach() if isinstance(
        got, torch.Tensor) else got), np.asarray(ref), atol=tol, rtol=tol)


@pytest.mark.parametrize("layout", ["unrolled", "scanned"])
def test_encoder_matches_flax(layout):
    jnet, v = jax_encoder()
    x = images(2, 3, 32, 32, 3)
    ref = jnet.apply(v, jnp.asarray(x))
    params = v["params"]
    if layout == "scanned":
        params = jvit.stack_vit_params(params, model_size=SIZE)
        assert "blocks_scan" in params
    net = port_encoder(params)
    with torch.no_grad():
        out = net(torch.from_numpy(x))
    assert out.shape == (3, 5, 32)
    close(out, ref)


def test_encoder_resize_256_to_224_matches_jax_image_resize():
    """The 256 -> 224 resize antialiases as jax.image.resize does."""
    jnet, v = jax_encoder(image_size=224)
    x = images(3, 2, 256, 256, 3)
    ref = jnet.apply(v, jnp.asarray(x))
    with torch.no_grad():
        out = port_encoder(v["params"], image_size=224)(torch.from_numpy(x))
    assert out.shape == (2, 197, 32)
    close(out, ref)
    plain = jax.image.resize(jnp.asarray(x), (2, 224, 224, 3), "bilinear")
    got = vit.resize_bilinear(torch.from_numpy(x).permute(0, 3, 1, 2), 224)
    close(got.permute(0, 2, 3, 1), plain, 1e-5)


@pytest.mark.parametrize("num_embeds", [-3, 4])
def test_feature_extractor(num_embeds):
    jnet, v = jax_encoder()
    fe = jvit.FeatureExtractor(v, model_size=SIZE)
    fe.net = jnet  # the tiny geometry, as tests/test_vit.py does
    fe._embed = jax.jit(lambda vv, x: jnet.apply(vv, x)[:, 0, :])
    port = vit.FeatureExtractor(port_encoder(v["params"]))
    x5 = images(4, 2, 5, 32, 32, 3)
    gen = torch.Generator().manual_seed(0)
    got = port.extract(x5, num_embeds, gen)
    k = got.shape[1]
    assert got.shape == (2, k, 32) and 1 <= k <= 5
    if num_embeds < 0:
        assert k == -num_embeds
    # the same k through the JAX extractor
    close(got, fe.extract(jnp.asarray(x5), -k))
    one = port.extract(x5[:, 0], 1)
    assert one.shape == (2, 1, 32)
    close(one, fe.extract(jnp.asarray(x5[:, 0]), 1))
    assert not any(p.requires_grad for p in port.net.parameters())


def test_classifier_step_and_eval_match_jax():
    """One AdamW cosine step of the head from the same weights: loss,
    accuracy and the head after the step."""
    kw = dict(batch_size=4, optimizer="adamw", lr=(1e-2,), scheduler="cos",
              clf_loss_type="cce")
    jsteps = JaxViTSteps(label_nc=3, tcfg=JaxTrainConfig(**kw),
                         model_size=SIZE, iters_per_epoch=10, num_epochs=5,
                         image_size=32)
    jsteps.backbone = jvit.ViTEncoder(model_size=SIZE, patch=16,
                                      image_size=32)
    state = jsteps.init_state(jax.random.PRNGKey(0))
    port = ViTSteps(3, TrainConfig(**kw), SIZE, iters_per_epoch=10,
                    num_epochs=5, backbone=port_encoder(
                        jsteps._vit_vars["params"]), device="cpu")
    load_jax_module(port.head, state.params)
    x = images(5, 4, 32, 32, 3)
    labels = np.eye(3, dtype=np.float32)[[0, 1, 2, 1]]
    new_state, jm = jsteps.train_step(state, jnp.asarray(x), jnp.asarray(labels))
    m = port.train_step(torch.from_numpy(x), torch.from_numpy(labels))
    close(m["loss"], jm["loss"], 1e-5)
    assert float(m["acc"]) == float(jm["acc"])
    close(port.head.clf.weight.T, new_state.params["clf"]["kernel"], 1e-5)
    close(port.head.clf.bias, new_state.params["clf"]["bias"], 1e-5)
    assert port.step == 1 and port.tx_head.count == 1
    ev, jev = (port.eval_step(x, labels),
               jsteps.eval_step(new_state, jnp.asarray(x), jnp.asarray(labels)))
    close(ev["loss"], jev["loss"], 1e-5)
    assert not any(p.grad is not None for p in port.backbone.parameters())


def test_dump_embeddings_matches_jax():
    jsteps = JaxViTSteps(label_nc=3, tcfg=JaxTrainConfig(batch_size=4),
                         model_size=SIZE, image_size=32)
    jsteps.backbone = jvit.ViTEncoder(model_size=SIZE, patch=16,
                                      image_size=32)
    jsteps.init_state(jax.random.PRNGKey(0))
    port = ViTSteps(3, TrainConfig(batch_size=4), SIZE, backbone=port_encoder(
        jsteps._vit_vars["params"]), device="cpu")
    x = images(6, 4, 32, 32, 3)
    labels = np.eye(3, dtype=np.float32)[[0, 1, 2, 0]]

    def loader():
        yield x, labels, ["a", "b", "c", "d"]

    ref, bank = jax_dump(jsteps, loader(), 3), dump_embeddings(port, loader(), 3)
    assert set(bank) == set(ref) == {(1, 0, 0), (0, 1, 0), (0, 0, 1)}
    for key, embeds in ref.items():
        assert len(bank[key]) == len(embeds)
        for a, b in zip(bank[key], embeds):
            assert a.shape == (32,)
            close(a, b)


def test_hf_loader_matches_jax_loader(tmp_path):
    """A state dict under the HF key names, written by the test: both
    packages' loaders read it, and the encoders agree."""
    src = vit.ViTEncoder(SIZE, patch=16, image_size=32,
                         generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        for p in src.parameters():  # biases, LayerNorm and CLS off init
            p.add_(torch.randn(p.shape, generator=torch.Generator(
                ).manual_seed(p.numel())) * 0.05)
    sd = {f"vit.{k}": v for k, v in vit.hf_state_dict(src).items()}
    sd["vit.layernorm.weight"] = torch.ones(32)  # final LN: not the encoder's
    path = tmp_path / "pytorch_model.bin"
    torch.save(sd, path)
    jnet, v = jax_encoder()
    v = jvit.load_hf_vit_weights(str(path), v, model_size=SIZE)
    port = vit.load_hf_vit_weights(tmp_path, vit.ViTEncoder(SIZE, 16, 32))
    x = images(7, 2, 32, 32, 3)
    with torch.no_grad():
        close(port(torch.from_numpy(x)), src(torch.from_numpy(x)), 1e-6)
        close(port(torch.from_numpy(x)), jnet.apply(v, jnp.asarray(x)))
    del sd["vit.encoder.layer.1.output.dense.bias"]
    torch.save(sd, path)
    with pytest.raises(KeyError, match="layer.1.output.dense.bias"):
        vit.load_hf_vit_weights(path, vit.ViTEncoder(SIZE, 16, 32))


def test_jax_loader_is_strict():
    _, v = jax_encoder()
    params = dict(v["params"])
    params["extra"] = {"kernel": np.zeros(3, np.float32)}
    with pytest.raises(KeyError, match="extra"):
        port_encoder(params)
    params = dict(v["params"])
    del params["pos_embed"]
    with pytest.raises(KeyError, match="pos_embed"):
        port_encoder(params)


def test_frozen_copy_stores_the_compute_dtype():
    """``frozen_copy(bfloat16)`` stores the matmul and embedding parameters
    in bfloat16 and LayerNorm's in float32, leaves the float32 net as it
    was, and computes bit for bit what a float32-stored net computing in
    bfloat16 does."""
    _, v = jax_encoder()
    net = port_encoder(v["params"])
    ref = vit.ViTEncoder(SIZE, patch=16, image_size=32, dtype=torch.bfloat16)
    load_jax_vit(ref, v["params"])
    before = {k: t.clone() for k, t in net.state_dict().items()}
    frozen = net.frozen_copy(torch.bfloat16)
    x = torch.from_numpy(images(5, 2, 32, 32, 3))
    with torch.no_grad():
        got, want = frozen(x), ref(x)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    assert not any(p.requires_grad for p in frozen.parameters())
    for name, t in frozen.state_dict().items():
        assert t.dtype == (torch.float32 if ".ln" in name else torch.bfloat16), name
    assert all(torch.equal(t, before[k]) and t.dtype == torch.float32
               for k, t in net.state_dict().items())
