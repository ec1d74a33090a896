"""The pieces of the port's training slice against their JAX counterparts:
train-mode BatchNorm with ``bn_groups`` (outputs, gradients, running
statistics), the blocks and the generator that thread it, the
discriminator, the losses, ``normal_labels``, the optimizers and their
schedules, and the EMA update.

Weights and inputs come from seeded numpy draws; the port works in NCHW and
the transposes are done here. Tolerances: 1e-4 for single layers and 5e-4
for blocks and networks (DESIGN.md §7), float32 throughout; optimizer
updates 1e-6 (the same float32 arithmetic in another order).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from flax import linen as fnn

from de_i2i_gan_tpu.config import DefectGanConfig as JaxConfig
from de_i2i_gan_tpu.config import TrainConfig as JaxTrainConfig
from de_i2i_gan_tpu.losses import common as jlosses
from de_i2i_gan_tpu.models.discriminator import (
    DefectGanDiscriminator as JaxDiscriminator)
from de_i2i_gan_tpu.models.generator import DefectGanGenerator as JaxGenerator
from de_i2i_gan_tpu.nn import blocks as jblocks
from de_i2i_gan_tpu.train import optim as joptim
from de_i2i_gan_tpu.utils.labels import normal_labels as jnormal_labels
from de_i2i_gan_torch.config import DefectGanConfig, TrainConfig
from de_i2i_gan_torch.losses import common as losses
from de_i2i_gan_torch.models.discriminator import DefectGanDiscriminator
from de_i2i_gan_torch.models.generator import DefectGanGenerator
from de_i2i_gan_torch.nn import blocks
from de_i2i_gan_torch.train import optim
from de_i2i_gan_torch.train.jax_import import load_jax_module
from de_i2i_gan_torch.utils.labels import normal_labels

torch.set_num_threads(1)

LAYER_TOL = 1e-4
BLOCK_TOL = 5e-4
OPT_TOL = 1e-6
KEY = jax.random.PRNGKey(0)
TINY = dict(image_size=32, label_nc=4, ngf=8, ndf=8, num_res=2, hidden_nc=16,
            num_layers=2, style_norm_block_type="adain", use_pallas=True)


def nhwc(seed, shape, scale=1.0, shift=0.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, shape) * scale + shift).astype(np.float32)


def to_port(x):
    """NHWC numpy -> NCHW torch."""
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def close(port, ref, tol):
    got = port.detach().float().numpy()
    if got.ndim == 4:
        got = got.transpose(0, 2, 3, 1)
    np.testing.assert_allclose(got, np.asarray(ref, np.float32), atol=tol,
                               rtol=tol)


def perturb(tree, seed):
    """Every leaf moved by a seeded draw (kernels, biases, BN scale/stats)."""
    rng = np.random.default_rng(seed)

    def walk(t):
        out = {}
        for k, v in t.items():
            if isinstance(v, dict):
                out[k] = walk(v)
                continue
            v = np.asarray(v, np.float32)
            if k == "var":
                out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            else:
                out[k] = v + rng.normal(0, 0.1, v.shape).astype(np.float32)
        return out
    return walk(jax.device_get(tree))


def init_pair(jmod, port, *args, seed=0, **kw):
    """init the flax module, perturb, load into ``port``; returns the flax
    variables."""
    variables = jmod.init({"params": KEY, "noise": KEY}, *args, **kw)
    params = perturb(variables["params"], seed)
    stats = perturb(variables.get("batch_stats", {}), seed + 1)
    load_jax_module(port, params, {"batch_stats": stats})
    full = {"params": params}
    if stats:
        full["batch_stats"] = stats
    return full


def close_stats(port, stats, tol=1e-5):
    """The port's BatchNorm running statistics against a flax batch_stats
    tree."""
    for name, mod in port.named_modules():
        if isinstance(mod, blocks.BatchNorm):
            node = stats
            for part in name.split(".") if name else []:
                node = node[part]
            np.testing.assert_allclose(mod.running_mean.numpy(), node["mean"],
                                       atol=tol, rtol=tol, err_msg=name)
            np.testing.assert_allclose(mod.running_var.numpy(), node["var"],
                                       atol=tol, rtol=tol, err_msg=name)


class _JaxBatchNorm(fnn.Module):
    """The JAX package's train-mode BatchNorm dispatch on its own."""

    bn_groups: int

    @fnn.compact
    def __call__(self, y):
        norm = jblocks._norm_layer("batch", jnp.float32, "norm")
        return jblocks._apply_norm(norm, y, train=True,
                                   bn_groups=self.bn_groups)


class _PortBatchNorm(torch.nn.Module):
    def __init__(self, features):
        super().__init__()
        self.norm = blocks.BatchNorm(features)

    def forward(self, y, bn_groups):
        return self.norm(y, bn_groups)


# ----------------------------------------------------------- BatchNorm


@pytest.mark.parametrize("bn_groups", [1, 2])
def test_batchnorm_train_matches_flax(bn_groups):
    """Outputs, running statistics (biased variance, group after group) and
    the gradients of x, scale and bias."""
    x = nhwc(1, (4, 5, 6, 8), 2.0, 0.5)
    dy = nhwc(2, (4, 5, 6, 8))
    jmod = _JaxBatchNorm(bn_groups)
    port = _PortBatchNorm(8).train()
    variables = init_pair(jmod, port, jnp.asarray(x))

    def fwd(params, x):
        return jmod.apply({"params": params,
                           "batch_stats": variables["batch_stats"]}, x,
                          mutable=["batch_stats"])

    ref, mut = fwd(variables["params"], jnp.asarray(x))
    _, vjp = jax.vjp(lambda p, x: fwd(p, x)[0], variables["params"],
                     jnp.asarray(x))
    dparams, dx_ref = vjp(jnp.asarray(dy))

    xt = to_port(x).requires_grad_()
    y = port(xt, bn_groups)
    y.backward(to_port(dy))
    close(y, ref, LAYER_TOL)
    close_stats(port, jax.device_get(mut["batch_stats"]))
    close(xt.grad, dx_ref, LAYER_TOL)
    np.testing.assert_allclose(port.norm.weight.grad.numpy(),
                               dparams["norm"]["scale"], atol=LAYER_TOL,
                               rtol=LAYER_TOL)
    np.testing.assert_allclose(port.norm.bias.grad.numpy(),
                               dparams["norm"]["bias"], atol=LAYER_TOL,
                               rtol=LAYER_TOL)


def test_batchnorm_eval_mode_ignores_groups_and_keeps_stats():
    bn = blocks.BatchNorm(4).eval()
    x = to_port(nhwc(3, (3, 2, 2, 4)))
    before = bn.running_mean.clone(), bn.running_var.clone()
    y = bn(x, bn_groups=2)  # eval mode: running statistics, no grouping
    assert torch.equal(y, bn(x))
    assert torch.equal(bn.running_mean, before[0])
    assert torch.equal(bn.running_var, before[1])


@pytest.mark.parametrize("bn_groups", [1, 2])
def test_conv_block_train_matches_flax(bn_groups):
    x = nhwc(4, (4, 10, 10, 3), 2.0, 0.5)
    kw = dict(kernel_size=(3, 3), padding="same", padding_mode="reflect",
              norm="batch", act="leaky_relu")
    port = blocks.ConvBlock(3, 6, **kw).train()
    jmod = jblocks.ConvBlock(6, bn_groups=bn_groups, **kw)
    variables = init_pair(jmod, port, jnp.asarray(x), train=True)
    ref, mut = jmod.apply(variables, jnp.asarray(x), train=True,
                          mutable=["batch_stats"])
    with torch.no_grad():
        close(port(to_port(x), bn_groups), ref, BLOCK_TOL)
    close_stats(port, jax.device_get(mut["batch_stats"]))


def test_resblock_train_bn_groups_matches_flax():
    x = nhwc(5, (4, 8, 8, 4))
    kw = dict(kernel_size=(3, 3), padding="same", padding_mode="reflect",
              norm="batch", act="leaky_relu")
    port = blocks.ResBlock(4, 4, **kw).train()
    jmod = jblocks.ResBlock(4, bn_groups=2, **kw)
    variables = init_pair(jmod, port, jnp.asarray(x), train=True)
    ref, mut = jmod.apply(variables, jnp.asarray(x), train=True,
                          mutable=["batch_stats"])
    with torch.no_grad():
        close(port(to_port(x), 2), ref, BLOCK_TOL)
    close_stats(port, jax.device_get(mut["batch_stats"]))


@pytest.mark.parametrize("bn_groups", [1, 2])
def test_generator_train_mode_matches_flax(bn_groups):
    """The fused 2B forward of the G step: outputs and the BatchNorm
    running statistics it leaves."""
    rng = np.random.default_rng(6)
    x = rng.uniform(-1, 1, (4, 32, 32, 3)).astype(np.float32)
    labels = np.eye(4, dtype=np.float32)[rng.integers(0, 4, 4)]
    style = rng.normal(0, 1, (4, 16)).astype(np.float32)
    jnet = JaxGenerator(JaxConfig(**TINY))
    net = DefectGanGenerator(DefectGanConfig(**TINY)).train()
    args = (jnp.asarray(x), jnp.asarray(labels), jnp.asarray(style))
    variables = init_pair(jnet, net, *args)
    (jout, jprob), mut = jnet.apply(variables, *args, train=True,
                                    bn_groups=bn_groups,
                                    mutable=["batch_stats"])
    with torch.no_grad():
        out, prob = net(torch.from_numpy(x), torch.from_numpy(labels),
                        torch.from_numpy(style), bn_groups=bn_groups)
    for got, ref in ((out, jout), (prob, jprob)):  # both NHWC
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   atol=BLOCK_TOL, rtol=BLOCK_TOL)
    close_stats(net, jax.device_get(mut["batch_stats"]), 1e-4)


# ------------------------------------------------------- discriminator


def test_discriminator_matches_flax():
    x = np.random.default_rng(7).uniform(-1, 1, (3, 32, 32, 3)).astype(np.float32)
    jnet = JaxDiscriminator(JaxConfig(**TINY))
    net = DefectGanDiscriminator(DefectGanConfig(**TINY))
    variables = init_pair(jnet, net, jnp.asarray(x))
    jsrc, jcls = jnet.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        src, cls = net(torch.from_numpy(x))
    assert src.shape == (3, 4, 4, 1) and cls.shape == (3, 4)
    np.testing.assert_allclose(src.numpy(), np.asarray(jsrc), atol=BLOCK_TOL,
                               rtol=BLOCK_TOL)
    np.testing.assert_allclose(cls.numpy(), np.asarray(jcls), atol=BLOCK_TOL,
                               rtol=BLOCK_TOL)


def test_discriminator_rejects_image_too_small_for_depth():
    with pytest.raises(ValueError, match="too small"):
        DefectGanDiscriminator(DefectGanConfig(**dict(TINY, num_layers=5)))


# -------------------------------------------------------------- losses


def _loss_inputs(name):
    rng = np.random.default_rng(8)
    logits = rng.normal(0, 2, (6, 5)).astype(np.float32)
    if name == "cce_ids":
        return logits, rng.integers(0, 5, 6)
    if name in ("bce", "bce_logits"):
        return logits, rng.integers(0, 2, (6, 5)).astype(np.float32)
    if name in ("cce", "cce_logits"):
        return logits, rng.dirichlet(np.ones(5), 6).astype(np.float32)
    return logits, rng.normal(0, 1, (6, 5)).astype(np.float32)


@pytest.mark.parametrize("name", ["bce", "bce_logits", "cce", "cce_logits",
                                  "cce_ids", "l1", "l2", "mse"])
def test_losses_match_jax(name):
    logits, targets = _loss_inputs(name)
    loss_type = "cce" if name == "cce_ids" else name
    ref = jlosses.cal_loss(jnp.asarray(logits), jnp.asarray(targets),
                           loss_type)
    got = losses.cal_loss(torch.from_numpy(logits), torch.from_numpy(targets),
                          loss_type)
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-6, atol=1e-6)


def test_cal_loss_rejects_unknown_type():
    with pytest.raises(ValueError, match="hinge"):
        losses.cal_loss(torch.zeros(2, 3), torch.zeros(2, 3), "hinge")


def test_normal_labels_matches_jax():
    like = np.eye(5, dtype=np.float32)[[3, 1, 4]]
    ref = jnormal_labels(jnp.asarray(like))
    got = normal_labels(torch.from_numpy(like))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert like[0, 3] == 1.0  # the input is left as it was


# ---------------------------------------------------- optimizers, EMA


@pytest.mark.parametrize("update_every", [1, 3])
@pytest.mark.parametrize("optimizer", ["sgd", "rmsprop", "adam", "adamw"])
def test_optimizer_matches_optax(optimizer, update_every):
    """Five updates with a step schedule that decays every second epoch,
    so the learning rate changes between updates."""
    tcfg = TrainConfig(optimizer=optimizer)
    jtcfg = JaxTrainConfig(optimizer=optimizer)
    rng = np.random.default_rng(9)
    params = {"w": rng.normal(0, 0.1, (4, 3)).astype(np.float32),
              "b": rng.normal(0, 0.1, (3,)).astype(np.float32)}
    sched = dict(iters_per_epoch=2, num_epochs=8, update_every=update_every)
    tx = joptim.make_optimizer(jtcfg, 1e-2, **sched)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state = tx.init(jparams)
    tparams = [torch.tensor(params["w"]), torch.tensor(params["b"])]
    opt = optim.make_optimizer(tcfg, tparams, 1e-2, **sched)
    for _ in range(5):
        grads = {k: rng.normal(0, 1e-2, v.shape).astype(np.float32)
                 for k, v in params.items()}
        updates, opt_state = tx.update({k: jnp.asarray(v) for k, v in grads.items()},
                                       opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        opt.step([torch.tensor(grads["w"]), torch.tensor(grads["b"])])
        for t, k in zip(tparams, ("w", "b")):
            np.testing.assert_allclose(t.numpy(), np.asarray(jparams[k]),
                                       atol=OPT_TOL, rtol=OPT_TOL)
    assert opt.count == 5
    assert all(p.grad is None for p in tparams)


@pytest.mark.parametrize("scheduler", ["step", "exp", "cos", "const"])
def test_lr_schedule_matches_jax(scheduler):
    tcfg = TrainConfig(scheduler=scheduler)
    jtcfg = JaxTrainConfig(scheduler=scheduler)
    for update_every in (1, 5):
        ref = joptim.lr_schedule(jtcfg, 2e-4, 3, 10, update_every)
        got = optim.lr_schedule(tcfg, 2e-4, 3, 10, update_every)
        for count in range(0, 40, 3):
            np.testing.assert_allclose(got(count), float(ref(count)),
                                       rtol=1e-6, err_msg=str(count))


def test_unknown_optimizer_and_scheduler_raise():
    with pytest.raises(NameError, match="lamb"):
        optim.make_optimizer(TrainConfig(optimizer="lamb"), [torch.zeros(1)],
                             1e-3, 10, 10)
    with pytest.raises(NameError, match="poly"):
        optim.lr_schedule(TrainConfig(scheduler="poly"), 1e-3, 10, 10)


def test_ema_update_matches_optax():
    rng = np.random.default_rng(10)
    ema = [rng.normal(0, 1, (3, 2)).astype(np.float32) for _ in range(2)]
    new = [rng.normal(0, 1, (3, 2)).astype(np.float32) for _ in range(2)]
    ref = joptim.ema_update([jnp.asarray(a) for a in ema],
                            [jnp.asarray(a) for a in new], 0.999)
    got = [torch.tensor(a) for a in ema]
    optim.ema_update(got, [torch.tensor(a) for a in new], 0.999)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-7,
                                   rtol=1e-6)
