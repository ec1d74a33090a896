"""``remat`` (``train/remat.py``) on against off, on the CPU: DefectGAN's
super-step with each decoder and pix2pix's ``train_step`` and
``fused_train_step``, all with noise injection and spectral norm (and for
SEAN its running statistics and distillation terms), from one state with
one seeded noise generator.

The rerun in the backward pass must see the modes, buffers and noise of the
first forward and leave the state moved once. So, remat on against off:
  * the loss terms, equal within rtol 1e-6;
  * every parameter after an SGD step (the gradient times lr, plus the
    start): atol 1e-6, float32 rounding of a recomputation (on the CPU the
    two come out bit for bit);
  * every buffer (BatchNorm's running statistics, spectral u/v, SEAN's
    statistics) and the noise generator's state: equal, moved once;
  * a forward that is rerun draws no new noise: the generator ends where
    remat off leaves it.
The JAX package's remat is ``jax.checkpoint`` of a pure function: the same
numbers by construction, so the comparison is within the port.
"""
import pytest
import torch
import torch.nn.functional as F

from de_i2i_gan_torch.config import DefectGanConfig, TrainConfig
from de_i2i_gan_torch.train.jax_import import init_weights
from de_i2i_gan_torch.train.pix2pix_steps import Pix2PixSteps
from de_i2i_gan_torch.train.remat import remat
from de_i2i_gan_torch.train.steps import DefectGanSteps

torch.set_num_threads(1)

ATOL = 1e-6
LOSS_RTOL = 1e-6
CFG = dict(image_size=32, label_nc=3, ngf=8, ndf=8, num_scales=2, num_res=2,
           hidden_nc=16, num_layers=2, embed_nc=12, num_embeds=2,
           add_noise=True, use_spectral=True)
SGD = dict(batch_size=2, num_critics=2, lr=(2e-2, 1e-2), optimizer="sgd")


def defectgan(style, remat_on):
    sean = style == "sean"
    cfg = DefectGanConfig(**CFG, style_norm_block_type=style,
                          use_running_stats=sean, style_distill=sean,
                          remat=remat_on)
    steps = DefectGanSteps(cfg, TrainConfig(**SGD), device="cpu")
    steps.init_training()
    init_weights(steps, 0)
    gen = torch.Generator().manual_seed(1)
    batches = {"bg": torch.rand((2, 2, 32, 32, 3), generator=gen) * 2 - 1,
               "df": torch.rand((2, 2, 32, 32, 3), generator=gen) * 2 - 1,
               "df_labels": F.one_hot(torch.randint(0, 3, (2, 2), generator=gen),
                                      3).float()}
    if sean:
        batches["nm_embeds"] = torch.randn((2, 2, 2, 12), generator=gen)
        batches["df_embeds"] = torch.randn((2, 2, 2, 12), generator=gen)
    noise = torch.Generator().manual_seed(2)
    metrics = steps.super_step(batches, noise)
    return steps, metrics, noise.get_state()


def pix2pix(fused, remat_on):
    cfg = DefectGanConfig(**{**CFG, "label_nc": 2}, cycle_gan=True,
                          style_norm_block_type="spade", remat=remat_on)
    tcfg = TrainConfig(**{**SGD, "num_critics": 1}, ema_decay=0.999)
    steps = Pix2PixSteps(cfg, tcfg, n_layers_d=2, fused_prop=fused,
                         device="cpu")
    init_weights(steps, 0)
    gen = torch.Generator().manual_seed(1)
    batch = {k: torch.rand((2, 32, 32, 3), generator=gen) * 2 - 1
             for k in ("input", "target")}
    noise = torch.Generator().manual_seed(2)
    metrics = steps.train_step(batch, noise)
    return steps, metrics, noise.get_state()


def assert_same(on, off, nets):
    (s1, m1, g1), (s0, m0, g0) = on, off
    assert sorted(m1) == sorted(m0)
    for k in m0:
        torch.testing.assert_close(m1[k], m0[k], rtol=LOSS_RTOL, atol=0,
                                   msg=k)
    assert torch.equal(g1, g0), "the noise generator moved differently"
    for net in nets:
        p1 = dict(getattr(s1, net).named_parameters())
        for k, p in getattr(s0, net).named_parameters():
            torch.testing.assert_close(p1[k], p, rtol=0, atol=ATOL,
                                       msg=f"{net} {k}")
        b1 = dict(getattr(s1, net).named_buffers())
        for k, b in getattr(s0, net).named_buffers():
            assert torch.equal(b1[k], b), f"{net} buffer {k}"


@pytest.mark.parametrize("style", ["spade", "adain", "sean"])
def test_defectgan_super_step_remat_matches(style):
    on, off = defectgan(style, True), defectgan(style, False)
    nets = ["G", "D"] + (["E"] if style == "adain" else [])
    assert_same(on, off, nets)
    # the state moved: BatchNorm's statistics and G's u/v left their init
    g = dict(off[0].G.named_buffers())
    assert not torch.equal(g["stem.norm.running_var"],
                           torch.ones_like(g["stem.norm.running_var"]))
    if style == "sean":
        counts = [b for k, b in g.items() if k.endswith(".count")]
        assert counts and all(c.sum() > 0 for c in counts)


@pytest.mark.parametrize("fused", [False, True], ids=["train_step", "fused"])
def test_pix2pix_remat_matches(fused):
    assert_same(pix2pix(fused, True), pix2pix(fused, False),
                ["G", "D", "ema_G"])


def test_rerun_restores_mode_buffers_and_noise():
    """A module switched to eval before the backward pass is rerun in train
    mode; its buffers and the generator end as the first forward left
    them."""
    torch.manual_seed(0)
    bn = torch.nn.Sequential(torch.nn.Conv2d(2, 3, 3),
                             torch.nn.BatchNorm2d(3))

    class Noisy(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.net = bn

        def forward(self, x, generator=None):
            y = self.net(x)
            return y + torch.randn(y.shape, generator=generator)

    m = Noisy().train()
    x = torch.randn(4, 2, 6, 6, requires_grad=True)
    gen = torch.Generator().manual_seed(3)
    y = remat(m, x, generator=gen)
    after_fwd = ([b.clone() for b in m.buffers()], gen.get_state())
    m.eval()
    y.square().sum().backward()
    assert not m.training and not bn[1].training
    assert all(torch.equal(a, b) for a, b in zip(after_fwd[0], m.buffers()))
    assert torch.equal(after_fwd[1], gen.get_state())
    # the same gradient as without remat
    m.train()
    bn[1].reset_running_stats()
    grad = x.grad.clone()
    x.grad = None
    gen.manual_seed(3)
    m(x, generator=gen).square().sum().backward()
    torch.testing.assert_close(x.grad, grad, rtol=0, atol=ATOL)
