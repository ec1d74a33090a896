"""``--init_type`` in the port (``train/jax_import.py::reinit_module``, the
counterpart of the JAX package's ``nn/layers.py::reinit_params``, the
reference's ``BaseNetwork.init_weights``), as ``tests/test_init.py`` checks
the JAX one: the distribution, not the numbers (the two packages draw from
different generators).

  * conv and dense kernels: normal(0, gain), xavier (gain *
    sqrt(2 / (fan_in + fan_out))), kaiming (sqrt(2 / fan_in)), with the
    fans of the flax layout (fan_in = kh*kw*in); the sample std within 10%
    of the formula (a kernel of 10^3 or more elements: its sampling error
    is under 3%); orthogonal: the (fan_in, fan_out) matrix of the flax
    layout has orthonormal columns times gain, within 1e-4;
  * norm scales (BatchNorm's weight) from N(1, gain): mean within 0.05 of 1;
    biases 0; running statistics, spectral u/v and noise weights as the
    default init left them;
  * ``init_weights`` redraws DefectGAN's G and D (not E, as the JAX
    ``DefectGanSteps.init_state``), the EMA generator a copy of G, and
    the same seed the same weights.
"""
import numpy as np
import pytest
import torch

from de_i2i_gan_torch.config import DefectGanConfig, TrainConfig
from de_i2i_gan_torch.nn.blocks import BatchNorm, ConvBlock
from de_i2i_gan_torch.nn.layers import Conv2d, Dense
from de_i2i_gan_torch.train.jax_import import init_weights, reinit_module
from de_i2i_gan_torch.train.steps import DefectGanSteps

torch.set_num_threads(1)

STD_RTOL = 0.10


class Net(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = ConvBlock(8, 16, (3, 3), norm="batch", use_spectral=True)
        self.fc = Dense(64, 32, use_spectral=False)
        self.out = Conv2d(16, 24, (5, 5), use_bias=True)


def _net(kind, gain, seed=0):
    net = Net()
    with torch.no_grad():
        for p in net.parameters():
            p.fill_(7.0)
        net.conv.norm.running_mean.fill_(3.0)
    reinit_module(net, torch.Generator().manual_seed(seed), kind, gain)
    return net


FANS = {"conv.conv.weight": (72, 16), "fc.weight": (64, 32),
        "out.weight": (400, 24)}


@pytest.mark.parametrize("kind,gain", [("normal", 0.02), ("normal", 0.05),
                                       ("xavier", 0.5), ("kaiming", 0.02)])
def test_kernel_std(kind, gain):
    net = _net(kind, gain)
    params = dict(net.named_parameters())
    for key, (fan_in, fan_out) in FANS.items():
        want = {"normal": gain,
                "xavier": gain * np.sqrt(2.0 / (fan_in + fan_out)),
                "kaiming": np.sqrt(2.0 / fan_in)}[kind]
        got = params[key].detach().std().item()
        assert abs(got - want) <= STD_RTOL * want, (key, got, want)
        assert abs(params[key].detach().mean().item()) < 4 * want / np.sqrt(
            params[key].numel())


def test_orthogonal_columns_in_the_flax_layout():
    net = _net("orthogonal", 1.0)
    conv = net.out.weight.detach()  # (out, in, kh, kw) -> HWIO
    m = conv.permute(2, 3, 1, 0).reshape(400, 24)
    np.testing.assert_allclose((m.T @ m).numpy(), np.eye(24), atol=1e-4)
    fc = net.fc.weight.detach().T  # (in, out)
    np.testing.assert_allclose((fc.T @ fc).numpy(), np.eye(32), atol=1e-4)
    # more columns than rows: orthonormal rows, times the gain
    wide = _net("orthogonal", 0.5).conv.conv.weight.detach()
    m = wide.permute(2, 3, 1, 0).reshape(72, 16)
    np.testing.assert_allclose((m.T @ m).numpy(), 0.25 * np.eye(16), atol=1e-4)


def test_scales_biases_and_the_rest():
    net = _net("xavier", 0.02)
    assert abs(net.conv.norm.weight.mean().item() - 1.0) < 0.05
    assert net.conv.norm.weight.std().item() < 0.05
    assert torch.equal(net.conv.norm.bias, torch.zeros(16))
    assert torch.equal(net.fc.bias, torch.zeros(32))
    assert torch.equal(net.out.bias, torch.zeros(24))
    # not parameters of a kernel, a norm scale or a bias: left alone
    assert torch.equal(net.conv.norm.running_mean, torch.full((16,), 3.0))
    assert net.conv.conv.weight_u.abs().sum() > 0


def test_same_seed_same_weights_and_unknown_type():
    a, b = _net("kaiming", 0.02, 3), _net("kaiming", 0.02, 3)
    for (k, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), k
    with pytest.raises(ValueError):
        _net("bogus", 0.02)


def test_init_weights_redraws_g_and_d_not_e():
    kw = dict(image_size=32, label_nc=4, ngf=8, ndf=8, num_res=2,
              hidden_nc=16, num_layers=2, style_norm_block_type="adain")
    steps = {}
    for init in ("normal", "kaiming"):
        s = DefectGanSteps(DefectGanConfig(**kw, init_type=init),
                           TrainConfig(ema_decay=0.9), device="cpu")
        s.init_training()
        init_weights(s, 0)
        steps[init] = s
    base, re = steps["normal"], steps["kaiming"]
    for (k, p), q in zip(base.E.named_parameters(), re.E.parameters()):
        assert torch.equal(p, q), k  # E keeps the default init
    w = re.G.enc_0.conv.weight
    assert abs(w.std().item() - np.sqrt(2.0 / w[0].numel())) < 0.1 * np.sqrt(
        2.0 / w[0].numel())
    assert abs(re.D.stem.conv.weight.std().item() - 0.02) > 0.02
    bn = [m for m in re.G.modules() if isinstance(m, BatchNorm)]
    assert bn and all(not torch.equal(m.weight, torch.ones_like(m.weight))
                      for m in bn)
    for (k, p), q in zip(re.G.state_dict().items(),
                         re.ema_G.state_dict().values()):
        assert torch.equal(p, q), k
