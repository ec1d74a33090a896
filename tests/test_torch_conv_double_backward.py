"""The twice-differentiable convolution of ``nn/conv_grad.py`` against aten's
own autograd, in float64 at tiny shapes: the forward, the first derivatives
and an R1-style second derivative (d||dL/dx||^2 / dw and / dx); the terms a
None gradient or an unused output skips; the counter source
``conv.double_backward``; and ``Conv2d`` keeping ``F.conv2d`` for a CPU
tensor inside the penalty's scope. This file imports torch and the port
only."""
import pytest
import torch
import torch.nn.functional as F

from de_i2i_gan_torch.nn import conv_grad
from de_i2i_gan_torch.nn.layers import Conv2d
from de_i2i_gan_torch.utils import profiling

F64 = torch.float64


def _inputs(k, seed=0, size=10, cin=3, cout=4):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(2, cin, size, size, generator=g, dtype=F64)
    w = torch.randn(cout, cin, k, k, generator=g, dtype=F64)
    return x.requires_grad_(), w.requires_grad_()


def _r1(conv, x, w):
    """The output, (dL/dx, dL/dw) and d||dL/dx||^2 / (x, w) of L =
    sum(tanh(conv(x, w*1))): the weight enters through a node, as a
    compute-dtype cast makes it in a model."""
    y = conv(x, w * 1.0)
    loss = torch.tanh(y).sum()
    first = torch.autograd.grad(loss, (x, w), retain_graph=True)
    (gx,) = torch.autograd.grad(loss, x, create_graph=True)
    second = torch.autograd.grad(gx.square().sum(), (x, w))
    return y, first, second


@pytest.mark.parametrize("k,stride", [(1, 1), (1, 2), (3, 1), (3, 2),
                                      (4, 1), (4, 2)])
def test_pair_matches_aten(k, stride):
    x, w = _inputs(k)
    ya, fa, sa = _r1(lambda x, w: F.conv2d(x, w, stride=stride), x, w)
    yb, fb, sb = _r1(lambda x, w: conv_grad.conv2d(x, w, (stride, stride)),
                     x, w)
    torch.testing.assert_close(yb, ya, rtol=0, atol=0)
    for a, b in zip(fa + sa, fb + sb):
        torch.testing.assert_close(b, a, rtol=1e-12, atol=1e-12)


def test_none_gradients_add_no_terms(monkeypatch):
    """Each pass calls only the terms it uses. R1's first pass takes no
    wgrad (the weight is not among its inputs) and its second no dgrad by
    ggw (ggw is None); a pass that differentiates dL/dw alone takes no wgrad
    by ggx and no conv of ggx. The conv's input and weight enter through
    nodes, as the padding and the compute-dtype cast make them in a model.
    Each result still equals aten's."""
    masks, convs = [], []
    backward, conv2d = conv_grad._backward, F.conv2d

    def spy_backward(gy, x, w, stride, mask):
        masks.append(tuple(mask))
        return backward(gy, x, w, stride, mask)

    def spy_conv(*args, **kwargs):
        convs.append(args[0].shape)
        return conv2d(*args, **kwargs)

    x, w = _inputs(3, seed=1)
    aten = _r1(lambda x, w: F.conv2d(x, w), x, w)[2]
    monkeypatch.setattr(conv_grad, "_backward", spy_backward)
    monkeypatch.setattr(conv_grad.F, "conv2d", spy_conv)
    y = conv_grad.conv2d(x * 1.0, w * 1.0)
    (gx,) = torch.autograd.grad(torch.tanh(y).sum(), x, create_graph=True)
    assert masks == [(True, False)] and len(convs) == 1
    second = torch.autograd.grad(gx.square().sum(), (x, w))
    # g_gy = conv(ggx, w) and g_w by wgrad, no dgrad; then the first
    # backward of the forward's node, for both
    assert masks == [(True, False), (False, True), (True, True)]
    assert len(convs) == 2
    for a, b in zip(aten, second):
        torch.testing.assert_close(b, a, rtol=1e-12, atol=1e-12)

    masks.clear()
    convs.clear()
    wn = w * 1.0
    y = conv_grad.conv2d(x * 1.0, wn)
    (gw,) = torch.autograd.grad(torch.tanh(y).sum(), wn, create_graph=True)
    assert masks == [(False, True)]
    (gxx,) = torch.autograd.grad(gw.square().sum(), x)
    # ggx is None: g_gy = conv(x, ggw) and g_x by dgrad, no wgrad
    assert masks == [(False, True), (True, False), (True, False)]
    assert len(convs) == 2
    wa = w.detach().clone().requires_grad_()
    ya = F.conv2d(x, wa)
    (gwa,) = torch.autograd.grad(torch.tanh(ya).sum(), wa, create_graph=True)
    (ref,) = torch.autograd.grad(gwa.square().sum(), x)
    torch.testing.assert_close(gxx, ref, rtol=1e-12, atol=1e-12)


def test_counter_counts_second_backward_calls():
    read = profiling.REGISTRY.sources["conv.double_backward"]
    host = profiling.host_counts()["conv_grad"]
    before = read()
    x, w = _inputs(3, seed=2)
    w2 = torch.randn(5, 4, 3, 3, dtype=F64, requires_grad=True)

    def loss():
        return torch.tanh(conv_grad.conv2d(conv_grad.conv2d(x, w), w2)).sum()

    torch.autograd.grad(loss(), (x, w, w2))  # first order only
    (gx,) = torch.autograd.grad(loss(), x, create_graph=True)
    assert read() == before
    torch.autograd.grad(gx.square().sum(), w)
    assert read() == before + 2
    assert profiling.host_counts()["conv_grad"]["calls"] == host["calls"] + 2
    profiling.add_host_counts({"conv_grad": {"calls": 3}})
    assert read() == before + 5


def test_cpu_conv_in_scope_keeps_aten():
    conv = Conv2d(3, 4, (3, 3), padding=1, dtype=F64).double()
    x = torch.randn(2, 3, 8, 8, dtype=F64, requires_grad=True)
    out = conv(x)
    with conv_grad.differentiated_twice():
        assert conv_grad.in_scope()
        inside = conv(x)
    assert not conv_grad.in_scope()
    assert type(inside.grad_fn).__name__ == "ConvolutionBackward0"
    torch.testing.assert_close(inside, out, rtol=0, atol=0)
