"""The norm kernels' ``torch.library`` custom ops on the CPU
(``ops/cuda/norm_kernels.py``): their schema, fake and autograd
registrations (``torch.library.opcheck``), their CPU implementations (the
plain versions of ``ops/fused.py``, bit for bit), and a module that calls
the forward op exported with ``torch.export``, its node kept through a
save and a load. The split forward's two ops (moments, apply; inference
only) the same way, and refusing a tensor that requires grad. The CUDA
implementations run on the card only (``tests/test_torch_kernel_gpu.py``).
"""
import pytest
import torch

from de_i2i_gan_torch.ops import fused
from de_i2i_gan_torch.ops.cuda import norm_kernels
from de_i2i_gan_torch.serving import kernel_nodes, load_exported, save_exported

torch.set_num_threads(1)

FWD = torch.ops.de_i2i_gan_torch.modulated_instance_norm_fwd
BWD = torch.ops.de_i2i_gan_torch.modulated_instance_norm_bwd
MOMENTS = torch.ops.de_i2i_gan_torch.modulated_instance_norm_moments
APPLY = torch.ops.de_i2i_gan_torch.modulated_instance_norm_apply
ACTS = [None, "relu", "leaky_relu"]
DTYPES = ["float32", "bfloat16"]


def _inputs(dtype, seed=0, shape=(2, 3, 5, 4)):
    gen = torch.Generator().manual_seed(seed)
    n, c = shape[:2]
    x = (torch.randn(shape, generator=gen) * 2 + 1).to(getattr(torch, dtype))
    g = torch.randn((n, c), generator=gen) * 0.5
    b = torch.randn((n, c), generator=gen) * 0.5
    return x, g, b


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("act", ACTS)
def test_opcheck_forward(dtype, act):
    x, g, b = _inputs(dtype)
    torch.library.opcheck(FWD.default, (x, g, b, act, 1e-5))
    torch.library.opcheck(FWD.default, (x.requires_grad_(), g.requires_grad_(),
                                        b.requires_grad_(), act, 1e-5))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("act", ACTS)
def test_opcheck_backward(dtype, act):
    x, g, b = _inputs(dtype, 1)
    _, mean, inv = fused.modulated_instance_norm_ref(x, g, b, act)
    dy = torch.randn(x.shape, generator=torch.Generator().manual_seed(2)
                     ).to(x.dtype)
    torch.library.opcheck(BWD.default, (x, g, b, mean, inv, dy, act))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("act", ACTS)
def test_cpu_ops_are_the_plain_versions(dtype, act):
    """Each op's CPU result equals the plain version bit for bit, and the
    forward's autograd runs the backward op on the forward's mean and inv."""
    x, g, b = _inputs(dtype, 3)
    got = FWD(x, g, b, act, 1e-5)
    want = fused.modulated_instance_norm_ref(x, g, b, act)
    for a, w in zip(got, want):
        assert a.dtype == w.dtype and a.is_contiguous()
        assert torch.equal(a, w)
    dy = torch.randn(x.shape, generator=torch.Generator().manual_seed(4)
                     ).to(x.dtype)
    dgot = BWD(x, g, b, want[1], want[2], dy, act)
    dwant = fused.modulated_instance_norm_bwd_ref(x, g, b, want[1], want[2],
                                                  dy, act)
    for a, w in zip(dgot, dwant):
        assert torch.equal(a, w)
    xg, gg, bg = (t.clone().requires_grad_() for t in (x, g, b))
    y = norm_kernels.cuda_modulated_instance_norm(xg, gg, bg, act)
    y.backward(dy)
    assert torch.equal(xg.grad, dwant[0])
    assert torch.equal(gg.grad, dwant[1]) and torch.equal(bg.grad, dwant[2])


def test_double_backward_raises():
    """Once differentiable, as the autograd.Function it replaces: the
    gradient graph ends in an error node."""
    x, g, b = _inputs("float32", 5)
    x.requires_grad_()
    y = norm_kernels.cuda_modulated_instance_norm(x, g, b, "leaky_relu")
    (dx,) = torch.autograd.grad(y.square().sum(), x, create_graph=True)
    with pytest.raises(RuntimeError, match="once_differentiable"):
        dx.square().sum().backward()


def test_cpu_tensor_launches_no_kernel():
    """On the CPU the ops run the plain version: no launch is counted, and
    nothing is built."""
    before = (norm_kernels.LAUNCHES, norm_kernels.BWD_LAUNCHES)
    x, g, b = _inputs("float32", 6)
    FWD(x, g, b, None, 1e-5)
    assert (norm_kernels.LAUNCHES, norm_kernels.BWD_LAUNCHES) == before
    assert norm_kernels._fn is None


class _Styled(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = torch.nn.Conv2d(3, 4, 3, padding=1)
        self.style = torch.nn.Linear(5, 8)

    def forward(self, x, s):
        gamma, beta = self.style(s).chunk(2, dim=1)
        h = FWD(self.conv(x), gamma, beta, "relu", 1e-5)[0]
        return FWD(h, beta, gamma, None, 1e-5)[0]


def test_module_calling_the_op_exports(tmp_path):
    """The fake implementation lets torch.export trace through the op: the
    graph keeps both nodes, serves batches 1 and 3, and a saved and loaded
    artifact computes what eager computes."""
    net = _Styled().eval()
    gen = torch.Generator().manual_seed(7)
    args = (torch.randn(2, 3, 8, 8, generator=gen),
            torch.randn(2, 5, generator=gen))
    batch = torch.export.Dim("batch", min=1)
    with torch.no_grad():
        program = torch.export.export(net, args, dynamic_shapes=(
            {0: batch}, {0: batch}), strict=False)
    assert kernel_nodes(program) == 2
    loaded = load_exported(save_exported(program, tmp_path / "styled.pt2"))
    assert kernel_nodes(loaded) == 2
    for n in (1, 3):
        x = torch.randn(n, 3, 8, 8, generator=gen)
        s = torch.randn(n, 5, generator=gen)
        with torch.no_grad():
            assert torch.equal(loaded.module()(x, s), net(x, s))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("act", ACTS)
def test_split_ops(dtype, act):
    """opcheck of the moments and apply ops; their CPU results are the
    plain versions bit for bit."""
    x, g, b = _inputs(dtype, 4)
    torch.library.opcheck(MOMENTS.default, (x,))
    sums = MOMENTS(x)
    assert torch.equal(sums, fused.modulated_instance_norm_moments_ref(x))
    mean, inv = fused.moments_to_stats(sums, x.shape[2] * x.shape[3])
    torch.library.opcheck(APPLY.default, (x, mean, inv, g, b, act))
    assert torch.equal(APPLY(x, mean, inv, g, b, act),
                       fused.modulated_instance_norm_apply_ref(
                           x, mean, inv, g, b, act))


def test_split_ops_are_inference_only():
    x, g, b = _inputs("float32", 5)
    mean, inv = fused.moments_to_stats(
        fused.modulated_instance_norm_moments_ref(x), 20)
    with pytest.raises(RuntimeError, match="inference only"):
        norm_kernels.split_moments(x.clone().requires_grad_())
    with pytest.raises(RuntimeError, match="inference only"):
        norm_kernels.split_apply(x, mean, inv, g.requires_grad_(), b)
    with torch.no_grad():
        assert norm_kernels.split_moments(x.requires_grad_()).shape == (2, 2, 3)
