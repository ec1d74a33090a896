"""The reflect pad's ``torch.library`` custom ops on the CPU
(``ops/cuda/pad_kernels.py``): their CPU implementations (``F.pad``, the
repeated-reflection gathers where a pad reaches its axis, and numpy's
``reflect`` pad, bit for bit), their schema, fake and autograd
registrations (``torch.library.opcheck``), the autograd formula against
``F.pad``'s in float64, a double backward (``gradgradcheck``), the kernel
wrappers' checks, and a module that calls the op exported with
``torch.export``. The CUDA implementations run on the card only
(``tests/test_torch_pad_gpu.py``).
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensorMode

from de_i2i_gan_torch.nn.layers import pad_image
from de_i2i_gan_torch.ops.cuda import pad_kernels
from de_i2i_gan_torch.serving import load_exported, save_exported
from de_i2i_gan_torch.utils import profiling

torch.set_num_threads(1)

FWD = torch.ops.de_i2i_gan_torch.reflect_pad2d
BWD = torch.ops.de_i2i_gan_torch.reflect_pad2d_bwd
DTYPES = ["float32", "bfloat16"]
# (N, C, H, W), (top, bottom, left, right)
CASES = {
    "pad1": ((2, 3, 5, 6), (1, 1, 1, 1)),
    "pad3": ((1, 2, 7, 8), (3, 3, 3, 3)),
    "one_sided": ((2, 2, 4, 5), (0, 2, 3, 0)),
    "rows_only": ((1, 3, 4, 4), (2, 1, 0, 0)),
    "ge_axis": ((1, 2, 3, 4), (3, 3, 4, 5)),
    "axis_of_one": ((2, 1, 1, 3), (2, 1, 2, 2)),
    "axis_of_two": ((1, 2, 2, 2), (3, 0, 1, 4)),
}
# the cases F.pad takes (every pad shorter than its axis)
IN_RANGE = ("pad1", "pad3", "one_sided", "rows_only")


def _x(name, dtype="float32", seed=0):
    shape, pads = CASES[name]
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=gen).to(getattr(torch, dtype)), pads


def _numpy_pad(x, pads):
    pt, pb, pl, pr = pads
    return torch.from_numpy(np.pad(x.double().numpy(),
                                   ((0, 0), (0, 0), (pt, pb), (pl, pr)),
                                   mode="reflect")).to(x.dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", sorted(CASES))
def test_cpu_op_is_the_plain_version(name, dtype):
    """The forward op on a CPU tensor equals numpy's reflect pad, the
    repeated-reflection gathers, ``pad_image`` and, where it takes the pads,
    ``F.pad``, bit for bit; its output is contiguous."""
    x, pads = _x(name, dtype)
    pt, pb, pl, pr = pads
    y = FWD(x, list(pads))
    assert y.is_contiguous() and y.dtype == x.dtype
    assert torch.equal(y, _numpy_pad(x, pads))
    h, w = x.shape[2:]
    gathered = x.index_select(2, pad_kernels.reflect_index(h, pt, pb, "cpu"))
    gathered = gathered.index_select(3, pad_kernels.reflect_index(w, pl, pr, "cpu"))
    assert torch.equal(y, gathered)
    assert torch.equal(y, pad_image(x, ((pt, pb), (pl, pr)), "reflect"))
    if name in IN_RANGE:
        assert torch.equal(y, F.pad(x, (pl, pr, pt, pb), mode="reflect"))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", sorted(CASES))
def test_cpu_backward_op_is_the_adjoint(name, dtype):
    """The backward op sums, for each input element, the output elements
    padded from it, in float32, rounded once: within one ulp of the dtype
    of the float64 adjoint, plus float32's rounding of a sum of that many
    terms (an ulp of the sum of the terms' magnitudes a term)."""
    x, pads = _x(name, dtype, 1)
    dy = torch.randn(FWD(x, list(pads)).shape,
                     generator=torch.Generator().manual_seed(2)).to(x.dtype)
    h, w = x.shape[2:]
    dx = BWD(dy, list(pads), h, w)
    assert dx.shape == x.shape and dx.dtype == x.dtype
    x64 = x.double().requires_grad_()
    y64 = pad_kernels.reflect_pad_ref(x64, pads)
    (want,) = torch.autograd.grad(y64, x64, dy.double(), retain_graph=True)
    (size,) = torch.autograd.grad(y64, x64, dy.double().abs(), retain_graph=True)
    (terms,) = torch.autograd.grad(y64, x64, torch.ones_like(y64))
    band = torch.finfo(x.dtype).eps * want.abs() + terms * 2.0 ** -24 * size
    assert ((dx.double() - want).abs() <= band).all()
    assert torch.equal(dx, pad_kernels.reflect_pad_bwd_ref(dy, pads, h, w))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", ["pad1", "one_sided", "ge_axis"])
def test_opcheck(name, dtype):
    x, pads = _x(name, dtype, 3)
    torch.library.opcheck(FWD.default, (x, list(pads)))
    torch.library.opcheck(FWD.default, (x.requires_grad_(), list(pads)))
    dy = torch.randn(FWD(x, list(pads)).shape,
                     generator=torch.Generator().manual_seed(4)).to(x.dtype)
    torch.library.opcheck(BWD.default, (dy, list(pads), *x.shape[2:]))
    torch.library.opcheck(BWD.default, (dy.requires_grad_(), list(pads),
                                        *x.shape[2:]))


@pytest.mark.parametrize("name", sorted(CASES))
def test_fake_implementations(name):
    """Under FakeTensorMode each op gives the shape, dtype and (contiguous)
    strides its CPU implementation gives."""
    x, pads = _x(name, "bfloat16", 5)
    y = FWD(x, list(pads))
    dx = BWD(y, list(pads), *x.shape[2:])
    with FakeTensorMode() as mode:
        fx, fy = mode.from_tensor(x), mode.from_tensor(y)
        got_y = FWD(fx, list(pads))
        got_dx = BWD(fy, list(pads), *x.shape[2:])
    for got, want in ((got_y, y), (got_dx, dx)):
        assert got.shape == want.shape and got.dtype == want.dtype
        assert got.stride() == want.stride()


@pytest.mark.parametrize("name", sorted(CASES))
def test_autograd_against_fpad_float64(name):
    """The forward op's gradient, through the backward op, equals autograd
    of ``F.pad`` (of the gathers where F.pad refuses the pads) in float64."""
    x, pads = _x(name, "float32", 6)
    pt, pb, pl, pr = pads
    x = x.double()
    dy = torch.randn(FWD(x, list(pads)).shape,
                     generator=torch.Generator().manual_seed(7), dtype=torch.float64)
    xa, xb = x.clone().requires_grad_(), x.clone().requires_grad_()
    pad_kernels.reflect_pad(xa, pads).backward(dy)
    if name in IN_RANGE:
        ref = F.pad(xb, (pl, pr, pt, pb), mode="reflect")
    else:
        ref = pad_kernels.reflect_pad_ref(xb, pads)
    ref.backward(dy)
    torch.testing.assert_close(xa.grad, xb.grad, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("name", ["pad1", "pad3", "one_sided", "ge_axis"])
def test_double_backward(name):
    """gradcheck and gradgradcheck of the op in float64, alone and through
    a convolution: the backward op's own formula is the forward op."""
    x, pads = _x(name, "float32", 8)
    x = x.double().requires_grad_()
    weight = torch.randn((2, x.shape[1], 2, 2), dtype=torch.float64,
                         generator=torch.Generator().manual_seed(9),
                         requires_grad=True)

    def padded(t):
        return pad_kernels.reflect_pad(t, pads)

    def conv(t, wt):
        return F.conv2d(pad_kernels.reflect_pad(t, pads), wt).square()

    assert torch.autograd.gradcheck(padded, (x,))
    assert torch.autograd.gradgradcheck(padded, (x,))
    assert torch.autograd.gradgradcheck(conv, (x, weight))


def test_wrapper_checks_raise_before_any_launch(monkeypatch):
    """The kernel wrappers refuse what the kernels do not take, before the
    library is loaded or a kernel launched: not 4-D, empty planes, not
    contiguous, a dtype other than float32 and bfloat16, bad pads, a CPU
    tensor; the backward also a dy that is no pad of the input's size."""
    calls = []

    def stub(*args):
        calls.append(args)
        return 0

    monkeypatch.setattr(pad_kernels, "_kernel", lambda: (stub, stub))
    before = (pad_kernels.LAUNCHES, pad_kernels.BWD_LAUNCHES)
    x = torch.randn(2, 3, 4, 5)
    bad = [
        (ValueError, x[0], (1, 1, 1, 1)),
        (ValueError, torch.randn(2, 3, 0, 5), (1, 1, 1, 1)),
        (ValueError, x.transpose(2, 3), (1, 1, 1, 1)),
        (TypeError, x.double(), (1, 1, 1, 1)),
        (TypeError, x.half(), (1, 1, 1, 1)),
        (ValueError, x, (1, 1, -1, 1)),
        (ValueError, x, (1, 1, 1)),
        (ValueError, x, (1, 1, 1, 1)),  # a CPU tensor
    ]
    for err, t, pads in bad:
        with pytest.raises(err):
            pad_kernels.reflect_pad_fwd(t, pads)
        with pytest.raises(err):
            pad_kernels.reflect_pad_bwd(t, pads, 2, 3)
    with pytest.raises(ValueError, match="no pad"):
        pad_kernels.reflect_pad_bwd(x.bfloat16(), (1, 1, 1, 1), 3, 3)
    assert not calls
    assert (pad_kernels.LAUNCHES, pad_kernels.BWD_LAUNCHES) == before


def test_cpu_tensors_launch_nothing():
    """CPU tensors take the plain versions: nothing is built or launched."""
    before = (pad_kernels.LAUNCHES, pad_kernels.BWD_LAUNCHES)
    x, pads = _x("pad1", "float32", 10)
    x.requires_grad_()
    pad_kernels.reflect_pad(x, pads).sum().backward()
    pad_image(x, ((1, 1), (1, 1)), "reflect").sum().backward()
    assert (pad_kernels.LAUNCHES, pad_kernels.BWD_LAUNCHES) == before
    assert pad_kernels._fn is None


def test_launch_counts_are_a_counter_and_host_counts():
    """``pad.launches`` reads the two counts' sum, and a graph replay's
    ``add_host_counts`` moves them (restored after)."""
    read = profiling.REGISTRY.sources["pad.launches"]
    assert profiling.host_counts()["pad_kernels"] == {
        "fwd": pad_kernels.LAUNCHES, "bwd": pad_kernels.BWD_LAUNCHES}
    before = read()
    profiling.add_host_counts({"pad_kernels": {"fwd": 307, "bwd": 94}})
    try:
        assert read() - before == 401
    finally:
        profiling.add_host_counts({"pad_kernels": {"fwd": -307, "bwd": -94}})
    assert read() == before


class _Padded(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = torch.nn.Conv2d(3, 4, 3)

    def forward(self, x):
        return self.conv(pad_kernels.reflect_pad(x, (1, 1, 1, 1)))


def test_module_calling_the_op_exports(tmp_path):
    """The fake implementation lets torch.export trace through the op: the
    graph keeps its node through a save and a load, serves batches 1 and 3,
    and computes what eager computes."""
    net = _Padded().eval()
    gen = torch.Generator().manual_seed(11)
    batch = torch.export.Dim("batch", min=1)
    with torch.no_grad():
        program = torch.export.export(
            net, (torch.randn(2, 3, 8, 8, generator=gen),),
            dynamic_shapes=({0: batch},), strict=False)
    loaded = load_exported(save_exported(program, tmp_path / "padded.pt2"))
    for p in (program, loaded):
        assert sum(1 for n in p.graph.nodes if n.op == "call_function" and str(
            n.target).startswith("de_i2i_gan_torch.reflect_pad2d")) == 1
    for n in (1, 3):
        x = torch.randn(n, 3, 8, 8, generator=gen)
        with torch.no_grad():
            assert torch.equal(loaded.module()(x), net(x))


def test_chip_smoke_expects_the_pads_a_super_step_makes(monkeypatch):
    """``chip_smoke.expected_pads``, which the card's smoke holds every
    reflect-padding DefectGAN path to, counts what the op runs: a request
    and a super-step at a small width, AdaIN under remat and SEAN, counted
    through the op's CPU implementations; and the cell's table of pads
    (``chip_smoke.PAD_CALLS``) holds the 307 forward and 94 backward pads
    it gives at the cell's configuration."""
    import chip_smoke as cs
    from de_i2i_gan_torch.config import TrainConfig
    from de_i2i_gan_torch.nn import layers
    from de_i2i_gan_torch.train.steps import DefectGanSteps

    counts = {"fwd": 0, "bwd": 0}
    fwd, bwd = pad_kernels.reflect_pad_ref, pad_kernels.reflect_pad_bwd_ref

    def counted(kind, fn):
        def run(*args):
            counts[kind] += 1
            return fn(*args)
        return run

    monkeypatch.setattr(pad_kernels, "reflect_pad_ref", counted("fwd", fwd))
    monkeypatch.setattr(pad_kernels, "reflect_pad_bwd_ref", counted("bwd", bwd))
    monkeypatch.setattr(layers, "reflect_pad_ref", pad_kernels.reflect_pad)
    small = dict(image_size=64, ngf=4, ndf=4, hidden_nc=8,
                 compute_dtype="float32", use_pallas=False)
    for cfg in (cs.full_config(remat=True, **small),
                cs.sean_config(**small).replace(embed_nc=8)):
        steps = DefectGanSteps(cfg, TrainConfig(batch_size=1,
                                                num_critics=cs.CRITICS),
                               device="cpu")
        steps.init_training()
        gen = torch.Generator().manual_seed(0)
        shape = (cs.CRITICS, 1, 64, 64, 3)
        batch = {"bg": torch.rand(shape, generator=gen) * 2 - 1,
                 "df": torch.rand(shape, generator=gen) * 2 - 1,
                 "df_labels": torch.eye(cfg.label_nc)[:1].expand(
                     cs.CRITICS, 1, -1)}
        style = None
        if cfg.style_norm_block_type == "sean":
            style = torch.randn((1, cfg.num_embeds, cfg.embed_nc), generator=gen)
            for k in ("nm_embeds", "df_embeds"):
                batch[k] = style.expand(cs.CRITICS, -1, -1, -1)
        counts.update(fwd=0, bwd=0)
        steps._super_step(batch, torch.Generator().manual_seed(1))
        step = (counts["fwd"], counts["bwd"])
        counts.update(fwd=0, bwd=0)
        steps.generate(batch["bg"][0], batch["df_labels"][0], style,
                       generator=gen)
        request = (counts["fwd"], counts["bwd"])
        assert step == cs.expected_pads(cfg, super_steps=1), cfg
        assert request == cs.expected_pads(cfg, requests=1), cfg
    cell = cs.expected_pads(cs.full_config(), super_steps=1)
    assert cell == (307, 94)
    assert cell == (sum(n for *_, n in cs.PAD_CALLS),
                    sum(n for _, _, grad, n in cs.PAD_CALLS if grad))
