"""The port's CUDA kernels, and ``device_prefetch``'s copies, on the card
(``gpu`` marker; skips without one).

This file imports torch and the port only, so it also runs where flax (and
with it the JAX package's models) cannot be imported. On the card:

    python -m pytest tests/test_torch_kernel_gpu.py -m gpu --noconftest -q

The kernels are held against their plain versions (which the CPU tests hold
against the JAX package). Tolerances: forward float32 within 2e-5 (the JAX
kernel suite's); bfloat16 y within atol 3e-2 + rtol 1.6e-2 (one bf16 ulp at
|y| < 16); mean and inv are f32. Backward float32 dx within 3e-4 (the JAX
suite's backward tolerance), bfloat16 dx within one bf16 ulp of the plain
version's (plus 1e-5 for the float32 math before rounding); dgamma and
dbeta, float32 sums over H*W in another order, within 1e-5 of the sum of
the absolute terms. Each tier of the planner (W: a warp a row; B: a block a
row; C: a cluster of 1, 2, 4 or 8 blocks a row; S: streaming) is held to the same tolerances
at its boundary shapes, and the backward's dgamma and dbeta to bit-identity
between two runs. End to end in f32, 5e-4 (DESIGN.md §7); an exported
generator's artifact against its eager forward, 2e-5; the custom ops pass
``torch.library.opcheck`` on the card. A super-step's
losses within rtol 2e-4, its gradients, as (after - before) / lr under SGD,
within 1e-3 of each tensor's L2 norm plus 1e-5 per element in L2 (a ReLU
gate whose input lies within rounding of 0 can fall either way on two
devices and move single upstream elements past an element-wise bound).
The split forward (moments, apply) against its plain versions: the (2, N,
C) sums within 1e-5 of the sum of the absolute terms (f32 sums in another
order), y within the forward's tolerances on the same mean and inv; one
band through the split ops equals tier S of the fused kernel: the moments
are its pass-1 sums bit for bit (the same loop), so mean is equal, inv
within 2 f32 ulps (the fused kernel takes rsqrtf and may fuse var's
multiply-subtract), y within that.
"""
import pytest
import torch

from de_i2i_gan_torch.config import DefectGanConfig, TrainConfig
from de_i2i_gan_torch.ops import fused
from de_i2i_gan_torch.ops.cuda import norm_kernels
from de_i2i_gan_torch.train.jax_import import init_weights
from de_i2i_gan_torch.train.steps import DefectGanSteps

TOL = 2e-5
BF16_ATOL, BF16_RTOL = 3e-2, 1.6e-2
BWD_TOL = 3e-4
BWD_BF16_ATOL = 1e-5
SUM_BAND = 1e-5
GRAD_REL_L2, GRAD_ATOL = 1e-3, 1e-5
ACTS = [None, "relu", "leaky_relu"]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_plain_on_card(dtype):
    """A decoder shape (vector path) and a ragged shape (scalar path)."""
    _need_card()
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for shape in [(8, 256, 64, 64), (3, 5, 7, 9)]:
        n, c = shape[:2]
        x = (torch.randn(shape, generator=gen, device="cuda") * 2 + 1).to(dt)
        g = torch.randn((n, c), generator=gen, device="cuda") * 0.5
        b = torch.randn((n, c), generator=gen, device="cuda") * 0.5
        for act in ACTS:
            before = norm_kernels.LAUNCHES
            y, mean, inv = norm_kernels.modulated_instance_norm_fwd(x, g, b, act)
            torch.cuda.synchronize()
            assert norm_kernels.LAUNCHES == before + 1
            ry, rmean, rinv = fused.modulated_instance_norm_ref(x, g, b, act)
            assert y.dtype == dt
            tol = (dict(atol=TOL, rtol=TOL) if dt == torch.float32
                   else dict(atol=BF16_ATOL, rtol=BF16_RTOL))
            torch.testing.assert_close(y.float(), ry.float(), **tol)
            torch.testing.assert_close(mean, rmean, atol=TOL, rtol=TOL)
            torch.testing.assert_close(inv, rinv, atol=TOL, rtol=TOL)


@pytest.mark.gpu
def test_kernel_wrapper_raises_on_bad_input():
    _need_card()
    x = torch.zeros(2, 4, 8, 8, device="cuda")
    g = torch.zeros(2, 4, device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        norm_kernels.modulated_instance_norm_fwd(x.transpose(2, 3), g, g)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        norm_kernels.modulated_instance_norm_fwd(x.half(), g, g)
    with pytest.raises(ValueError, match="gamma"):
        norm_kernels.modulated_instance_norm_fwd(x, g[:1], g)


@pytest.mark.gpu
def test_generate_on_card_goes_through_kernel():
    """Tiny AdaIN config, f32: every decoder norm launches the kernel once,
    and the plain path (use_pallas=False) agrees within 5e-4."""
    _need_card()
    cfg = DefectGanConfig(image_size=32, label_nc=4, ngf=8, ndf=8, num_res=2,
                          hidden_nc=16, num_layers=2,
                          style_norm_block_type="adain", use_pallas=True)
    steps = DefectGanSteps(cfg)
    init_weights(steps, 0)
    plain = DefectGanSteps(cfg.replace(use_pallas=False))
    init_weights(plain, 0)
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.rand((2, 32, 32, 3), generator=gen, device="cuda") * 2 - 1
    labels = torch.eye(4, device="cuda")[:2]
    before = norm_kernels.LAUNCHES
    out, prob = steps.generate(x, labels)
    # num_res // 2 NormResBlocks x 2 norms + num_scales NormConvBlocks
    assert norm_kernels.LAUNCHES - before == 2 * (cfg.num_res // 2) + cfg.num_scales
    before = norm_kernels.LAUNCHES
    pout, pprob = plain.generate(x, labels)
    assert norm_kernels.LAUNCHES == before
    torch.testing.assert_close(out, pout, atol=5e-4, rtol=5e-4)
    torch.testing.assert_close(prob, pprob, atol=5e-4, rtol=5e-4)


def _bwd_inputs(shape, dt, gen):
    n, c = shape[:2]
    x = (torch.randn(shape, generator=gen, device="cuda") * 2 + 1).to(dt)
    g = torch.randn((n, c), generator=gen, device="cuda") * 0.5
    b = torch.randn((n, c), generator=gen, device="cuda") * 0.5
    dy = torch.randn(shape, generator=gen, device="cuda").to(dt)
    return x, g, b, dy


def _check_bwd(got, ref, dy_gated_abs, xhat_abs, dt):
    """(dx, dgamma, dbeta) of the kernel against the plain version's."""
    dx, dg, db = got
    rdx, rdg, rdb = ref
    assert dx.dtype == dt and dg.dtype == db.dtype == torch.float32
    if dt == torch.float32:
        torch.testing.assert_close(dx, rdx, atol=BWD_TOL, rtol=BWD_TOL)
    else:
        ulp = torch.exp2(torch.floor(torch.log2(
            rdx.float().abs().clamp_min(2.0 ** -126))) - 7)
        assert ((dx.float() - rdx.float()).abs() <= ulp + BWD_BF16_ATOL).all()
    assert ((db - rdb).abs() <= SUM_BAND * dy_gated_abs + 1e-6).all()
    assert ((dg - rdg).abs() <= SUM_BAND * xhat_abs + 1e-6).all()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bwd_kernel_matches_plain_on_card(dtype):
    """A decoder shape (vector path) and a ragged shape (scalar path); mean
    and inv come from the forward kernel, as in training."""
    _need_card()
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(1)
    for shape in [(16, 256, 64, 64), (3, 5, 7, 9)]:
        x, g, b, dy = _bwd_inputs(shape, dt, gen)
        for act in ACTS:
            _, mean, inv = norm_kernels.modulated_instance_norm_fwd(x, g, b, act)
            _, rmean, rinv = fused.modulated_instance_norm_ref(x, g, b, act)
            torch.testing.assert_close(mean, rmean, atol=TOL, rtol=TOL)
            torch.testing.assert_close(inv, rinv, atol=TOL, rtol=TOL)
            before = norm_kernels.BWD_LAUNCHES
            got = norm_kernels.modulated_instance_norm_bwd(x, g, b, mean, inv,
                                                           dy, act)
            torch.cuda.synchronize()
            assert norm_kernels.BWD_LAUNCHES == before + 1
            ref = fused.modulated_instance_norm_bwd_ref(x, g, b, mean, inv, dy,
                                                        act)
            # the sums' scale, sum |dy| and sum |dy * xhat| (the gate only
            # shrinks terms): the plain backward fed |dy| and |x - mean|
            m = mean[:, :, None, None]
            _, abs_dg, abs_db = fused.modulated_instance_norm_bwd_ref(
                (x.float() - m).abs() + m, g, b, mean, inv, dy.float().abs())
            _check_bwd(got, ref, abs_db, abs_dg, dt)


@pytest.mark.gpu
def test_bwd_kernel_through_autograd_on_card():
    """The autograd node launches the backward kernel with the forward
    kernel's residuals; gradients match autograd through the plain version."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(2)
    x, g, b, dy = _bwd_inputs((4, 32, 16, 16), torch.float32, gen)
    grads = []
    for use_kernel in (True, False):
        xs = [t.clone().requires_grad_() for t in (x, g, b)]
        before = norm_kernels.BWD_LAUNCHES
        y = fused.modulated_instance_norm(*xs, "leaky_relu",
                                          use_kernel=use_kernel)
        y.backward(dy)
        assert norm_kernels.BWD_LAUNCHES == before + int(use_kernel)
        grads.append([t.grad for t in xs])
    for got, ref in zip(*grads):
        torch.testing.assert_close(got, ref, atol=BWD_TOL, rtol=BWD_TOL)


@pytest.mark.gpu
def test_bwd_kernel_wrapper_raises_on_bad_input():
    _need_card()
    x = torch.zeros(2, 4, 8, 8, device="cuda")
    s = torch.zeros(2, 4, device="cuda")
    bwd = norm_kernels.modulated_instance_norm_bwd
    with pytest.raises(ValueError, match="dy must match"):
        bwd(x, s, s, s, s, x.bfloat16())
    with pytest.raises(ValueError, match="dy must be NCHW-contiguous"):
        bwd(x, s, s, s, s, x.transpose(2, 3).contiguous().transpose(2, 3))
    with pytest.raises(ValueError, match="mean must be float32"):
        bwd(x, s, s, s.double(), s, x)
    with pytest.raises(ValueError, match="inv must be float32"):
        bwd(x, s, s, s, s[:1], x)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        bwd(x.half(), s, s, s, s, x.half())


def _tier_cases():
    """(case id, op, dtype, row length, forced tier, expected (tier,
    cluster)) at each tier's boundaries: a warp's one-vector and longest
    rows; a block's first and longest; C with one block just past a block's
    rows; each cluster size's first and longest rows; S past a cluster of 8,
    on a ragged row, and forced on an aligned one. Pure arithmetic on the
    planner's limits."""
    cases = []
    for op in ("fwd", "bwd"):
        for dtype in ("float32", "bfloat16"):
            dt = getattr(torch, dtype)
            v = norm_kernels.VECTOR_ELEMS[dt]
            block = norm_kernels.BLOCK_ROW_VECTORS * v
            rows = [("W-one-vector", v, None, ("W", 1)),
                    ("W-longest", norm_kernels.WARP_ROW_MAX, None, ("W", 1)),
                    ("B-past-W", norm_kernels.WARP_ROW_MAX + v, None, ("B", 1)),
                    ("B-longest", block, None, ("B", 1)),
                    ("C1-past-B", block + v, None, ("C", 1))]
            prev = None
            for cs in norm_kernels.CLUSTER_SIZES:
                longest = norm_kernels.longest_cluster_row(op, dt, cs)
                if prev is not None:
                    rows.append((f"C{cs}-first", prev + v, None, ("C", cs)))
                rows.append((f"C{cs}-longest", longest, None, ("C", cs)))
                prev = longest
            rows += [("S-past-C8", prev + v, None, ("S", 1)),
                     ("S-ragged", 7 * 9, None, ("S", 1)),
                     ("S-forced", 4096, "S", ("S", 1))]
            cases += [(f"{op}-{dtype}-{name}", op, dtype, hw, tier, want)
                      for name, hw, tier, want in rows]
    return cases


TIER_CASES = _tier_cases()


def _tier_inputs(dtype, hw, seed):
    """15 rows (a warp tail: 15 is not a multiple of 8) of hw elements."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x, g, b, dy = _bwd_inputs((3, 5, 1, hw), getattr(torch, dtype), gen)
    return x, g, b, dy


@pytest.mark.gpu
@pytest.mark.parametrize("case", TIER_CASES, ids=[c[0] for c in TIER_CASES])
def test_every_tier_matches_plain_at_its_boundaries(case):
    _, op, dtype, hw, tier, want = case
    _need_card()
    dt = getattr(torch, dtype)
    p = norm_kernels.plan(op, hw, dt, True, tier)
    assert (p.tier, p.cluster) == want
    x, g, b, dy = _tier_inputs(dtype, hw, hw)
    for act in ACTS:
        ry, rmean, rinv = fused.modulated_instance_norm_ref(x, g, b, act)
        counts = dict(norm_kernels.TIER_LAUNCHES[op])
        if op == "fwd":
            y, mean, inv = norm_kernels.modulated_instance_norm_fwd(
                x, g, b, act, tier=tier)
            torch.cuda.synchronize()
            tol = (dict(atol=TOL, rtol=TOL) if dtype == "float32"
                   else dict(atol=BF16_ATOL, rtol=BF16_RTOL))
            torch.testing.assert_close(y.float(), ry.float(), **tol)
            torch.testing.assert_close(mean, rmean, atol=TOL, rtol=TOL)
            torch.testing.assert_close(inv, rinv, atol=TOL, rtol=TOL)
        else:
            got = norm_kernels.modulated_instance_norm_bwd(
                x, g, b, rmean, rinv, dy, act, tier=tier)
            torch.cuda.synchronize()
            ref = fused.modulated_instance_norm_bwd_ref(x, g, b, rmean, rinv,
                                                        dy, act)
            m = rmean[:, :, None, None]
            _, abs_dg, abs_db = fused.modulated_instance_norm_bwd_ref(
                (x.float() - m).abs() + m, g, b, rmean, rinv, dy.float().abs())
            _check_bwd(got, ref, abs_db, abs_dg, dt)
        counts[p.tier] += 1
        assert norm_kernels.TIER_LAUNCHES[op] == counts


BIT_CASES = [c for c in TIER_CASES if c[1] == "bwd" and (
    c[0].endswith("-longest") or c[0].endswith("-forced"))]


@pytest.mark.gpu
@pytest.mark.parametrize("case", BIT_CASES, ids=[c[0] for c in BIT_CASES])
def test_bwd_sums_bit_identical_across_runs_in_every_tier(case):
    """dgamma and dbeta (and dx) of two runs of one tier are the same bits:
    every sum is taken in a fixed order, without atomics."""
    _, _, dtype, hw, tier, _ = case
    _need_card()
    x, g, b, dy = _tier_inputs(dtype, hw, hw + 1)
    _, mean, inv = norm_kernels.modulated_instance_norm_fwd(x, g, b, "relu")
    runs = [norm_kernels.modulated_instance_norm_bwd(x, g, b, mean, inv, dy,
                                                     "relu", tier=tier)
            for _ in range(2)]
    torch.cuda.synchronize()
    for a, b_ in zip(*runs):
        assert torch.equal(a, b_)


# DefectGAN's MAE pretraining at its CLI's batch 32: the decoder's norm
# call sites at 256^2 (six, one and one a G forward)
MAE_SHAPES = [(32, 256, 64, 64), (32, 256, 128, 128), (32, 128, 256, 256)]


@pytest.mark.gpu
@pytest.mark.parametrize("op", ["fwd", "bwd"])
@pytest.mark.parametrize("shape", MAE_SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_every_tier_matches_plain_at_the_mae_shapes(op, shape, dtype):
    """Every tier the planner can run at a batch-32 MAE shape, against the
    plain version, each activation; the planned tier is one of them."""
    _every_tier_matches_plain(op, shape, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("op", ["fwd", "bwd"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_every_tier_matches_plain_at_the_celeba_shape(op, dtype):
    """The same at the 8^2 rows of StarGAN v2's CelebA-HQ generator (w_hpf
    1, batch 8): 64 elements a row, 8 bf16 or 16 f32 vectors, so that most
    of a tier-W warp's 32 lanes hold none."""
    _every_tier_matches_plain(op, (8, 512, 8, 8), dtype)


def _every_tier_matches_plain(op, shape, dtype):
    _need_card()
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(sum(shape))
    x, g, b, dy = _bwd_inputs(shape, dt, gen)
    hw = shape[2] * shape[3]
    tiers = norm_kernels.feasible_tiers(op, hw, dt)
    assert norm_kernels.plan(op, hw, dt, True).tier in tiers and "S" in tiers
    for act in ACTS:
        ry, rmean, rinv = fused.modulated_instance_norm_ref(x, g, b, act)
        if op == "bwd":
            ref = fused.modulated_instance_norm_bwd_ref(x, g, b, rmean, rinv,
                                                        dy, act)
            m = rmean[:, :, None, None]
            _, abs_dg, abs_db = fused.modulated_instance_norm_bwd_ref(
                (x.float() - m).abs() + m, g, b, rmean, rinv, dy.float().abs())
        for tier in tiers:
            if op == "fwd":
                y, mean, inv = norm_kernels.modulated_instance_norm_fwd(
                    x, g, b, act, tier=tier)
                torch.cuda.synchronize()
                tol = (dict(atol=TOL, rtol=TOL) if dtype == "float32"
                       else dict(atol=BF16_ATOL, rtol=BF16_RTOL))
                torch.testing.assert_close(y.float(), ry.float(), **tol)
                torch.testing.assert_close(mean, rmean, atol=TOL, rtol=TOL)
                torch.testing.assert_close(inv, rinv, atol=TOL, rtol=TOL)
                del y
            else:
                got = norm_kernels.modulated_instance_norm_bwd(
                    x, g, b, rmean, rinv, dy, act, tier=tier)
                torch.cuda.synchronize()
                _check_bwd(got, ref, abs_db, abs_dg, dt)
                del got


@pytest.mark.gpu
def test_forced_infeasible_tier_raises_on_card(monkeypatch):
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(8)
    x, g, b, dy = _bwd_inputs((2, 4, 64, 64), torch.bfloat16, gen)
    _, mean, inv = norm_kernels.modulated_instance_norm_fwd(x, g, b)
    with pytest.raises(ValueError, match="tier W cannot run"):
        norm_kernels.modulated_instance_norm_fwd(x, g, b, tier="W")
    with pytest.raises(ValueError, match="tier W cannot run"):
        norm_kernels.modulated_instance_norm_bwd(x, g, b, mean, inv, dy, tier="W")
    r, rg, rb, _ = _bwd_inputs((2, 4, 7, 9), torch.float32, gen)
    with pytest.raises(ValueError, match="tier C cannot run"):
        norm_kernels.modulated_instance_norm_fwd(r, rg, rb, tier="C")
    # a plan the C side does not take: refused without a launch
    before = (norm_kernels.LAUNCHES, dict(norm_kernels.TIER_LAUNCHES["fwd"]))
    bad = norm_kernels.Plan("C", 1, 256, 3, 4096)
    monkeypatch.setattr(norm_kernels, "plan", lambda *a, **k: bad)
    with pytest.raises(RuntimeError, match="cudaError 1"):
        norm_kernels.modulated_instance_norm_fwd(x, g, b)
    assert (norm_kernels.LAUNCHES, norm_kernels.TIER_LAUNCHES["fwd"]) == before


@pytest.mark.gpu
@pytest.mark.parametrize("op", ["fwd", "bwd"])
def test_unaligned_rows_stream_on_card(op):
    """x whose data starts one element past a 16-byte boundary: tier S, on
    its scalar loop, as the plain version."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(9)
    shape = (2, 4, 16, 16)
    buf = torch.randn(2 * 4 * 256 + 1, generator=gen, device="cuda")
    x = buf[1:].view(shape)
    assert x.data_ptr() % 16 != 0 and x.is_contiguous()
    g = torch.randn((2, 4), generator=gen, device="cuda") * 0.5
    b = torch.randn((2, 4), generator=gen, device="cuda") * 0.5
    before = dict(norm_kernels.TIER_LAUNCHES[op])
    ry, rmean, rinv = fused.modulated_instance_norm_ref(x, g, b, "leaky_relu")
    if op == "fwd":
        y, _, _ = norm_kernels.modulated_instance_norm_fwd(x, g, b, "leaky_relu")
        torch.testing.assert_close(y, ry, atol=TOL, rtol=TOL)
    else:
        dy = torch.randn(shape, generator=gen, device="cuda")
        dx, _, _ = norm_kernels.modulated_instance_norm_bwd(
            x, g, b, rmean, rinv, dy, "leaky_relu")
        rdx, _, _ = fused.modulated_instance_norm_bwd_ref(
            x, g, b, rmean, rinv, dy, "leaky_relu")
        torch.testing.assert_close(dx, rdx, atol=BWD_TOL, rtol=BWD_TOL)
    before["S"] += 1
    assert norm_kernels.TIER_LAUNCHES[op] == before


def _sean_pair(dtype):
    """A SEAN layer at a decoder shape through the kernels, and the same
    weights through the plain version (use_pallas=False)."""
    from de_i2i_gan_torch.nn.normalization import SEAN
    torch.manual_seed(4)
    dt = getattr(torch, dtype)
    kern = SEAN(768, 256, 6, 128, dtype=dt, use_pallas=True).cuda()
    plain = SEAN(768, 256, 6, 128, dtype=dt, use_pallas=False).cuda()
    plain.load_state_dict(kern.state_dict())
    gen = torch.Generator(device="cuda").manual_seed(5)
    x = (torch.randn((4, 256, 32, 32), generator=gen, device="cuda") * 2 + 1).to(dt)
    labels = torch.randint(0, 2, (4, 6), generator=gen, device="cuda").float()
    feat = torch.randn((4, 5, 768), generator=gen, device="cuda")
    return kern, plain, x, labels, feat


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sean_norm_forward_through_kernel_matches_plain_on_card(dtype):
    """One launch of the forward kernel, and the plain version's y."""
    _need_card()
    kern, plain, x, labels, feat = _sean_pair(dtype)
    before = norm_kernels.LAUNCHES
    with torch.no_grad():
        y = kern(x, labels, feat)
        torch.cuda.synchronize()
        assert norm_kernels.LAUNCHES == before + 1
        ref = plain(x, labels, feat)
    assert norm_kernels.LAUNCHES == before + 1 and y.dtype == x.dtype
    tol = (dict(atol=TOL, rtol=TOL) if dtype == "float32"
           else dict(atol=BF16_ATOL, rtol=BF16_RTOL))
    torch.testing.assert_close(y.float(), ref.float(), **tol)


@pytest.mark.gpu
def test_sean_norm_backward_through_kernel_matches_plain_on_card():
    """float32: one launch of each kernel; the gradients of x and of the
    SEAN layer's weights match autograd through the plain version."""
    _need_card()
    kern, plain, x, labels, feat = _sean_pair("float32")
    dy = torch.randn(x.shape, generator=torch.Generator(device="cuda")
                     .manual_seed(6), device="cuda")
    grads = []
    for net, launches in ((kern, 1), (plain, 0)):
        xs = x.clone().requires_grad_()
        fwd0, bwd0 = norm_kernels.LAUNCHES, norm_kernels.BWD_LAUNCHES
        net(xs, labels, feat).backward(dy)
        torch.cuda.synchronize()
        assert (norm_kernels.LAUNCHES - fwd0,
                norm_kernels.BWD_LAUNCHES - bwd0) == (launches, launches)
        grads.append([xs.grad] + [p.grad for p in net.parameters()])
    for got, ref in zip(*grads):
        torch.testing.assert_close(got, ref, atol=BWD_TOL, rtol=BWD_TOL)


@pytest.mark.gpu
def test_super_step_on_card_launches_both_kernels_and_matches_cpu():
    """Tiny AdaIN config, f32, SGD: one super-step on the card through both
    kernels against the same super-step on the CPU through the plain
    version, compared as losses and (after - before) / lr."""
    _need_card()
    cfg = DefectGanConfig(image_size=32, label_nc=4, ngf=8, ndf=8, num_res=2,
                          hidden_nc=16, num_layers=2,
                          style_norm_block_type="adain", use_pallas=True)
    tcfg = TrainConfig(batch_size=2, num_critics=2, lr=(2e-2, 1e-2),
                       optimizer="sgd")
    runs = []
    for device in ("cuda", "cpu"):
        steps = DefectGanSteps(cfg, tcfg, device=device)
        steps.init_training()
        init_weights(steps, 0)
        runs.append(steps)
    card, cpu = runs
    before = {n: {k: v.detach().cpu().clone() for k, v in
                  getattr(cpu, n).named_parameters()} for n in "GED"}
    gen = torch.Generator().manual_seed(3)
    batches = {"bg": torch.rand((2, 2, 32, 32, 3), generator=gen) * 2 - 1,
               "df": torch.rand((2, 2, 32, 32, 3), generator=gen) * 2 - 1,
               "df_labels": torch.eye(4)[torch.randint(0, 4, (2, 2),
                                                       generator=gen)]}
    fwd0, bwd0 = norm_kernels.LAUNCHES, norm_kernels.BWD_LAUNCHES
    metrics = card.super_step(batches)
    torch.cuda.synchronize()
    per_g = 2 * (cfg.num_res // 2) + cfg.num_scales
    assert norm_kernels.LAUNCHES - fwd0 == (2 + 2) * per_g
    assert norm_kernels.BWD_LAUNCHES - bwd0 == 2 * per_g
    rmetrics = cpu.super_step(batches)
    for k in rmetrics:
        torch.testing.assert_close(metrics[k].cpu(), rmetrics[k], rtol=2e-4,
                                   atol=0, msg=k)
    for n, lr in (("G", tcfg.lr_g), ("E", tcfg.lr_g), ("D", tcfg.lr_d)):
        got = dict(getattr(card, n).named_parameters())
        for k, ref in getattr(cpu, n).named_parameters():
            start = before[n][k]
            gk = (got[k].detach().cpu() - start) / lr
            rk = (ref.detach() - start) / lr
            # + the element-wise atol, for a gradient that is zero in exact
            # arithmetic (the BN bias before an instance norm)
            assert (gk - rk).norm() <= (GRAD_REL_L2 * rk.norm() + GRAD_ATOL *
                                        rk.numel() ** 0.5), f"{n} {k}"


@pytest.mark.gpu
def test_device_prefetch_on_card_pinned_and_on_a_side_stream(tmp_path):
    """Super-batches out of device_prefetch equal the host's bit for bit;
    their copies come from pinned memory, on a stream that none of the
    consumer's kernels runs on (the profiler's trace)."""
    _need_card()
    import json

    from torch.profiler import ProfilerActivity, profile

    from de_i2i_gan_torch.data.pipeline import (
        DataLoader, DualStreamLoader, device_prefetch)
    from de_i2i_gan_torch.data.synthetic import SyntheticDefectDataset

    def loader():
        df = SyntheticDefectDataset(64, 6, 16, "defects", seed=1)
        bg = SyntheticDefectDataset(64, 6, 16, "background", seed=1)
        return DualStreamLoader(DataLoader(df, 4, seed=1),
                                DataLoader(bg, 4, seed=2), 2)

    host = list(loader())
    fed, sums = [], []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for batch in device_prefetch(loader(), "cuda"):
            sums.append(sum(v.float().sum() for v in batch.values()))
            fed.append(batch)
        torch.cuda.synchronize()
    assert len(fed) == len(host) == 2
    for f, h in zip(fed, host):
        assert sorted(f) == sorted(h)
        for k, v in h.items():
            assert f[k].is_cuda and torch.equal(f[k].cpu(), torch.from_numpy(v))
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    copies = [e for e in events if e.get("cat") == "gpu_memcpy"
              and "HtoD" in e.get("name", "")]
    kernels = {e["args"].get("stream") for e in events
               if e.get("cat") == "kernel"}
    assert len(copies) >= 3 * len(fed) and kernels
    assert all("Pinned" in e["name"] for e in copies), [e["name"] for e in copies]
    assert not {e["args"].get("stream") for e in copies} & kernels


@pytest.mark.gpu
def test_native_feed_through_device_prefetch_on_card(tmp_path):
    """The C++ feed's u8 super-batches (one thread, so two loaders give one
    stream) reach the card through device_prefetch bit for bit."""
    _need_card()
    from de_i2i_gan_torch.data.pipeline import device_prefetch
    from de_i2i_gan_torch.data.synthetic import SyntheticDefectDataset
    from de_i2i_gan_torch.runtime.native_loader import make_native_dual_stream

    def loader():
        df = SyntheticDefectDataset(48, 6, 16, "defects", seed=1)
        bg = SyntheticDefectDataset(48, 6, 16, "background", seed=1)
        return make_native_dual_stream(df, bg, tmp_path, 32, 4, 2, seed=3,
                                       num_threads=1)

    a, b = loader(), loader()
    host = list(a)
    fed = list(device_prefetch(b, "cuda"))
    torch.cuda.synchronize()
    a.close()
    b.close()
    assert len(fed) == len(host) == 2
    for f, h in zip(fed, host):
        assert f["df"].dtype == f["bg"].dtype == torch.uint8
        for k, v in h.items():
            assert f[k].is_cuda and torch.equal(f[k].cpu(), torch.from_numpy(v))


@pytest.mark.gpu
@pytest.mark.parametrize("norm_type", ["adain", "sean"])
def test_starganv2_generate_on_card_goes_through_kernel(norm_type):
    """A small f32 StarGAN v2 request on the card against the same request
    on the CPU (plain version): the style code, then the EMA generator, 8
    forward-kernel launches a G forward at this size; for SEAN also an
    update_stats sweep and an inference_stats request."""
    _need_card()
    from de_i2i_gan_torch.train.jax_import import init_starganv2_weights
    from de_i2i_gan_torch.train.solver import StarGANv2Config, StarGANv2Solver

    cfg = StarGANv2Config(img_size=64, num_domains=3, style_dim=8,
                          latent_dim=4, hidden_nc=16, embed_nc=12, w_hpf=0.0,
                          max_conv_dim=64, num_embeds=5, norm_type=norm_type)
    card, cpu = StarGANv2Solver(cfg, "cuda"), StarGANv2Solver(cfg, "cpu")
    init_starganv2_weights(card, 0)
    init_starganv2_weights(cpu, 0)
    gen = torch.Generator().manual_seed(1)
    req = {"x_src": torch.rand((2, 64, 64, 3), generator=gen) * 2 - 1,
           "x_ref": torch.rand((2, 64, 64, 3), generator=gen) * 2 - 1,
           "z_ref": torch.randn((2, 4), generator=gen),
           "s_ref": torch.randn((2, 5, 12), generator=gen),
           "y": torch.tensor([0, 2])}
    outs = []
    for solver in (card, cpu):
        before = norm_kernels.LAUNCHES
        s = solver.style(req, req["y"], latent=False, use_ema=True)
        out = [solver.generate(req["x_src"], s, req["y"])]
        if norm_type == "sean":
            solver.track_stats_step(req["x_ref"], req["s_ref"], req["y"])
            solver.finalize_ema_stats()
            out.append(solver.generate(req["x_src"], torch.randn(
                (2, 16), generator=torch.Generator().manual_seed(2)), req["y"],
                inference_stats=True))
        torch.cuda.synchronize()
        launched = norm_kernels.LAUNCHES - before
        outs.append([o.cpu() for o in out])
        assert launched == (8 * (2 * len(out) - 1) if solver is card else 0)
    for got, want in zip(*outs):
        torch.testing.assert_close(got, want, atol=5e-4, rtol=5e-4)


@pytest.mark.gpu
def test_kernel_backward_is_once_differentiable():
    """A double backward through the kernel (a gradient penalty through a
    styled norm) raises instead of returning a dx without a graph."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(7)
    x, g, b, _ = _bwd_inputs((2, 8, 16, 16), torch.float32, gen)
    x.requires_grad_()
    y = fused.modulated_instance_norm(x, g, b, "leaky_relu")
    (dx,) = torch.autograd.grad(y.square().sum(), x, create_graph=True)
    # dx's graph ends in the error node, not at x: a backward over the whole
    # graph reaches it
    with pytest.raises(RuntimeError, match="once_differentiable"):
        dx.square().sum().backward()


def _continued(solver):
    """Every optimizer of ``solver`` as if 3 updates had run: nu from a seed
    (so the next update is a smooth function of the gradient, not about
    lr * sign(g) as from a fresh state)."""
    gen = torch.Generator().manual_seed(8)
    for name in ("G", "D", "M", "S"):
        tx = getattr(solver, f"tx_{name}")
        tx.count = 3
        for p in tx.params:
            st = tx.opt.state[p]
            st["step"].fill_(3)
            st["exp_avg_sq"].copy_(torch.rand(p.shape, generator=gen) * 1.5e-2
                                   + 0.5e-2)


@pytest.mark.gpu
def test_starganv2_train_step_on_card_matches_cpu():
    """One tiny AdaIN train_step (f32, the JAX suite's tiny config, batch 2)
    on the card through both kernels against the CPU through the plain
    version, from one state with continued Adam moments: 8 G forwards (64
    forward-kernel launches) and 4 G backwards (32 backward launches); the
    losses within rtol 2e-4; each net's update per tensor within the bands
    of ``tests/test_torch_starganv2_train_step.py`` (D 1e-3, M and S 1e-2,
    G 2e-2 of its L2 norm: the reference pass runs on nets the earlier
    updates moved slightly apart, and its gradient has L1 near-ties)."""
    _need_card()
    from de_i2i_gan_torch.train.jax_import import init_starganv2_weights
    from de_i2i_gan_torch.train.solver import StarGANv2Config, StarGANv2Solver

    cfg = StarGANv2Config(img_size=64, num_domains=3, style_dim=8,
                          latent_dim=4, hidden_nc=16, embed_nc=12, w_hpf=0.0,
                          max_conv_dim=64, ds_iter=10, norm_type="adain")
    runs = []
    for device in ("cuda", "cpu"):
        solver = StarGANv2Solver(cfg, device)
        solver.init_training()
        init_starganv2_weights(solver, 0)
        _continued(solver)
        runs.append(solver)
    card, cpu = runs
    before = {n: [p.detach().cpu().clone() for p in getattr(cpu, n).parameters()]
              for n in "GDMS"}
    gen = torch.Generator().manual_seed(9)
    batch = {k: torch.rand((2, 64, 64, 3), generator=gen) * 2 - 1
             for k in ("x_src", "x_ref", "x_ref2")}
    batch.update(y_src=torch.tensor([0, 1]), y_ref=torch.tensor([2, 0]),
                 z_ref=torch.randn((2, 4), generator=gen),
                 z_ref2=torch.randn((2, 4), generator=gen))
    fwd0, bwd0 = norm_kernels.LAUNCHES, norm_kernels.BWD_LAUNCHES
    metrics = card.train_step(batch)
    torch.cuda.synchronize()
    assert (norm_kernels.LAUNCHES - fwd0, norm_kernels.BWD_LAUNCHES - bwd0) == (
        8 * 8, 4 * 8)
    rmetrics = cpu.train_step(batch)
    for k in rmetrics:
        torch.testing.assert_close(metrics[k].cpu(), rmetrics[k], rtol=2e-4,
                                   atol=1e-7, msg=k)
    bands = {"G": 2e-2, "D": 1e-3, "M": 1e-2, "S": 1e-2}
    for n, rel in bands.items():
        for start, got, ref in zip(before[n], getattr(card, n).parameters(),
                                   getattr(cpu, n).parameters()):
            gk, rk = got.detach().cpu() - start, ref.detach() - start
            assert (gk - rk).norm() <= rel * rk.norm() + 1e-9 * rk.numel() ** 0.5, n
    assert card.step == cpu.step == 1 and card.tx_M.count == 4


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ACTS)
def test_opcheck_of_both_ops_on_card(dtype, act):
    """The custom ops' schema, fake and autograd registrations against
    their CUDA implementations (``torch.library.opcheck``), at a DefectGAN
    decoder row (64²) and a StarGAN v2 one (16²)."""
    _need_card()
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(11)
    fwd = torch.ops.de_i2i_gan_torch.modulated_instance_norm_fwd.default
    bwd = torch.ops.de_i2i_gan_torch.modulated_instance_norm_bwd.default
    for shape in [(2, 16, 64, 64), (4, 32, 16, 16)]:
        x, g, b, dy = _bwd_inputs(shape, dt, gen)
        torch.library.opcheck(fwd, (x, g, b, act, 1e-5))
        torch.library.opcheck(fwd, (x.clone().requires_grad_(),
                                    g.clone().requires_grad_(),
                                    b.clone().requires_grad_(), act, 1e-5))
        _, mean, inv = fused.modulated_instance_norm_ref(x, g, b, act)
        torch.library.opcheck(bwd, (x, g, b, mean, inv, dy, act))


@pytest.mark.gpu
@pytest.mark.parametrize("style", ["adain", "sean"])
def test_exported_generator_on_card_launches_the_kernel(style, tmp_path):
    """A small DefectGAN G exported on the card: its graph holds the forward
    op once for each styled norm (num_res 2: one residual block of two, and
    a block for each of the 2 scales), the loaded artifact launches the
    kernel that often a forward, and computes what eager computes."""
    _need_card()
    from de_i2i_gan_torch import serving
    cfg = DefectGanConfig(image_size=32, label_nc=4, ngf=8, ndf=8, num_res=2,
                          hidden_nc=16, num_layers=2, embed_nc=12,
                          num_embeds=2, style_norm_block_type=style,
                          use_pallas=True)
    steps = DefectGanSteps(cfg, TrainConfig(), device="cuda")
    init_weights(steps, 0)
    program = serving.export_defectgan_generator(steps)
    per_forward = 2 * (cfg.num_res // 2) + cfg.num_scales
    assert serving.kernel_nodes(program) == per_forward
    served = serving.load_exported(serving.save_exported(
        program, tmp_path / "g.pt2")).module()
    args = serving.defectgan_example_args(
        steps, 3, 1, torch.Generator().manual_seed(1))
    before = norm_kernels.LAUNCHES
    with torch.no_grad():
        got = served(*args)
        torch.cuda.synchronize()
        assert norm_kernels.LAUNCHES == before + per_forward
        want = serving.defectgan_serving_module(steps)(*args)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=TOL, rtol=TOL)


def _split_inputs(shape, dt, gen):
    n, c = shape[:2]
    x = (torch.randn(shape, generator=gen, device="cuda") * 2 + 1).to(dt)
    g = torch.randn((n, c), generator=gen, device="cuda") * 0.5
    b = torch.randn((n, c), generator=gen, device="cuda") * 0.5
    return x, g, b


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_kernels_match_plain_on_card(dtype):
    """The moments and apply kernels on an aligned band (vector loop), a
    ragged one (scalar loop) and an unaligned view (scalar loop), every
    activation; one launch each, counted apart from the fused kernels."""
    _need_card()
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(12)
    aligned = _split_inputs((4, 8, 32, 64), dt, gen)
    ragged = _split_inputs((3, 5, 7, 9), dt, gen)
    x, g, b = _split_inputs((4, 8, 32, 64), dt, gen)
    buf = torch.empty(x.numel() + 1, dtype=dt, device="cuda")
    unaligned = (buf[1:].view(x.shape).copy_(x), g, b)  # 16-byte misaligned
    assert unaligned[0].data_ptr() % 16
    tol = (dict(atol=TOL, rtol=TOL) if dt == torch.float32
           else dict(atol=BF16_ATOL, rtol=BF16_RTOL))
    for x, g, b in (aligned, ragged, unaligned):
        before = dict(norm_kernels.SPLIT_LAUNCHES)
        fused_before = norm_kernels.LAUNCHES
        sums = norm_kernels.modulated_instance_norm_moments(x)
        ref = fused.modulated_instance_norm_moments_ref(x)
        xf = x.float()
        terms = torch.stack([xf.abs().sum(dim=(2, 3)),
                             xf.square().sum(dim=(2, 3))])
        assert ((sums - ref).abs() <= SUM_BAND * terms).all()
        mean, inv = fused.moments_to_stats(ref, x.shape[2] * x.shape[3])
        for act in ACTS:
            y = norm_kernels.modulated_instance_norm_apply(x, mean, inv, g, b,
                                                           act)
            torch.cuda.synchronize()
            ry = fused.modulated_instance_norm_apply_ref(x, mean, inv, g, b,
                                                         act)
            assert y.dtype == dt and y.shape == x.shape
            torch.testing.assert_close(y.float(), ry.float(), **tol)
        assert norm_kernels.SPLIT_LAUNCHES == {
            "moments": before["moments"] + 1,
            "apply": before["apply"] + len(ACTS)}
        assert norm_kernels.LAUNCHES == fused_before


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_one_band_equals_the_fused_kernel(dtype):
    _need_card()
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(13)
    for shape in [(4, 16, 64, 64), (3, 5, 7, 9)]:
        x, g, b = _split_inputs(shape, dt, gen)
        for act in ACTS:
            y, mean, inv = norm_kernels.modulated_instance_norm_fwd(
                x, g, b, act, tier="S")
            sums = norm_kernels.split_moments(x)
            smean, sinv = fused.moments_to_stats(sums, shape[2] * shape[3])
            assert torch.equal(smean, mean)
            torch.testing.assert_close(sinv, inv, rtol=2 ** -22, atol=0)
            sy = norm_kernels.split_apply(x, smean, sinv, g, b, act)
            tol = (dict(atol=TOL, rtol=TOL) if dt == torch.float32
                   else dict(atol=BF16_ATOL, rtol=BF16_RTOL))
            torch.testing.assert_close(sy.float(), y.float(), **tol)
            out = fused.sharded_modulated_instance_norm(x, g, b, act)
            torch.testing.assert_close(out.float(), y.float(), **tol)


@pytest.mark.gpu
def test_split_ops_on_card():
    """opcheck of the split ops' CUDA implementations; a CUDA tensor that
    requires grad is refused."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(14)
    x, g, b = _split_inputs((2, 16, 32, 32), torch.bfloat16, gen)
    moments = torch.ops.de_i2i_gan_torch.modulated_instance_norm_moments
    apply = torch.ops.de_i2i_gan_torch.modulated_instance_norm_apply
    torch.library.opcheck(moments.default, (x,))
    mean, inv = fused.moments_to_stats(moments(x), 32 * 32)
    for act in ACTS:
        torch.library.opcheck(apply.default, (x, mean, inv, g, b, act))
    with pytest.raises(RuntimeError, match="inference only"):
        norm_kernels.split_moments(x.clone().requires_grad_())
