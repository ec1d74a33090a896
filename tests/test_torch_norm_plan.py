"""The modulated instance norm kernels' planner (``ops/cuda/norm_kernels.py::
plan``), on the CPU: torch only, no card.

Every shape on the port's paths (``chip_smoke.py``'s ``SLICE_SHAPES``,
``TRAIN_SHAPES``, ``SGV2_SHAPES``, ``SGV2_TRAIN_SHAPES`` and
``CELEBA_TRAIN_SHAPES``) maps to its
intended tier and cluster size, forward and backward, in bfloat16 and
float32; the tier boundaries land where the plan says; every plan stays
within the H100's limits; ragged rows and unaligned pointers stream (tier
S); a forced tier the kernels cannot run raises, and a forced tier on a CPU
tensor raises before any launch. The tiers: W, a warp per row; B, a block
per row; C, a cluster of 1, 2, 4 or 8 blocks per row; S, streaming. The kernels themselves run on the card
(``tests/test_torch_kernel_gpu.py``, ``chip_smoke.py``).
"""
import importlib.util
import re
from pathlib import Path

import pytest
import torch

from de_i2i_gan_torch.ops import fused
from de_i2i_gan_torch.ops.cuda import norm_kernels as nk

ROOT = Path(__file__).resolve().parents[1]
OPS = ["fwd", "bwd"]
DTYPES = ["bfloat16", "float32"]

# the H100's limits (CUDA's per-block maxima on sm_90)
MAX_DYNAMIC_SMEM = 232_448
SM_SMEM = 233_472  # shared memory of one SM
BLOCK_RESERVED_SMEM = 1024  # what the runtime keeps of it for each block
MAX_CLUSTER = 8  # portable cluster size
MAX_THREADS = 1024
# static shared memory of a tier-C block: 24 mbarriers, block_sum2's two
# arrays of 8 floats, the cluster partial
CLUSTER_STATIC_SMEM = 24 * 8 + 2 * 8 * 4 + 8


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_SMOKE = _smoke()
PATH_SHAPES = sorted({s for shapes in (_SMOKE.SLICE_SHAPES, _SMOKE.TRAIN_SHAPES,
                                       _SMOKE.SGV2_SHAPES,
                                       _SMOKE.SGV2_TRAIN_SHAPES,
                                       _SMOKE.CELEBA_TRAIN_SHAPES)
                      for s in shapes})

# the intended (tier, cluster) of each row length on the paths
INTENDED = {
    ("fwd", "bfloat16"): {64: ("W", 1), 256: ("W", 1), 1024: ("W", 1),
                          4096: ("B", 1), 16384: ("C", 1), 65536: ("C", 2)},
    ("bwd", "bfloat16"): {64: ("W", 1), 256: ("W", 1), 1024: ("W", 1),
                          4096: ("B", 1), 16384: ("C", 1), 65536: ("C", 4)},
    ("fwd", "float32"): {64: ("W", 1), 256: ("W", 1), 1024: ("W", 1),
                         4096: ("B", 1), 16384: ("C", 1), 65536: ("C", 4)},
    ("bwd", "float32"): {64: ("W", 1), 256: ("W", 1), 1024: ("W", 1),
                         4096: ("B", 1), 16384: ("C", 2), 65536: ("C", 8)},
}


def _vec(dtype):
    return nk.VECTOR_ELEMS[getattr(torch, dtype)]


def test_path_shapes_cover_every_row_length():
    assert {h * w for _, _, h, w in PATH_SHAPES} == set(INTENDED["fwd", "bfloat16"])
    assert len(PATH_SHAPES) == 16


@pytest.mark.parametrize("shape", PATH_SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("op", OPS)
def test_path_shape_gets_its_intended_tier(op, dtype, shape):
    hw = shape[2] * shape[3]
    p = nk.plan(op, hw, getattr(torch, dtype), True)
    assert (p.tier, p.cluster) == INTENDED[op, dtype][hw]
    assert p.threads == nk.BLOCK_THREADS == 256
    if p.tier in "WB":
        assert (p.rows_per_block, p.smem) == (8 if p.tier == "W" else 1, 0)
        return
    # the fewest blocks a row whose slices fit the budget
    nvec = hw // _vec(dtype)
    tensors = nk.SLICE_TENSORS[op]
    assert p.rows_per_block == 1
    assert p.smem == tensors * -(-nvec // p.cluster) * 16 <= nk.SLICE_BUDGET
    if p.cluster > 1:
        assert tensors * -(-nvec // (p.cluster // 2)) * 16 > nk.SLICE_BUDGET


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("op", OPS)
def test_warp_tier_boundary(op, dtype):
    dt, v = getattr(torch, dtype), _vec(dtype)
    assert nk.plan(op, nk.WARP_ROW_MAX, dt, True).tier == "W"
    assert nk.plan(op, nk.WARP_ROW_MAX + v, dt, True) == nk.Plan("B", 1, 256, 1, 0)
    assert nk.plan(op, nk.WARP_ROW_MAX + 1, dt, True).tier == "S"  # ragged
    assert nk.plan(op, v, dt, True).tier == "W"  # one vector: lane 0 alone
    assert nk.feasible_tiers(op, nk.WARP_ROW_MAX, dt) == ("W", "B", "C", "S")
    assert nk.feasible_tiers(op, nk.WARP_ROW_MAX + v, dt) == ("B", "C", "S")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("op", OPS)
def test_block_tier_boundary(op, dtype):
    """A block holds 1024 16-byte vectors of a row in registers (4 a
    thread); the next aligned row takes a cluster of one block."""
    dt, v = getattr(torch, dtype), _vec(dtype)
    longest = nk.BLOCK_ROW_VECTORS * v
    assert longest == {"bfloat16": 8192, "float32": 4096}[dtype]
    assert nk.plan(op, longest, dt, True) == nk.Plan("B", 1, 256, 1, 0)
    nxt = nk.plan(op, longest + v, dt, True)
    assert (nxt.tier, nxt.cluster) == ("C", 1)
    assert nk.feasible_tiers(op, longest + v, dt) == ("C", "S")
    with pytest.raises(ValueError, match="tier B cannot run"):
        nk.plan(op, longest + v, dt, True, "B")


@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("op", OPS)
def test_cluster_tier_boundaries(op, dtype, cluster):
    """The longest row a cluster holds takes it; the next aligned row takes
    twice the blocks, or streams past a cluster of 8."""
    dt, v = getattr(torch, dtype), _vec(dtype)
    longest = nk.longest_cluster_row(op, dt, cluster)
    # the budget's bytes over a tensor's element size, a block
    assert longest == cluster * nk.SLICE_BUDGET // (nk.SLICE_TENSORS[op]
                                                    * (16 // v))
    p = nk.plan(op, longest, dt, True)
    assert (p.tier, p.cluster, p.smem) == ("C", cluster, nk.SLICE_BUDGET)
    nxt = nk.plan(op, longest + v, dt, True)
    if cluster < 8:
        assert (nxt.tier, nxt.cluster) == ("C", 2 * cluster)
    else:
        assert nxt.tier == "S"
        assert nk.feasible_tiers(op, longest + v, dt) == ("S",)
        with pytest.raises(ValueError, match="tier C cannot run"):
            nk.plan(op, longest + v, dt, True, "C")


def _lengths(dtype):
    """Aligned row lengths from one vector past a cluster of 8's longest:
    the path's, the boundaries, and a sweep of odd multiples between."""
    v = _vec(dtype)
    out = {v, 2 * v, 31 * v, 32 * v, 33 * v, nk.WARP_ROW_MAX, nk.WARP_ROW_MAX + v,
           nk.BLOCK_ROW_VECTORS * v, (nk.BLOCK_ROW_VECTORS + 1) * v}
    out |= set(INTENDED["fwd", dtype])
    for op in OPS:
        for cs in (1, 2, 4, 8):
            longest = nk.longest_cluster_row(op, getattr(torch, dtype), cs)
            out |= {longest - v, longest, longest + v}
    out |= {v * k for k in range(1, 1 << 16, 997)}
    return sorted(out)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("op", OPS)
def test_every_plan_within_the_cards_limits(op, dtype):
    dt, v = getattr(torch, dtype), _vec(dtype)
    for hw in _lengths(dtype):
        for tier in nk.feasible_tiers(op, hw, dt):
            p = nk.plan(op, hw, dt, True, tier)
            assert p.threads <= MAX_THREADS and p.threads % 32 == 0, p
            assert p.rows_per_block * (32 if p.tier == "W" else p.threads) == p.threads, p
            assert 1 <= p.cluster <= MAX_CLUSTER and p.cluster in nk.CLUSTER_SIZES, p
            assert 0 <= p.smem <= min(nk.SLICE_BUDGET, MAX_DYNAMIC_SMEM), p
            if p.tier == "C":
                # each tensor's slice is whole 16-byte vectors, and two
                # blocks stay resident on an SM
                slice_bytes = p.smem // nk.SLICE_TENSORS[op]
                assert slice_bytes % 16 == 0 and slice_bytes > 0, p
                assert -(-hw // v) <= p.cluster * slice_bytes // 16, p
                assert 2 * (p.smem + CLUSTER_STATIC_SMEM + BLOCK_RESERVED_SMEM) <= SM_SMEM
            else:
                assert p.smem == 0 and p.cluster == 1, p
            if p.tier == "W":
                assert hw <= nk.WARP_ROW_MAX and hw % v == 0
            if p.tier == "B":
                assert hw // v <= nk.BLOCK_ROW_VECTORS and hw % v == 0


@pytest.mark.parametrize("hw", [1, 3, 63, 9 * 9, 1025, 4095, 65537])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("op", OPS)
def test_ragged_rows_stream(op, dtype, hw):
    dt = getattr(torch, dtype)
    if hw % _vec(dtype) == 0:
        pytest.fail(f"{hw} is not ragged in {dtype}")
    p = nk.plan(op, hw, dt, True)
    assert p == nk.Plan("S", 1, 256, 1, 0)
    assert nk.feasible_tiers(op, hw, dt) == ("S",)
    for tier in ("W", "B", "C"):
        with pytest.raises(ValueError, match=f"tier {tier} cannot run"):
            nk.plan(op, hw, dt, True, tier)


@pytest.mark.parametrize("hw", [256, 1024, 4096, 16384, 65536])
@pytest.mark.parametrize("op", OPS)
def test_unaligned_pointers_stream(op, hw):
    for dtype in DTYPES:
        dt = getattr(torch, dtype)
        assert nk.plan(op, hw, dt, False).tier == "S"
        assert nk.feasible_tiers(op, hw, dt, aligned=False) == ("S",)
        for tier in ("W", "B", "C"):
            with pytest.raises(ValueError, match="unaligned"):
                nk.plan(op, hw, dt, False, tier)


def test_forced_tiers():
    bf16 = torch.bfloat16
    # C and B forced on a short row; S takes any row
    assert nk.plan("fwd", 256, bf16, True, "C") == nk.Plan("C", 1, 256, 1, 512)
    assert nk.plan("bwd", 256, bf16, True, "C") == nk.Plan("C", 1, 256, 1, 1024)
    assert nk.plan("bwd", 256, bf16, True, "B") == nk.Plan("B", 1, 256, 1, 0)
    assert nk.plan("bwd", 65536, bf16, True, "S") == nk.Plan("S", 1, 256, 1, 0)
    with pytest.raises(ValueError, match="tier W cannot run"):
        nk.plan("fwd", 4096, bf16, True, "W")
    with pytest.raises(ValueError, match="tier must be one of"):
        nk.plan("fwd", 256, bf16, True, "X")
    with pytest.raises(ValueError, match="op must be"):
        nk.plan("both", 256, bf16, True)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        nk.plan("fwd", 256, torch.float16, True)
    with pytest.raises(ValueError, match="non-empty"):
        nk.plan("fwd", 0, bf16, True)


def _no_kernel():
    raise AssertionError("the CUDA library was loaded for a CPU tensor")


@pytest.mark.parametrize("tier", [None, "W", "B", "C", "S"])
@pytest.mark.parametrize("op", OPS)
def test_forced_tier_on_cpu_tensor_raises(op, tier, monkeypatch):
    monkeypatch.setattr(nk, "_kernel", _no_kernel)
    monkeypatch.setattr(nk, "TIER_LAUNCHES", {o: dict.fromkeys(nk.TIERS, 0)
                                              for o in OPS})
    x = torch.zeros(2, 3, 16, 16)
    s = torch.zeros(2, 3)
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        if op == "fwd":
            nk.modulated_instance_norm_fwd(x, s, s, tier=tier)
        else:
            nk.modulated_instance_norm_bwd(x, s, s, s, s, x, tier=tier)
    assert nk.TIER_LAUNCHES == {o: dict.fromkeys(nk.TIERS, 0) for o in OPS}


def test_cpu_path_counts_no_tier(monkeypatch):
    """The public path on a CPU tensor runs the plain version and counts no
    launch of any tier."""
    monkeypatch.setattr(nk, "_kernel", _no_kernel)
    monkeypatch.setattr(nk, "TIER_LAUNCHES", {o: dict.fromkeys(nk.TIERS, 0)
                                              for o in OPS})
    x = torch.randn(2, 3, 16, 16, requires_grad=True)
    g = torch.zeros(2, 3, requires_grad=True)
    fused.modulated_instance_norm(x, g, g, "relu").sum().backward()
    assert x.grad is not None
    assert nk.TIER_LAUNCHES == {o: dict.fromkeys(nk.TIERS, 0) for o in OPS}


def test_planner_limits_match_the_source():
    src = nk.SOURCE.read_text()

    def const(name):
        return int(re.search(rf"constexpr \w+ {name} = (\d+);", src).group(1))

    assert const("kThreads") == nk.BLOCK_THREADS
    assert const("kWarpRowMax") == nk.WARP_ROW_MAX
    assert const("kBlockVectors") * nk.BLOCK_THREADS == nk.BLOCK_ROW_VECTORS
    assert const("kSliceBudget") == nk.SLICE_BUDGET
    assert const("kMaxCluster") == max(nk.CLUSTER_SIZES)
    tiers = re.search(r"enum Tier \{ kTierS = (\d), kTierW = (\d), kTierC = (\d), "
                      r"kTierB = (\d) \}", src)
    assert tuple(map(int, tiers.groups())) == tuple(nk.TIER_CODES[t] for t in "SWCB")
    # 4 KB chunks a tensor, at most one mbarrier each
    assert nk.SLICE_BUDGET // (16 * nk.BLOCK_THREADS) == 24
