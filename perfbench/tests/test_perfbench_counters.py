"""The FLOP counter and the norm's byte count against hand counts, and the
whole steps' counts against counts made by hand from the shapes."""
import pytest
import torch
import torch.nn.functional as F

from perfbench.lib import flops, harness, spec
from perfbench.tests import tiny


def test_one_conv_forward_and_backward():
    x = torch.empty(2, 3, 8, 8, device="meta", requires_grad=True)
    w = torch.empty(4, 3, 3, 3, device="meta", requires_grad=True)
    with flops.FlopCounter() as c:
        y = F.conv2d(x, w, padding=1)
    one = 2 * (2 * 4 * 8 * 8) * (3 * 3 * 3)  # 2 x outputs x MACs an output
    assert c.flops == one
    with flops.FlopCounter() as c:
        torch.autograd.grad(y.sum(), (x, w))
    assert c.flops == 2 * one  # grad of the input and of the weight


def test_one_matmul():
    a = torch.empty(5, 7, device="meta")
    b = torch.empty(7, 3, device="meta")
    with flops.FlopCounter() as c:
        a @ b
    assert c.flops == 2 * 5 * 7 * 3


def test_norm_bound():
    n, c, h, w = 2, 4, 8, 8
    numel = n * c * h * w
    bw, pf = 3.35e12, 67e12
    fwd_bytes = 2 * numel * 2 + 4 * n * c * 4
    bwd_bytes = 3 * numel * 2 + 6 * n * c * 4
    want = max(fwd_bytes / bw, 5 * numel / pf) + max(bwd_bytes / bw, 12 * numel / pf)
    got = flops.norm_bound_s([((n, c, h, w), True)], 2, bw, pf)
    assert got == pytest.approx(want, rel=1e-12)
    assert flops.norm_bound_s([((n, c, h, w), False)], 2, bw, pf) == pytest.approx(
        max(fwd_bytes / bw, 5 * numel / pf), rel=1e-12)


@pytest.mark.parametrize("config,traffic,tflop,fwd,bwd", [
    # 4 x (5 x 0.5067 + 2.2156) TFLOP at batch 2, counted by hand on the
    # plain float32 path: a super-step of 5 critics at batch 8
    ("defectgan256_adain", "train_b8", 19.00, 56, 16),
    ("defectgan256_adain", "serve", 4 * 0.7525, 8, 0),
])
def test_step_costs(config, traffic, tflop, fwd, bwd):
    cfg = spec.load_json(spec.PERFBENCH / "configs" / f"{config}.json")
    tr = tiny.SERVE if traffic == "serve" else spec.traffic(traffic)
    count, calls = harness.step_cost(spec.family(cfg["family"]), cfg, tr)
    assert count / 1e12 == pytest.approx(tflop, rel=1e-3)
    assert len(calls) == fwd and sum(b for _, b in calls) == bwd
