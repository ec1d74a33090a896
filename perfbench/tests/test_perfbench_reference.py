"""The reference copy against the program at tiny widths on the CPU, in
float32: one DefectGAN super-step and one DefectGAN generate."""
import statistics

import pytest
import torch

from perfbench.lib import harness, spec
from perfbench.tests import tiny

SEED = 2 ** 31 + 5


def _pair(config, traffic):
    fam = spec.family(config["family"])
    return (fam.Program(config, traffic, SEED, "cpu"),
            fam.Reference(config, traffic, SEED, "cpu"))


def test_defectgan_super_step():
    config, traffic = tiny.config("defectgan256_adain"), tiny.traffic("train_b8")
    prog, ref = _pair(config, traffic)
    def totals(t, i):
        return t

    a = harness.training_readings(prog, 1, totals)
    b = harness.training_readings(ref, 1, totals)
    assert set(a["losses"][0]) >= set(b["losses"][0])
    for k, v in b["losses"][0].items():
        assert a["losses"][0][k] == pytest.approx(v, rel=1e-5, abs=1e-7), k
    assert set(a["grad"]) == set(b["grad"]) == set(a["change"])
    # float32 on both sides; an L1 term with a near-tie (sd_cyc) can take
    # the other sign of its gradient in one of them, so 1e-3 of the norms
    floor = statistics.median(b["grad"].values())
    for k, v in b["grad"].items():
        assert abs(a["grad"][k] - v) <= 1e-3 * max(v, floor), k
    for k, v in b["change"].items():
        assert abs(a["change"][k] - v) <= 1e-3 * max(v, floor), k


def test_defectgan_generate():
    config, traffic = tiny.config("defectgan256_adain"), tiny.traffic("serve", batch=3)
    prog, ref = _pair(config, traffic)
    for i in range(2):
        got, want = prog.answer(i), ref.answer(i)
        assert [t.shape for t in got] == [t.shape for t in want]
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)
