"""The control, at a size a test run holds: the reference computed in
float8 (the precision below the configurations' bfloat16) put in the
program's place, through a whole run on the CPU, comes out not correct
under each cell's limits. On the chip the same control was read at the
cells' own sizes (``tools/calibrate.py``; PERF.md gives the readings)."""
import pytest
import torch

from perfbench.families import defectgan
from perfbench.lib import harness
from perfbench.tests import tiny

SEED = 2 ** 31 + 23


def control_of(family):
    class Control:
        """The float8 reference with the program's interface."""

        def __init__(self, config, traffic, seed, device="cuda"):
            self.ref = family.Reference(config, traffic, seed, device,
                                        precision="float8")

        def rows(self, i):
            return self.ref.rows(i)

        def step(self, i):
            return self.ref.step(i)

        def answer(self, i):
            with torch.no_grad():
                return tuple(t.cpu() for t in self.ref.answer(i))

        def first_moment_norms(self):
            return self.ref.first_moment_norms()

        def leaves(self):
            return self.ref.leaves()

        def release(self):
            del self.ref

    return Control


@pytest.mark.parametrize("config_name,traffic_name,family,over", [
    ("defectgan256_adain", "train_b8", defectgan, {}),
    # the served answers' gaps grow with the widths: the published ones,
    # at 64x64
    ("defectgan256_adain", "serve", defectgan,
     {"image_size": 64, "ngf": 64, "ndf": 64, "hidden_nc": 128, "num_res": 6}),
])
def test_control_is_not_correct(monkeypatch, config_name, traffic_name, family,
                                over):
    monkeypatch.setattr(family, "Program", control_of(family))
    config = tiny.config(config_name, **over)
    traffic = tiny.traffic(traffic_name)
    cell = tiny.cell(config_name, traffic_name)
    result, _ = harness.run(config, traffic, cell, SEED, 0.5, False, "cpu")
    assert not result["correct"]
