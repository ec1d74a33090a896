"""A whole run on the CPU, without the harness's look for a chip, at tiny
widths: sound, it comes out correct; with the timed path broken
underneath, ``correct`` comes out false, once for each fault the cell can
have (one chip, so no exchange between chips to leave out):

  * training: a step that leaves its state unchanged; half of the batch
    left out, the mean taken over the rest;
  * serving: an answer altered where it is produced; half of the batch
    left out.
"""
import pytest
import torch

from perfbench.families import defectgan
from perfbench.lib import harness
from perfbench.tests import tiny

SEED = 2 ** 31 + 11


def _run(config_name, traffic_name, batch=2):
    config = tiny.config(config_name)
    traffic = tiny.traffic(traffic_name, batch=batch)
    cell = tiny.cell(config_name, traffic_name)
    result, lines = harness.run(config, traffic, cell, SEED, 0.5, False, "cpu")
    return result


def _half(rows, batch):
    return {k: v.narrow(list(v.shape).index(batch), 0, batch // 2)
            for k, v in rows.items()}


def test_sound_training_run_is_correct():
    assert _run("defectgan256_adain", "train_b8")["correct"]


def test_unchanged_state(monkeypatch):
    prog = defectgan.Program
    step = prog.step

    def unchanged(self, i):
        before = {k: v.detach().clone() for k, v in self.leaves().items()}
        out = step(self, i)
        with torch.no_grad():
            for k, v in self.leaves().items():
                v.copy_(before[k])
        return out

    monkeypatch.setattr(prog, "step", unchanged)
    assert not _run("defectgan256_adain", "train_b8")["correct"]


def test_half_batch(monkeypatch):
    rows = defectgan.Program.rows
    monkeypatch.setattr(defectgan.Program, "rows",
                        lambda self, i: _half(rows(self, i), 4))
    assert not _run("defectgan256_adain", "train_b8", batch=4)["correct"]


def test_sound_serving_run_is_correct():
    assert _run("defectgan256_adain", "serve")["correct"]


def test_altered_answer(monkeypatch):
    answer = defectgan.Program.answer

    def altered(self, i):
        out, prob = answer(self, i)
        out = out.clone()
        out[0, 0, 0, 0] += 0.5
        return out, prob

    monkeypatch.setattr(defectgan.Program, "answer", altered)
    assert not _run("defectgan256_adain", "serve")["correct"]


def test_half_batch_served(monkeypatch):
    rows = defectgan.Program.rows
    monkeypatch.setattr(defectgan.Program, "rows",
                        lambda self, i: _half(rows(self, i), 4))
    assert not _run("defectgan256_adain", "serve", batch=4)["correct"]
