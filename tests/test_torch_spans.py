"""The port's span and counter registry (``utils/profiling.py``), the spans
on DefectGAN's super-step, and the benchmark's per-layer metrics that read
them (``perfbench/metrics``), on the CPU. The device clock is exercised with
stand-in CUDA events; ``tests/test_torch_kernel_gpu.py`` holds it on the
card."""
import itertools
import json
import re
import threading
from pathlib import Path

import pytest
import torch

from de_i2i_gan_torch.config import DefectGanConfig, TrainConfig
from de_i2i_gan_torch.ops.cuda import norm_kernels
from de_i2i_gan_torch.train.steps import DefectGanSteps
from de_i2i_gan_torch.utils import profiling
from perfbench.lib import spec

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CRITICS = 2
# the spans of a super-step, and how many of each one records
TABLE = {"train.super_step": 1, "train.d_step": CRITICS, "train.g_step": 1,
         "train.backward": CRITICS + 1, "optim.step": CRITICS + 2}
MIGRATED = ("parallel.batch_norm", "parallel.grad_all_reduce", "spatial.halo",
            "spatial.moments", "solver.embed_fake", "solver.heatmaps",
            "evaluator.inception")
READERS = {"step.d_update_ms.train": 150.0, "step.g_update_ms.train": 75.0,
           "model.backward_ms.train": 100.0, "model.optim_step_ms.train": 20.0,
           "kernel.norm_launches_per_step.train": 72.0}
REPORT = {"train.super_step": {"count": 2, "device_ms": 460.0,
                               "counters": {"norm.launches": 144}},
          "train.d_step": {"count": 10, "device_ms": 300.0, "counters": {}},
          "train.g_step": {"count": 2, "device_ms": 150.0, "counters": {}},
          "train.backward": {"count": 12, "device_ms": 200.0, "counters": {}},
          "optim.step": {"count": 14, "device_ms": 40.0, "counters": {}}}
SUMMARY = {"mode": "train", "steps": 100, "seconds": 40.0, "traced_steps": 2}


@pytest.fixture(autouse=True)
def empty_registry():
    profiling.reset()
    yield
    profiling.reset()


@pytest.fixture(scope="module")
def steps():
    cfg = DefectGanConfig(image_size=32, label_nc=4, ngf=8, ndf=8, num_res=2,
                          hidden_nc=16, num_layers=2,
                          style_norm_block_type="adain")
    s = DefectGanSteps(cfg, TrainConfig(batch_size=2, num_critics=CRITICS),
                       device="cpu")
    s.init_training()
    return s


def _batches():
    gen = torch.Generator().manual_seed(0)
    shape = (CRITICS, 2, 32, 32, 3)
    return {"bg": torch.rand(shape, generator=gen) * 2 - 1,
            "df": torch.rand(shape, generator=gen) * 2 - 1,
            "df_labels": torch.eye(4)[torch.randint(0, 4, (CRITICS, 2),
                                                    generator=gen)]}


class _Counted:
    """Stands in for a class, counting how often it is made."""

    def __init__(self, real, counts, key):
        self.real, self.counts, self.key = real, counts, key

    def __call__(self, *args, **kw):
        self.counts[self.key] += 1
        return self.real(*args, **kw)


class _FakeEvent:
    """A CUDA timing event on a made-up device clock that ticks 1 ms a
    record."""

    clock = itertools.count()

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self, stream=None):
        self.t = float(next(self.clock))

    def elapsed_time(self, end):
        return end.t - self.t


def _fake_card(monkeypatch, capturing=False):
    """CUDA in use, with events on the made-up clock; returns the count of
    events made."""
    counts = {"event": 0}
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "Event",
                        _Counted(_FakeEvent, counts, "event"))
    return counts


def test_off_records_nothing_and_opens_nothing(monkeypatch, steps):
    counts = _fake_card(monkeypatch)
    counts["range"] = 0
    monkeypatch.setattr(torch.profiler, "record_function", _Counted(
        torch.profiler.record_function, counts, "range"))
    steps.super_step(_batches())
    assert counts == {"event": 0, "range": 0}
    assert profiling.report() == {} and profiling.records() == []
    # off, every span is the one shared no-op context: nothing is made
    assert profiling.span("a") is profiling.span("b")
    # the same patches see a recording span take its events, and open its
    # range inside a profiler, where the range has a reader
    with profiling.recording(), profiling.span("on"):
        pass
    assert counts == {"event": 2, "range": 0}
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.span("profiled"):
            pass
    assert counts == {"event": 4, "range": 1}


@pytest.mark.parametrize("mode", ["profiler", "recording"])
def test_super_step_records_the_span_tree(mode, steps):
    if mode == "profiler":
        on = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU])
    else:
        on = profiling.recording()
    with on:
        steps.super_step(_batches())
    recs = profiling.records()
    roots = [r["name"] for r in recs if r["parent"] is None]
    assert roots == ["train.super_step"]
    by_id = {r["id"]: r for r in recs}
    root = recs[0]["id"]
    assert all(r["root"] == root for r in recs)
    parents = {"train.d_step": {"train.super_step"},
               "train.g_step": {"train.super_step"},
               "train.backward": {"train.d_step", "train.g_step"},
               "optim.step": {"train.d_step", "train.g_step"}}
    for r in recs[1:]:
        assert by_id[r["parent"]]["name"] in parents[r["name"]], r
    report = profiling.report()
    assert {k: v["count"] for k, v in report.items()} == TABLE
    # each D update: one backward, one update; the G update: one, two
    kids = {r["id"]: [] for r in recs}
    for r in recs[1:]:
        kids[r["parent"]].append(r["name"])
    for r in recs:
        if r["name"] == "train.d_step":
            assert kids[r["id"]] == ["train.backward", "optim.step"]
        if r["name"] == "train.g_step":
            assert kids[r["id"]] == ["train.backward", "optim.step", "optim.step"]


def test_self_time_never_exceeds_duration(monkeypatch, steps):
    with profiling.recording():
        steps.super_step(_batches())
    for name, e in profiling.report().items():
        assert 0 <= e["self_host_ms"] <= e["host_ms"], name
        assert e["device_ms"] is None and e["self_device_ms"] is None
    profiling.reset()
    _fake_card(monkeypatch)
    with profiling.recording():
        steps.super_step(_batches())
    report = profiling.report()
    for name, e in report.items():
        assert 0 <= e["self_device_ms"] <= e["device_ms"], name
    # the root covers both updates and its own glue
    top = report["train.super_step"]
    assert top["device_ms"] == pytest.approx(
        report["train.d_step"]["device_ms"] + report["train.g_step"]["device_ms"]
        + top["self_device_ms"])


@pytest.mark.parametrize("capturing", [False, True])
def test_device_clock_from_events_on_the_stream(monkeypatch, capturing):
    counts = _fake_card(monkeypatch, capturing)
    with profiling.recording():
        with profiling.span("a"):
            with profiling.span("b"):
                pass
            with profiling.span("c"):
                pass
    report = profiling.report()
    if capturing:
        # a graph being captured takes no events: no device time
        assert counts["event"] == 0
        assert all(e["device_ms"] is None for e in report.values())
        return
    # a0 b0 b1 c0 c1 a1 on the made-up clock
    assert counts["event"] == 6
    assert report["a"]["device_ms"] == 5 and report["a"]["self_device_ms"] == 3
    assert report["b"]["device_ms"] == report["c"]["device_ms"] == 1
    recs = {r["name"]: r for r in profiling.records()}
    assert recs["c"]["device_start_ms"] - recs["a"]["device_start_ms"] == 3


def test_counter_deltas_land_on_the_enclosing_spans():
    reg = profiling.Registry()
    n = [0]
    reg.register_counter("n", lambda: n[0])
    with reg.recording():
        with reg.span("outer"):
            n[0] += 1
            with reg.span("inner"):
                n[0] += 2
        n[0] += 4
        with reg.span("after"):
            pass
    report = reg.report()
    assert {k: v["counters"] for k, v in report.items()} == {
        "inner": {"n": 2}, "outer": {"n": 3}, "after": {"n": 0}}


def test_norm_launches_source_reads_both_kernels(monkeypatch):
    assert "norm.launches" in profiling.REGISTRY.sources
    monkeypatch.setattr(norm_kernels, "LAUNCHES", 10)
    monkeypatch.setattr(norm_kernels, "BWD_LAUNCHES", 3)
    with profiling.recording(), profiling.span("s"):
        monkeypatch.setattr(norm_kernels, "LAUNCHES", 66)
        monkeypatch.setattr(norm_kernels, "BWD_LAUNCHES", 19)
    assert profiling.report()["s"]["counters"]["norm.launches"] == 72


def test_cap_drops_and_counts():
    reg = profiling.Registry(cap=3)
    with reg.recording():
        for i in range(5):
            with reg.span(f"s{i}"):
                pass
    assert [r["name"] for r in reg.records()] == ["s0", "s1", "s2"]
    assert reg.dropped() == 2
    reg.reset()
    assert reg.records() == [] and reg.dropped() == 0


def test_recording_nests_and_ends():
    reg = profiling.Registry()
    off = reg.span("x")
    with reg.recording():
        with reg.recording():
            assert reg.span("x") is not off
        assert reg.span("x") is not off
    assert reg.span("x") is off


def test_each_thread_keeps_its_own_parents():
    reg = profiling.Registry()
    seen = []

    def other():
        with reg.span("other"):
            pass
        seen.append(True)

    with reg.recording(), reg.span("main"):
        t = threading.Thread(target=other)
        t.start()
        t.join(timeout=30)
    assert seen and not t.is_alive()
    recs = {r["name"]: r for r in reg.records()}
    assert recs["other"]["parent"] is None
    assert recs["other"]["root"] == recs["other"]["id"] != recs["main"]["root"]


def test_trace_writes_spans_beside_the_chrome_trace(tmp_path):
    with profiling.recording(), profiling.span("before"):
        pass
    with profiling.trace(tmp_path / "t"):
        with profiling.span("outer"), profiling.span("inner"):
            torch.ones(8, 8).matmul(torch.ones(8, 8))
    spans = json.loads((tmp_path / "t" / "spans.json").read_text())
    assert [r["name"] for r in spans["records"]] == ["outer", "inner"]
    assert sorted(spans["report"]) == ["inner", "outer"]
    assert spans["dropped"] == 0
    trace = json.loads((tmp_path / "t" / "trace.json").read_text())
    annotations = {e["name"] for e in trace["traceEvents"]
                   if e.get("cat") == "user_annotation"}
    assert {"outer", "inner"} <= annotations


def _reader(name):
    return spec.metric_reader(name)


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_value_from_a_report(name, monkeypatch):
    monkeypatch.setattr(profiling, "report", lambda: REPORT)
    assert _reader(name)(SUMMARY) == pytest.approx(READERS[name])


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_none_without_a_registry(name, monkeypatch):
    monkeypatch.delattr(profiling, "report")
    assert _reader(name)(SUMMARY) is None


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_none_without_records(name, monkeypatch):
    assert _reader(name)(SUMMARY) is None
    monkeypatch.setattr(profiling, "report", lambda: REPORT)
    assert _reader(name)(dict(SUMMARY, mode="serve")) is None


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_raises_on_a_count_mismatch(name, monkeypatch):
    monkeypatch.setattr(profiling, "report", lambda: REPORT)
    with pytest.raises(ValueError, match="2 train.super_step spans"):
        _reader(name)(dict(SUMMARY, traced_steps=3))


def test_benchmark_file_has_no_problems():
    bench = spec.benchmark()
    assert spec.problems(bench) == []
    names = {m["name"] for m in bench["per_layer"]}
    assert set(READERS) <= names


def test_the_port_traces_through_one_module():
    """No profiler range outside ``utils/profiling.py``; the seven ranges
    that were there keep their names as spans."""
    pkg = ROOT / "de_i2i_gan_torch"
    sources = {p: p.read_text() for p in pkg.rglob("*.py")}
    outside = [str(p) for p, s in sources.items()
               if "record_function" in s and p.name != "profiling.py"]
    assert outside == []
    opened = set(re.findall(r'profiling\.span\("([^"]+)"\)',
                            "".join(sources.values())))
    assert set(MIGRATED) | set(TABLE) <= opened
