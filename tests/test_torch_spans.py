"""The port's span and counter registry (``utils/profiling.py``), the spans
on DefectGAN's super-step, eager and replayed as a graph
(``train/graphed.py``), and the benchmark's per-layer metrics that read
them (``perfbench/metrics``), on the CPU. The device clock is exercised with
stand-in CUDA events, the graph with ``tests/torch_fake_graph.py``;
``tests/test_torch_kernel_gpu.py`` and the ``gpu`` test here hold them on
the card."""
import itertools
import json
import re
import threading
from pathlib import Path

import pytest
import torch

from de_i2i_gan_torch.config import DefectGanConfig, TrainConfig
from de_i2i_gan_torch.ops.cuda import norm_kernels
from de_i2i_gan_torch.train import graphed
from de_i2i_gan_torch.train.steps import DefectGanSteps
from de_i2i_gan_torch.utils import profiling
from perfbench.lib import spec
import torch_fake_graph

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
           "kernel.norm_launches_per_step.train": 72.0,
           "host.graph_replay_pct.train": 50.0}
REPORT = {"train.super_step": {"count": 2, "device_ms": 460.0,
                               "counters": {"norm.launches": 144,
                                            "train.graph_replays": 1,
                                            "train.eager_super_steps": 1}},
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


def _count_launches(monkeypatch, steps, per_d=8, per_g=16):
    """The CPU path launches no kernel: each of D's updates counts
    ``per_d`` launches, each of G's and E's ``per_g`` (inside the update
    spans, as the norm kernels count theirs on the card)."""
    from de_i2i_gan_torch.train.optim import Optimizer

    step = Optimizer.step

    def counted(self, grads):
        norm_kernels.LAUNCHES += per_d if self is steps.tx_D else per_g
        return step(self, grads)

    monkeypatch.setattr(Optimizer, "step", counted)
    return CRITICS * per_d + 2 * per_g


def test_replayed_super_step_keeps_the_tree_and_the_counters(monkeypatch):
    """Through the stand-in graph: the eager first call, the capture (which
    records into its own list) and three replays, the last two recorded. A
    replay keeps the eager tree under its root; its ``norm.launches`` are
    the captured launches once, not twice; ``train.graph_replays`` counts 1
    a replay and ``train.eager_super_steps`` 1 an eager call."""
    torch_fake_graph.install(monkeypatch)
    cfg = DefectGanConfig(image_size=32, label_nc=4, ngf=8, ndf=8, num_res=2,
                          hidden_nc=16, num_layers=2,
                          style_norm_block_type="adain")
    s = DefectGanSteps(cfg, TrainConfig(batch_size=2, num_critics=CRITICS),
                       device="cpu")
    s.init_training()
    per_step = _count_launches(monkeypatch, s)
    launches = norm_kernels.LAUNCHES + norm_kernels.BWD_LAUNCHES
    with profiling.recording():
        s.super_step(_batches())
    eager = profiling.report()["train.super_step"]["counters"]
    assert eager["train.eager_super_steps"] == 1
    assert eager["train.graph_replays"] == 0
    assert eager["norm.launches"] == per_step
    s.super_step(_batches())  # the capture and its first replay
    profiling.reset()
    with profiling.recording():
        for _ in range(2):
            s.super_step(_batches())
    assert (norm_kernels.LAUNCHES + norm_kernels.BWD_LAUNCHES - launches
            == 4 * per_step)
    report = profiling.report()
    assert {k: v["count"] for k, v in report.items()} == {
        k: 2 * n for k, n in TABLE.items()}
    root = report["train.super_step"]["counters"]
    assert root == {"norm.launches": 2 * per_step, "pad.launches": 0,
                    "conv.double_backward": 0,
                    "train.graph_replays": 2, "train.eager_super_steps": 0}
    assert report["train.d_step"]["counters"]["norm.launches"] == 2 * CRITICS * 8
    assert report["train.g_step"]["counters"]["norm.launches"] == 2 * 2 * 16
    recs = profiling.records()
    by_id = {r["id"]: r for r in recs}
    roots = [r for r in recs if r["parent"] is None]
    assert [r["name"] for r in roots] == ["train.super_step"] * 2
    kids = {r["id"]: [] for r in recs}
    for r in recs:
        if r["parent"] is not None:
            kids[r["parent"]].append(r["name"])
            assert by_id[r["root"]]["parent"] is None
            assert r["host_ms"] == 0 and r["device_ms"] is None
    for r in roots:
        assert kids[r["id"]] == ["train.d_step"] * CRITICS + ["train.g_step"]
    for r in recs:
        if r["name"] == "train.d_step":
            assert kids[r["id"]] == ["train.backward", "optim.step"]
        if r["name"] == "train.g_step":
            assert kids[r["id"]] == ["train.backward", "optim.step", "optim.step"]


def test_replayed_spans_read_the_graph_events_after_their_anchor(
        monkeypatch):
    """``replayed`` on a made-up device clock: a record's start is the
    anchor's place plus the graph event's offset from it, its ms the graph
    events' difference."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    reg = profiling.Registry()
    clock = {}

    class Ev:
        def __init__(self, t):
            self.t = t

        def record(self, stream=None):
            pass

        def elapsed_time(self, end):
            return end.t - self.t

    with reg.captured() as spans:
        with reg.span("outer"):
            with reg.span("inner"):
                pass
    assert reg.records() == []
    spans[0].events, spans[1].events = (Ev(12.0), Ev(13.5)), (Ev(10.0), Ev(20.0))
    spans[0].counters, spans[1].counters = {"n": 2}, {"n": 5}
    assert [s.name for s in spans] == ["inner", "outer"]
    clock["ref"] = Ev(1.0)  # the registry's zero: the root's start
    with reg.recording(), reg.span("root") as root:
        root.events = (clock["ref"], Ev(30.0))
        reg.replayed(spans, Ev(7.0))
    recs = {r["name"]: r for r in reg.records()}
    assert recs["outer"]["parent"] == recs["root"]["id"]
    assert recs["inner"]["parent"] == recs["outer"]["id"]
    assert recs["inner"]["root"] == recs["outer"]["root"] == recs["root"]["id"]
    assert recs["outer"]["device_start_ms"] == (7.0 - 1.0) + (10.0 - 7.0)
    assert recs["outer"]["device_ms"] == 10.0
    assert recs["inner"]["device_start_ms"] == (7.0 - 1.0) + (12.0 - 7.0)
    assert recs["inner"]["device_ms"] == 1.5
    assert recs["inner"]["counters"] == {"n": 2}
    assert recs["outer"]["host_ms"] == 0.0
    # off, a replay records nothing
    reg.replayed(spans, Ev(40.0))
    assert len(reg.records()) == 3


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["recording", "profiler"])
def test_replayed_super_step_spans_on_the_card(mode):
    """The benchmark's depth (6 residual blocks, 2 scales, 5 critics: 72
    norm launches a super-step) at tiny widths, on the card: two replayed
    super-steps recorded, each with the eager tree of spans, every span's
    device ms above 0 and inside its parent's, ``norm.launches`` 72 a
    replay."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = DefectGanConfig(image_size=32, label_nc=6, ngf=8, ndf=8, num_res=6,
                          num_scales=2, hidden_nc=16, num_layers=2,
                          style_norm_block_type="adain", use_pallas=True)
    s = DefectGanSteps(cfg, TrainConfig(batch_size=2, num_critics=5),
                       device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(3)
    shape = (5, 2, 32, 32, 3)
    batches = {"bg": torch.rand(shape, generator=gen, device="cuda") * 2 - 1,
               "df": torch.rand(shape, generator=gen, device="cuda") * 2 - 1,
               "df_labels": torch.eye(6, device="cuda")[torch.randint(
                   0, 6, (5, 2), generator=gen, device="cuda")]}
    s.super_step(batches)
    s.super_step(batches)  # the capture and its first replay
    torch.cuda.synchronize()
    launches = norm_kernels.LAUNCHES + norm_kernels.BWD_LAUNCHES
    replays = graphed.REPLAYS
    on = (profiling.recording() if mode == "recording" else
          torch.profiler.profile(activities=[
              torch.profiler.ProfilerActivity.CPU,
              torch.profiler.ProfilerActivity.CUDA]))
    with on:
        for _ in range(2):
            s.super_step(batches)
        torch.cuda.synchronize()
    assert norm_kernels.LAUNCHES + norm_kernels.BWD_LAUNCHES - launches == 144
    assert graphed.REPLAYS - replays == 2
    report = profiling.report()
    recs = profiling.records()
    assert {k: v["count"] for k, v in report.items()} == {
        "train.super_step": 2, "train.d_step": 10, "train.g_step": 2,
        "train.backward": 12, "optim.step": 14}
    assert report["train.super_step"]["counters"] == {
        "norm.launches": 144, "train.graph_replays": 2,
        "train.eager_super_steps": 0}
    assert report["train.d_step"]["counters"]["norm.launches"] == 80
    by_id = {r["id"]: r for r in recs}
    for r in recs:
        assert r["device_ms"] is not None and r["device_ms"] > 0, r
        if r["parent"] is not None:
            p = by_id[r["parent"]]
            assert r["device_start_ms"] >= p["device_start_ms"] - 1e-3, r
            assert (r["device_start_ms"] + r["device_ms"]
                    <= p["device_start_ms"] + p["device_ms"] + 1e-3), r
    for e in report.values():
        assert 0 <= e["self_device_ms"] <= e["device_ms"]
    assert (report["train.d_step"]["device_ms"] + report["train.g_step"]["device_ms"]
            <= report["train.super_step"]["device_ms"] + 1e-3)


def test_adding_to_a_dropped_host_count_registration_raises():
    """A count dropped while a graph still holds its difference is an
    error: a replay would otherwise stop advancing it without a word."""
    reg = profiling.Registry()
    n = {"calls": 0}

    def add(delta):
        n["calls"] += delta["calls"]

    reg.register_host_counts("block", lambda: dict(n), add)
    delta = {"block": {"calls": 3}}
    reg.add_host_counts(delta)
    assert reg.host_counts() == {"block": {"calls": 3}}
    del reg.host["block"]
    with pytest.raises(KeyError):
        reg.add_host_counts(delta)
    assert n == {"calls": 3}


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
