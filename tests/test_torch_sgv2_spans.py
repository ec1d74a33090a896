"""The spans inside StarGAN v2's ``StarGANv2Solver.train_step`` (AdaIN),
their counts an iteration, the norm launches they see, that nothing records
outside a profiler or ``profiling.recording()``, and that recording leaves
the arithmetic as it is, on the CPU (``test_torch_spans.py`` holds the
registry itself), and the cell's per-layer metrics that read them."""
import pytest
import torch

from de_i2i_gan_torch.models import starganv2
from de_i2i_gan_torch.ops.cuda import norm_kernels
from de_i2i_gan_torch.train.solver import StarGANv2Config, StarGANv2Solver
from de_i2i_gan_torch.utils import profiling
from perfbench.lib import spec

torch.set_num_threads(1)

IMG, BATCH = 32, 2
CFG = StarGANv2Config(img_size=IMG, num_domains=3, latent_dim=4, style_dim=8,
                      max_conv_dim=32, w_hpf=0.0, batch_size=BATCH)
# the spans of an iteration, and how many of each one records
TABLE = {"train.super_step": 1, "train.d_step": 2, "train.g_step": 2,
         "sgv2.r1": 2, "train.backward": 4, "sgv2.ema": 1, "optim.step": 6}
PARENTS = {"train.d_step": "train.super_step", "train.g_step": "train.super_step",
           "sgv2.ema": "train.super_step", "sgv2.r1": "train.d_step",
           "train.backward": ("train.d_step", "train.g_step"),
           "optim.step": ("train.d_step", "train.g_step")}


@pytest.fixture(autouse=True)
def empty_registry():
    profiling.reset()
    yield
    profiling.reset()


def _solver(seed: int = 0) -> StarGANv2Solver:
    torch.manual_seed(seed)
    s = StarGANv2Solver(CFG, device="cpu")
    s.init_training()
    return s


def _batch():
    gen = torch.Generator().manual_seed(1)

    def imgs():
        return torch.rand((BATCH, IMG, IMG, 3), generator=gen) * 2 - 1

    return {"x_src": imgs(), "x_ref": imgs(), "x_ref2": imgs(),
            "y_src": torch.tensor([0, 1]), "y_ref": torch.tensor([2, 0]),
            "z_ref": torch.randn((BATCH, 4), generator=gen),
            "z_ref2": torch.randn((BATCH, 4), generator=gen)}


@pytest.mark.parametrize("mode", ["profiler", "recording"])
def test_iteration_records_the_span_table(mode):
    s = _solver()
    on = (torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
          if mode == "profiler" else profiling.recording())
    with on:
        s.train_step(_batch())
    recs = profiling.records()
    assert [r["name"] for r in recs if r["parent"] is None] == ["train.super_step"]
    assert {k: v["count"] for k, v in profiling.report().items()} == TABLE
    by_id = {r["id"]: r for r in recs}
    kids = {r["id"]: [] for r in recs}
    for r in recs[1:]:
        parent = by_id[r["parent"]]["name"]
        assert parent in PARENTS[r["name"]], r
        kids[r["parent"]].append(r["name"])
    # D: R1 inside the loss, then the backward and the update; G latent:
    # G's, M's and S's updates; G reference: G's
    steps = [kids[r["id"]] for r in recs
             if r["name"] in ("train.d_step", "train.g_step")]
    d = ["sgv2.r1", "train.backward", "optim.step"]
    assert steps == [d, d, ["train.backward"] + ["optim.step"] * 3,
                     ["train.backward", "optim.step"]]
    assert kids[recs[0]["id"]][-1] == "sgv2.ema"


def test_nothing_records_outside_a_profiler_or_recording(monkeypatch):
    counts = {"range": 0}
    real = torch.profiler.record_function

    def counted(*a, **kw):
        counts["range"] += 1
        return real(*a, **kw)

    monkeypatch.setattr(torch.profiler, "record_function", counted)
    _solver().train_step(_batch())
    assert counts["range"] == 0
    assert profiling.report() == {} and profiling.records() == []


def test_recording_leaves_the_arithmetic_as_it_is():
    a, b = _solver(), _solver()
    for (n, p), q in zip(a.G.named_parameters(), b.G.parameters()):
        assert torch.equal(p, q), n
    la = a.train_step(_batch())
    with profiling.recording():
        lb = b.train_step(_batch())
    assert profiling.report()["train.super_step"]["count"] == 1
    assert la.keys() == lb.keys()
    for k in la:
        assert torch.equal(la[k], lb[k]), k
    for name in ("G", "M", "S", "D", "ema_G", "ema_M", "ema_S"):
        for (n, p), q in zip(getattr(a, name).named_parameters(),
                             getattr(b, name).parameters()):
            assert torch.equal(p, q), f"{name}.{n}"
    for name in ("G", "M", "S", "D"):
        oa, ob = getattr(a, f"tx_{name}").opt, getattr(b, f"tx_{name}").opt
        for p, q in zip(oa.param_groups[0]["params"], ob.param_groups[0]["params"]):
            assert torch.equal(oa.state[p]["exp_avg_sq"], ob.state[q]["exp_avg_sq"])


def test_norm_launches_an_iteration(monkeypatch):
    """The CPU runs the norm's plain version: counted here as the kernels
    count on the card, a forward a call and a backward a call whose output
    takes a gradient. An iteration runs G 8 times, 4 of them with a
    backward, each through 2 norms a styled block: 144 at 256x256 (6
    blocks), 72 here (3)."""
    def counted(x, gamma, beta, act=None, eps=1e-5, use_kernel=True):
        norm_kernels.LAUNCHES += 1
        y = real(x, gamma, beta, act, eps, use_kernel)
        if y.requires_grad:
            y.register_hook(lambda g: _bwd())
        return y

    def _bwd():
        norm_kernels.BWD_LAUNCHES += 1

    real = starganv2.modulated_instance_norm
    monkeypatch.setattr(starganv2, "modulated_instance_norm", counted)
    monkeypatch.setattr(norm_kernels, "LAUNCHES", 0)
    monkeypatch.setattr(norm_kernels, "BWD_LAUNCHES", 0)
    s = _solver()
    blocks = 2 + len([n for n, _ in s.G.named_children()
                      if n.startswith("decode_") and "bottleneck" not in n])
    assert blocks == 3
    with profiling.recording():
        s.train_step(_batch())
    counters = profiling.report()["train.super_step"]["counters"]
    assert counters["norm.launches"] == (8 + 4) * 2 * blocks
    assert norm_kernels.BWD_LAUNCHES == 4 * 2 * blocks


# the cell's span and counter readers, and what each reads off REPORT: two
# recorded iterations
READERS = {"step.d_update_ms.sgv2": 350.0, "step.g_update_ms.sgv2": 500.0,
           "loss.r1_ms.sgv2": 18.0, "model.backward_ms.sgv2": 560.0,
           "kernel.norm_launches_per_step.sgv2": 144.0,
           "host.graph_replay_pct.sgv2": 100.0,
           "model.conv_double_backward_per_step.sgv2": 36.0}
REPORT = {"train.super_step": {"count": 2, "device_ms": 1800.0,
                               "counters": {"norm.launches": 288,
                                            "train.graph_replays": 2,
                                            "conv.double_backward": 72}},
          "train.d_step": {"count": 4, "device_ms": 700.0, "counters": {}},
          "train.g_step": {"count": 4, "device_ms": 1000.0, "counters": {}},
          "sgv2.r1": {"count": 4, "device_ms": 36.0, "counters": {}},
          "train.backward": {"count": 8, "device_ms": 1120.0, "counters": {}},
          "optim.step": {"count": 12, "device_ms": 40.0, "counters": {}}}
SUMMARY = {"mode": "train", "steps": 20, "seconds": 40.0, "traced_steps": 2,
           "flops_per_step": 2.1e13, "peak_flops_per_s": 9.89e14,
           "norm_bound_s_per_step": 1.6e-3,
           "trace": {"busy_s": 1.0, "window_s": 1.6, "norm_kernel_s": 4e-3}}


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_value_from_a_report(name, monkeypatch):
    monkeypatch.setattr(profiling, "report", lambda: REPORT)
    assert spec.metric_reader(name)(SUMMARY) == pytest.approx(READERS[name])


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_none_where_the_iteration_opens_no_root(name, monkeypatch):
    """A program whose iteration records other spans but no
    ``train.super_step`` (the port before these spans) reads nothing, and
    a program without the registry neither."""
    no_root = {k: v for k, v in REPORT.items() if k != "train.super_step"}
    monkeypatch.setattr(profiling, "report", lambda: no_root)
    assert spec.metric_reader(name)(SUMMARY) is None
    monkeypatch.delattr(profiling, "report")
    assert spec.metric_reader(name)(SUMMARY) is None


def test_conv_reader_none_without_the_counter(monkeypatch):
    """A program without the counter source ``conv.double_backward`` (the
    port before ``nn/conv_grad.py``) reads nothing."""
    root = dict(REPORT["train.super_step"], counters={"norm.launches": 288})
    monkeypatch.setattr(profiling, "report",
                        lambda: dict(REPORT, **{"train.super_step": root}))
    read = spec.metric_reader("model.conv_double_backward_per_step.sgv2")
    assert read(SUMMARY) is None


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_raises_on_a_count_mismatch(name, monkeypatch):
    monkeypatch.setattr(profiling, "report", lambda: REPORT)
    with pytest.raises(ValueError, match="2 train.super_step spans"):
        spec.metric_reader(name)(dict(SUMMARY, traced_steps=3))


@pytest.mark.parametrize("name", ["step.mfu", "kernel.norm_roofline_pct",
                                  "device.idle_pct"])
def test_trace_readers_read_as_the_train_cells(name):
    got = spec.metric_reader(f"{name}.sgv2")(SUMMARY)
    assert got is not None
    assert got == spec.metric_reader(f"{name}.train")(SUMMARY)


def test_the_cells_metrics_are_in_the_benchmark():
    bench = spec.benchmark()
    cell = "starganv2_afhq256.train_b8"
    names = {m["name"] for m in spec.metrics_of(bench, "per_layer", cell)}
    assert names == set(READERS) | {"step.mfu.sgv2",
                                    "kernel.norm_roofline_pct.sgv2",
                                    "device.idle_pct.sgv2"}
    assert not spec.problems(bench)
