"""The host logic of DefectGAN's graphed super-step (``train/graphed.py``)
on the CPU: which calls engage a graph, and what a replay advances on the
host. ``tests/torch_fake_graph.py`` stands in for the CUDA graph (its
capture runs nothing that stays, its replay reruns the body on the static
inputs), so every number here is the CPU's; ``tests/test_torch_graph_gpu.py``
holds the real graph against eager on the card."""
import pytest
import torch

from de_i2i_gan_torch.config import DefectGanConfig, TrainConfig
from de_i2i_gan_torch.ops.cuda import norm_kernels
from de_i2i_gan_torch.train import graphed
from de_i2i_gan_torch.train.jax_import import init_weights
from de_i2i_gan_torch.train.steps import DefectGanSteps
from de_i2i_gan_torch.utils import profiling
import torch_fake_graph

torch.set_num_threads(1)

CRITICS = 3
CFG = DefectGanConfig(image_size=16, label_nc=4, ngf=8, ndf=8, num_res=2,
                      num_scales=1, hidden_nc=16, num_layers=2,
                      style_norm_block_type="adain")
# 2 D updates an epoch and 4 epochs of the step schedule: the learning rate
# moves between two critics of the second and the third super-step; it
# halves an epoch from a power of 2, so a float32 slot holds it exactly and
# the graph path's weights equal eager's bit for bit
SCHED = dict(iters_per_epoch=2, num_epochs=4)
LR = dict(lr=(2.0 ** -12,), lr_decay=2.0 ** -4)


def _steps(cfg=CFG, **train):
    s = DefectGanSteps(cfg, TrainConfig(batch_size=2, num_critics=CRITICS,
                                        **LR, **train), device="cpu", **SCHED)
    s.init_training()
    init_weights(s, 0)
    return s


def _batches(seed, batch=2):
    gen = torch.Generator().manual_seed(seed)
    shape = (CRITICS, batch, 16, 16, 3)
    return {"bg": torch.rand(shape, generator=gen) * 2 - 1,
            "df": torch.rand(shape, generator=gen) * 2 - 1,
            "df_labels": torch.eye(4)[torch.randint(0, 4, (CRITICS, batch),
                                                    generator=gen)]}


def _eager(steps, batches, generator=None):
    d = [steps.d_step({k: v[i] for k, v in batches.items()}, generator)
         for i in range(CRITICS)]
    out = {k: torch.stack([m[k] for m in d]).mean() for k in d[0]}
    out.update(steps.g_step({k: v[-1] for k, v in batches.items()}, generator))
    return out


def _params(steps):
    return {f"{n}.{k}": v.detach().clone() for n in ("G", "E", "D")
            for k, v in getattr(steps, n).named_parameters()}


def _counts(steps):
    return {"step": steps.step, **{n: getattr(steps, f"tx_{n}").count
                                   for n in ("D", "G", "E")}}


def _equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.fixture
def counting_launches(monkeypatch):
    """Each D update counts 2 forward launches, each G update 4 and 4
    backward, as the norm kernels would on the card."""
    d_step, g_step = DefectGanSteps.d_step, DefectGanSteps.g_step

    def d(self, *a, **kw):
        norm_kernels.LAUNCHES += 2
        return d_step(self, *a, **kw)

    def g(self, *a, **kw):
        norm_kernels.LAUNCHES += 4
        norm_kernels.BWD_LAUNCHES += 4
        return g_step(self, *a, **kw)

    monkeypatch.setattr(DefectGanSteps, "d_step", d)
    monkeypatch.setattr(DefectGanSteps, "g_step", g)
    return 3 * 2 + 4 + 4


class _Source:
    """A noise source that is no torch.Generator (``nn/layers.py::randn``
    takes one)."""


@pytest.mark.parametrize("case, engaged", [
    ("cuda_only", False), ("engaged", True), ("dp_group", False),
    ("remat", False), ("sgd", False), ("cpu_generator", False),
    ("noise_source", False)])
def test_the_rule_that_engages_a_graph(monkeypatch, case, engaged):
    if case != "cuda_only":
        torch_fake_graph.install(monkeypatch)
    steps = _steps(CFG.replace(remat=case == "remat"),
                   optimizer="sgd" if case == "sgd" else "adam")
    if case == "dp_group":
        steps.dp_group = object()
    generator = {"cpu_generator": torch.Generator().manual_seed(0),
                 "noise_source": _Source()}.get(case)
    assert graphed.eligible(steps, generator) is engaged


@pytest.mark.parametrize("case", ["cpu", "dp_group", "generator", "shape"])
def test_calls_that_stay_eager_equal_d_and_g_steps(monkeypatch, case):
    """The CPU, a process group, a generator no graph can register and a
    batch shape's first call each run the eager body: the counter of eager
    super-steps moves, no graph replays, and the losses and weights equal
    ``d_step`` and ``g_step`` called in turn."""
    if case != "cpu":
        torch_fake_graph.install(monkeypatch)
    steps, twin = _steps(), _steps()
    generator = twin_gen = None
    if case == "dp_group":
        steps.dp_group = twin.dp_group = object()
    if case == "generator":
        generator = torch.Generator().manual_seed(1)
        twin_gen = torch.Generator().manual_seed(1)
    calls = [_batches(0), _batches(1), _batches(2)]
    if case == "shape":
        # two calls of a shape: eager, then the graph; a new shape stays
        # eager on every call, since the steps hold one graph
        torch.manual_seed(3)
        steps.super_step(calls[0])
        steps.super_step(calls[1])
        torch.manual_seed(3)
        _eager(twin, calls[0])
        _eager(twin, calls[1])
        calls = [_batches(4, batch=1), _batches(5, batch=1)]
    eager, replays = graphed.EAGER, graphed.REPLAYS
    for batches in calls:
        torch.manual_seed(5)
        got = steps.super_step(batches, generator)
        torch.manual_seed(5)
        want = _eager(twin, batches, twin_gen)
        _equal(got, want)
    assert graphed.EAGER - eager == len(calls)
    assert graphed.REPLAYS == replays
    assert _counts(steps) == _counts(twin)
    _equal(_params(steps), _params(twin))


def test_replays_advance_the_host_as_eager(monkeypatch, counting_launches):
    """4 super-steps (eager, capture and replay, 2 replays) against the
    eager twin: ``steps.step`` and each optimizer's count, the learning
    rate each update reads (the schedule moves between two critics), the
    norm launches (the capture's counted once, then once a replay), the
    two counters, the losses and the weights; every returned dict keeps its
    values."""
    torch_fake_graph.install(monkeypatch)
    steps, twin = _steps(), _steps()
    eager, replays = graphed.EAGER, graphed.REPLAYS
    outs = []
    for i in range(4):
        batches = _batches(i)
        before = _counts(steps)
        lrs = ([steps.tx_D.schedule(before["D"] + j) for j in range(CRITICS)]
               + [steps.tx_G.schedule(before["G"]),
                  steps.tx_E.schedule(before["E"])])
        launches = norm_kernels.LAUNCHES + norm_kernels.BWD_LAUNCHES
        torch.manual_seed(i)
        got = steps.super_step(batches)
        assert (norm_kernels.LAUNCHES + norm_kernels.BWD_LAUNCHES - launches
                == counting_launches)
        torch.manual_seed(i)
        want = _eager(twin, batches)
        assert _counts(steps) == _counts(twin) == {
            "step": before["step"] + CRITICS, "D": before["D"] + CRITICS,
            "G": before["G"] + 1, "E": before["E"] + 1}
        if i:
            g = steps._graph.graph
            assert [float(v) for v in g.scalars] == lrs
            assert (len(set(lrs[:CRITICS])) > 1) == (i < 3)
        _equal(got, want)
        outs.append((got, {k: v.clone() for k, v in got.items()}))
    assert graphed.EAGER - eager == 1 and graphed.REPLAYS - replays == 3
    for got, first in outs:
        _equal(got, first)
    _equal(_params(steps), _params(twin))


def test_every_registered_host_count_advances_once_a_replay(monkeypatch):
    """Each D update adds 1 and each G update 2 to every count registered
    with ``profiling.register_host_counts`` (the norm kernels' and one
    registered here): over 4 super-steps (eager, capture and replay, 2
    replays) each moves as the eager twin's does, by 5 a super-step, and so
    does every counter source the spans read but the graph path's own two.
    A count the module registers is re-added without an edit to
    ``graphed``."""
    torch_fake_graph.install(monkeypatch)
    for name in ("LAUNCHES", "BWD_LAUNCHES"):
        monkeypatch.setattr(norm_kernels, name, 0)
    monkeypatch.setattr(norm_kernels, "TIER_LAUNCHES", {
        op: dict.fromkeys(tiers, 0)
        for op, tiers in norm_kernels.TIER_LAUNCHES.items()})
    monkeypatch.setattr(norm_kernels, "SPLIT_LAUNCHES",
                        dict.fromkeys(norm_kernels.SPLIT_LAUNCHES, 0))
    extra = {"a": 0, "b": 0}

    def add(delta):
        for k, v in delta.items():
            extra[k] += v

    monkeypatch.setitem(profiling.REGISTRY.host, "test.extra",
                        (lambda: dict(extra), add))
    monkeypatch.setitem(profiling.REGISTRY.sources, "test.extra",
                        lambda: extra["a"] + extra["b"])
    d_step, g_step = DefectGanSteps.d_step, DefectGanSteps.g_step

    def bump(n):
        profiling.add_host_counts({
            name: dict.fromkeys(counts, n)
            for name, counts in profiling.host_counts().items()})

    def d(self, *a, **kw):
        bump(1)
        return d_step(self, *a, **kw)

    def g(self, *a, **kw):
        bump(2)
        return g_step(self, *a, **kw)

    monkeypatch.setattr(DefectGanSteps, "d_step", d)
    monkeypatch.setattr(DefectGanSteps, "g_step", g)
    assert {"norm_kernels", "test.extra"} <= set(profiling.REGISTRY.host)
    sources = {k: read for k, read in profiling.REGISTRY.sources.items()
               if k not in ("train.graph_replays", "train.eager_super_steps")}

    def read():
        host = {(name, k): v for name, counts in profiling.host_counts().items()
                for k, v in counts.items()}
        return {**host, **{k: r() for k, r in sources.items()}}

    def moved(after, before):
        return {k: v - before[k] for k, v in after.items()}

    steps, twin = _steps(), _steps()
    replays = graphed.REPLAYS
    for i in range(4):
        batches = _batches(i)
        before = read()
        torch.manual_seed(i)
        steps.super_step(batches)
        mid = read()
        torch.manual_seed(i)
        _eager(twin, batches)
        graph, eager = moved(mid, before), moved(read(), mid)
        assert graph == eager, i
        assert all(v == CRITICS + 2 for k, v in eager.items()
                   if isinstance(k, tuple)), eager
        assert eager["test.extra"] == 2 * (CRITICS + 2)
        assert eager["norm.launches"] == 2 * (CRITICS + 2)
    assert graphed.REPLAYS - replays == 3
