"""The host logic of StarGAN v2's graphed iteration (``train/graphed.py``
through ``StarGANv2Solver.train_step``) on the CPU: which calls engage a
graph, that a replay reads ``lambda_ds`` and each learning rate from the
graph's slots, and what a replay advances on the host.
``tests/torch_fake_graph.py`` stands in for the CUDA graph (its capture
runs nothing that stays, its replay reruns the body on the static inputs,
each host float read from the slots), so every number here is the CPU's;
``tests/test_torch_graph_gpu.py`` holds the real graph against eager on the
card."""
import pytest
import torch

from de_i2i_gan_torch.ops.cuda import norm_kernels
from de_i2i_gan_torch.train import graphed
from de_i2i_gan_torch.train.solver import StarGANv2Config, StarGANv2Solver
import torch_fake_graph

torch.set_num_threads(1)

IMG, BATCH, ITERS = 32, 2, 4
# ds_iter 3: lambda_ds (2 at step 0) decays over the replays and reads 0 at
# the fourth iteration; the learning rates are powers of 2, so a float32
# slot holds them exactly and the graph path's weights equal eager's bit
# for bit (lambda_ds only scales a float32 loss, so float32 is its
# precision in either path)
CFG = StarGANv2Config(img_size=IMG, num_domains=3, latent_dim=4, style_dim=8,
                      max_conv_dim=32, w_hpf=0.0, batch_size=BATCH,
                      lambda_ds=2.0, ds_iter=3, lr=2.0 ** -13, f_lr=2.0 ** -20)
OPTIMIZERS = StarGANv2Solver.STATE_OPTIMIZERS
# updates an iteration: D and G on both passes, M and S on the latent one
UPDATES = {"G": 2, "D": 2, "M": 1, "S": 1}
# norm launches the stand-in counts: 2 a D update, 4 and 4 a G update
LAUNCHES = 2 * (2 + 4 + 4)


def _solver(cfg=CFG, seed=0):
    torch.manual_seed(seed)
    s = StarGANv2Solver(cfg, device="cpu")
    s.init_training()
    return s


def _batch(seed, batch=BATCH):
    gen = torch.Generator().manual_seed(seed)

    def imgs():
        return torch.rand((batch, IMG, IMG, 3), generator=gen) * 2 - 1

    return {"x_src": imgs(), "x_ref": imgs(), "x_ref2": imgs(),
            "y_src": torch.randint(0, 3, (batch,), generator=gen),
            "y_ref": torch.randint(0, 3, (batch,), generator=gen),
            "z_ref": torch.randn((batch, 4), generator=gen),
            "z_ref2": torch.randn((batch, 4), generator=gen)}


def _leaves(s):
    return {f"{n}.{k}": v.detach().clone() for n in StarGANv2Solver.STATE_NETS
            for k, v in getattr(s, n).state_dict().items()}


def _counts(s):
    return {"step": s.step, **{n: getattr(s, f"tx_{n}").count
                               for n in OPTIMIZERS}}


def _equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.fixture(scope="module")
def runs():
    """4 iterations on the graph path (eager, capture and replay, 2
    replays) and on an eager twin from the same weights and batches, each
    D update counting 2 norm launches and each G update 4 and 4, as the
    kernels would on the card. Per iteration: the returned dict and its
    values on return, the leaves after it, the counts and what moved."""
    with pytest.MonkeyPatch.context() as mp:
        torch_fake_graph.install(mp)
        d_step, g_step = StarGANv2Solver.d_step, StarGANv2Solver.g_step

        def d(self, *a, **kw):
            norm_kernels.LAUNCHES += 2
            return d_step(self, *a, **kw)

        def g(self, *a, **kw):
            norm_kernels.LAUNCHES += 4
            norm_kernels.BWD_LAUNCHES += 4
            return g_step(self, *a, **kw)

        mp.setattr(StarGANv2Solver, "d_step", d)
        mp.setattr(StarGANv2Solver, "g_step", g)
        graph, twin = _solver(), _solver()
        twin.graph_ready = lambda: False
        out = {"graph": [], "eager": []}
        for i in range(ITERS):
            batch = _batch(10 + i)
            for name, s in (("graph", graph), ("eager", twin)):
                before = (_counts(s), norm_kernels.LAUNCHES
                          + norm_kernels.BWD_LAUNCHES, graphed.REPLAYS,
                          graphed.EAGER)
                m = s.train_step(batch)
                after = (_counts(s), norm_kernels.LAUNCHES
                         + norm_kernels.BWD_LAUNCHES, graphed.REPLAYS,
                         graphed.EAGER)
                moved = {k: after[0][k] - before[0][k] for k in after[0]}
                moved.update(launches=after[1] - before[1],
                             replays=after[2] - before[2],
                             eager=after[3] - before[3])
                reads = []
                if s._graph.graph is not None:
                    fake = s._graph.graph.graph
                    reads, fake.reads = fake.reads, []
                out[name].append({"out": m, "values": {k: v.clone()
                                                       for k, v in m.items()},
                                  "leaves": _leaves(s), "counts": after[0],
                                  "moved": moved, "reads": reads})
        out["solver"], out["twin"] = graph, twin
    return out


def test_replayed_iterations_equal_eager(runs):
    """The losses and every leaf of the 7 nets (parameters and buffers)
    after each of the 4 iterations equal the eager twin's bit for bit, and
    every returned dict keeps its values."""
    assert runs["solver"]._graph.graph is not None
    for i, (g, e) in enumerate(zip(runs["graph"], runs["eager"])):
        _equal(g["out"], e["out"])
        _equal(g["leaves"], e["leaves"])
    assert {k.split(".")[0] for k in runs["graph"][-1]["leaves"]} == {
        "G", "D", "M", "S", "ema_G", "ema_M", "ema_S"}
    for g in runs["graph"]:
        _equal(g["out"], g["values"])


def test_lambda_ds_is_read_from_a_slot_each_replay(runs):
    """Each replay reads the G loss's ds weight twice (the latent and the
    reference pass) from the graph's slots, at the step of that iteration:
    eager's ``_lambda_ds(step)`` in float32, 0 at the fourth; and both
    learning rates of each update."""
    solver = runs["solver"]
    g = solver._graph.graph
    ds = [j for j, (index, _) in enumerate(g.slots)
          if graphed.schedules(solver)[index][1] == "_lambda_ds"]
    assert len(ds) == 2
    for i, it in enumerate(runs["graph"]):
        reads = [v for a, v in it["reads"] if a == "_lambda_ds"]
        if i == 0:
            assert reads == []  # eager
            continue
        want = torch.tensor([runs["twin"]._lambda_ds(i)] * 2).float()
        assert torch.equal(torch.tensor(reads).float(), want), i
        lrs = [v for a, v in it["reads"] if a == "schedule"]
        # D latent, D reference, G, M and S latent, G reference
        assert lrs == [CFG.lr] * 3 + [CFG.f_lr] + [CFG.lr] * 2, i
    assert reads == [0.0, 0.0]
    assert len(g.scalars) == len(g.slots)
    assert [float(g.scalars[j]) for j in ds] == [0.0, 0.0]


def test_replays_advance_the_host_as_eager(runs):
    """``step``, each optimizer's count, the norm launches (the capture's
    counted once, then once a replay) and the counters move by one
    iteration's worth on every call, as the eager twin's do."""
    for i, (g, e) in enumerate(zip(runs["graph"], runs["eager"])):
        assert g["counts"] == e["counts"] == {
            "step": i + 1, **{n: c * (i + 1) for n, c in UPDATES.items()}}
        want = {"step": 1, **UPDATES, "launches": LAUNCHES}
        assert {k: v for k, v in g["moved"].items() if k in want} == want
        assert {k: v for k, v in e["moved"].items() if k in want} == want
        assert (g["moved"]["replays"], g["moved"]["eager"]) == (
            (0, 1) if i == 0 else (1, 0))
        assert (e["moved"]["replays"], e["moved"]["eager"]) == (0, 1)


class _Fan:
    """A FAN stand-in: the solver only checks that one is attached."""


@pytest.mark.parametrize("case, calls, replays", [
    ("engaged", 3, 2), ("cpu", 3, 0), ("dp_group", 3, 0), ("sean", 3, 0),
    ("fan_heatmaps", 3, 0), ("masks", 3, 0), ("fused_prop", 3, 0),
    ("cpu_generator", 3, 0), ("capturing", 3, 0), ("shape", 4, 1)])
def test_calls_that_stay_eager(monkeypatch, case, calls, replays):
    """The rule that engages a graph, decided from the call: the CPU
    without the stand-in, a process group, SEAN, the FAN's heatmaps inside
    the iteration, masks in the batch (``w_hpf`` > 0), FusedProp, a
    generator no graph can register, a stream that is capturing already,
    and a batch shape other than the graph's each run eagerly; the body is
    a stub here, the routing is what is tested."""
    if case != "cpu":
        torch_fake_graph.install(monkeypatch)
    if case == "capturing":
        monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                            lambda: True)
    monkeypatch.setattr(StarGANv2Solver, "_super_step",
                        lambda self, batch, gen: {"x": batch["x_src"].mean()})
    monkeypatch.setattr(StarGANv2Solver, "_heatmaps",
                        lambda self, x: [x[..., :1], x[..., :1]])
    cfg = {"sean": CFG.replace(norm_type="sean", allow_degraded_losses=True),
           "fan_heatmaps": CFG.replace(w_hpf=1.0),
           "masks": CFG.replace(w_hpf=1.0, allow_degraded_losses=True),
           "fused_prop": CFG.replace(fused_prop=True)}.get(case, CFG)
    s = _solver(cfg)
    if case == "dp_group":
        s.dp_group = object()
    if case == "fan_heatmaps":
        s.fan = _Fan()
    generator = (torch.Generator().manual_seed(0) if case == "cpu_generator"
                 else None)
    batches = [_batch(i) for i in range(calls)]
    if case == "masks":
        for b in batches:
            b["masks"] = [b["x_src"][..., :1], b["x_src"][..., :1]]
    if case == "shape":
        batches[2:] = [_batch(2, batch=1), _batch(3, batch=1)]
    eager, replayed = graphed.EAGER, graphed.REPLAYS
    for b in batches:
        s.train_step(b, generator)
    assert graphed.REPLAYS - replayed == replays
    assert graphed.EAGER - eager == calls - replays
    assert s.step == calls
    assert (s._graph.graph is not None) == (replays > 0)
    assert graphed.eligible(s, generator) is (case in ("engaged", "shape"))
