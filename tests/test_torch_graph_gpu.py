"""DefectGAN's super-step and StarGAN v2's iteration replayed as one CUDA
graph (``train/graphed.py``) against the same steps run eagerly, on the card
(``gpu`` marker; skips without one). This file imports torch and the port
only. On the card:

    python -m pytest tests/test_torch_graph_gpu.py -m gpu --noconftest -q

Two ``DefectGanSteps`` from the same drawn weights (``init_weights``) take
the same batches and draw from equally seeded generators: one through
``super_step`` (its first call of a shape eager, its second captured and
replayed, later ones replayed), the other through ``d_step`` and ``g_step``
called eagerly. From its second super-step the eager twin's Adam takes the
capturable form the graph's does (``graphed.make_capturable``), so both run
one arithmetic; cuDNN is held deterministic, so that a gradient that is
zero in exact arithmetic rounds the same in both (Adam turns any such
rounding into a step of about lr). ``iters_per_epoch`` 3 with 4 epochs of
the step schedule moves the learning rate between two critics of a
super-step. The paths compute in float32, the precision these tolerances
were set in: in bfloat16 the atomic sums of aten's reflect-pad backward,
which the port's pad kernels have since replaced, made two eager runs
differ by more than them (the benchmark's check holds the bfloat16 graph
against the plain reference). The reflect pads run inside the capture as
the custom op of ``ops/cuda/pad_kernels.py``.

Tolerances, the super-step's of ``tests/test_torch_kernel_gpu.py``: each
step's losses within rtol 2e-4; each tensor's change over the steps
(parameters, BatchNorm's running statistics, SEAN's sums, spectral norm's
u and v, the EMA generator, Adam's moments) within 1e-3 of the eager
change's L2 norm plus 1e-5 per element in L2; Adam's step counts, the
optimizers' update counts and ``steps.step`` equal.

StarGAN v2 runs at the benchmark cell's shapes and precision (AFHQ, batch
8, 256², bf16), 3 iterations from one drawn Adam state: the graph path and
two eager runs of the same seed, the second of which sets the tolerance
(cuDNN is left as the cell runs it, so the eager runs differ by its own
spread).
"""
import pytest
import torch

from de_i2i_gan_torch.config import DefectGanConfig, TrainConfig
from de_i2i_gan_torch.ops.cuda import norm_kernels
from de_i2i_gan_torch.train import graphed
from de_i2i_gan_torch.train.jax_import import init_weights
from de_i2i_gan_torch.train.steps import DefectGanSteps

LOSS_RTOL = 2e-4
REL_L2, ATOL = 1e-3, 1e-5
CRITICS, BATCH, SIZE, EMBED = 5, 2, 32, 16
NETS = ("G", "E", "D", "ema_G")
OPTIMIZERS = ("D", "G", "E")
TINY = dict(image_size=SIZE, label_nc=4, ngf=8, ndf=8, num_res=2,
            hidden_nc=16, num_layers=2, use_pallas=True)
# decoder, config and training options of each path held to eager
PATHS = {
    "adain": ({"style_norm_block_type": "adain"}, {}),
    "adain_ema": ({"style_norm_block_type": "adain"}, {"ema_decay": 0.999}),
    "sean": ({"style_norm_block_type": "sean", "embed_nc": EMBED,
              "num_embeds": 3, "style_distill": True,
              "use_running_stats": True},
             {"diff_aug": "color,translation,cutout"}),
    "spade": ({"style_norm_block_type": "spade", "use_spectral": True,
               "add_noise": True}, {"diff_aug": "color,translation,cutout"}),
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    saved = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
             torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
     torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = saved


def _twins(path):
    model, train = PATHS[path]
    cfg = DefectGanConfig(**TINY, **model)
    tcfg = TrainConfig(batch_size=BATCH, num_critics=CRITICS, **train)
    twins = []
    for _ in range(2):
        s = DefectGanSteps(cfg, tcfg, device="cuda", iters_per_epoch=3,
                           num_epochs=4)
        s.init_training()
        init_weights(s, 0)
        twins.append(s)
    return twins


def _batches(cfg, seed, batch=BATCH):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    shape = (CRITICS, batch, SIZE, SIZE, 3)
    out = {"bg": torch.rand(shape, generator=gen, device="cuda") * 2 - 1,
           "df": torch.rand(shape, generator=gen, device="cuda") * 2 - 1,
           "df_labels": torch.eye(cfg.label_nc, device="cuda")[torch.randint(
               0, cfg.label_nc, (CRITICS, batch), generator=gen,
               device="cuda")]}
    if cfg.style_norm_block_type == "sean":
        for k in ("nm_embeds", "df_embeds"):
            out[k] = torch.randn((CRITICS, batch, cfg.num_embeds, EMBED),
                                 generator=gen, device="cuda")
    return out


def _eager(steps, batches, generator):
    """``d_step`` on each row, then ``g_step`` on the last: the super-step
    written out."""
    d = [steps.d_step({k: v[i] for k, v in batches.items()}, generator)
         for i in range(CRITICS)]
    out = {k: torch.stack([m[k] for m in d]).mean() for k in d[0]}
    out.update(steps.g_step({k: v[-1] for k, v in batches.items()}, generator))
    return out


def _state(steps):
    out = {}
    for n in NETS:
        net = getattr(steps, n)
        if net is not None:
            out.update({f"{n}.{k}": v.detach().double().clone()
                        for k, v in net.state_dict().items()})
    for n in OPTIMIZERS:
        tx = getattr(steps, f"tx_{n}")
        if tx is not None:
            for i, p in enumerate(tx.params):
                st = tx.opt.state[p]
                for k in ("exp_avg", "exp_avg_sq"):
                    out[f"tx_{n}.{i}.{k}"] = st[k].detach().double().clone()
    return out


def _counts(steps):
    counts = {"step": steps.step}
    for n in OPTIMIZERS:
        tx = getattr(steps, f"tx_{n}")
        if tx is not None:
            counts[f"tx_{n}"] = tx.count
            counts[f"tx_{n}.adam_steps"] = sorted(
                {float(tx.opt.state[p]["step"]) for p in tx.params})
    return counts


def _assert_same_change(got, want, start):
    assert got.keys() == want.keys() == start.keys()
    for k in want:
        g, w = got[k] - start[k], want[k] - start[k]
        assert (g - w).norm() <= REL_L2 * w.norm() + ATOL * w.numel() ** 0.5, k


def _run(steps, calls, generator, graph: bool):
    """The super-steps ``calls`` (batches) on ``steps``; returns each call's
    returned dict and its values read when it returned."""
    outs = []
    for i, batches in enumerate(calls):
        if graph:
            out = steps.super_step(batches, generator)
        else:
            if i == 1:
                graphed.make_capturable(steps)
            out = _eager(steps, batches, generator)
        outs.append((out, {k: v.item() for k, v in out.items()}))
    return outs


@pytest.mark.gpu
@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("draws", ["seeded", "default"])
def test_graphed_super_steps_equal_eager(card, path, draws):
    """4 super-steps of one shape (eager, capture and replay, 2 replays),
    then a new batch shape twice (eager both times: the steps hold one
    graph) and the first shape once more (its graph): losses, state and
    counts against the eager twin; every returned dict keeps its values."""
    g_steps, e_steps = _twins(path)
    cfg = g_steps.cfg
    start = _state(e_steps)
    assert _state(g_steps).keys() == start.keys()
    calls = [_batches(cfg, 10 + i) for i in range(4)]
    small = [_batches(cfg, 20 + i, batch=1) for i in range(2)]
    calls += small + [_batches(cfg, 30)]
    runs = {}
    for graph, steps in ((True, g_steps), (False, e_steps)):
        if draws == "seeded":
            gen = torch.Generator(device="cuda").manual_seed(5)
        else:
            gen = None
            torch.cuda.manual_seed(5)
        replays, eager = graphed.REPLAYS, graphed.EAGER
        launches = norm_kernels.LAUNCHES + norm_kernels.BWD_LAUNCHES
        runs[graph] = _run(steps, calls, gen, graph)
        torch.cuda.synchronize()
        if graph:
            # eager: the first call of the first shape and both calls of
            # the second; replayed: the rest
            assert graphed.REPLAYS - replays == 4
            assert graphed.EAGER - eager == 3
            assert g_steps._graph.key == graphed.batch_key(calls[0])
            graph_launches = (norm_kernels.LAUNCHES + norm_kernels.BWD_LAUNCHES
                              - launches)
        else:
            eager_launches = (norm_kernels.LAUNCHES + norm_kernels.BWD_LAUNCHES
                              - launches)
    assert graph_launches == eager_launches
    for i, ((out, read), (ref, ref_read)) in enumerate(zip(runs[True],
                                                           runs[False])):
        assert out.keys() == ref.keys()
        for k in ref_read:
            assert out[k].item() == read[k], f"call {i} {k} changed later"
            assert read[k] == pytest.approx(ref_read[k], rel=LOSS_RTOL,
                                            abs=1e-7), f"call {i} {k}"
    assert _counts(g_steps) == _counts(e_steps)
    _assert_same_change(_state(g_steps), _state(e_steps), start)


@pytest.mark.gpu
def test_remat_and_data_parallel_stay_eager(card):
    """``remat``'s rerun and a process group keep the eager path: no graph
    is captured, every super-step counts as eager."""
    model, train = PATHS["adain"]
    for cfg, group in ((DefectGanConfig(**TINY, **model, remat=True), None),
                       (DefectGanConfig(**TINY, **model), object())):
        steps = DefectGanSteps(cfg, TrainConfig(batch_size=BATCH,
                                                num_critics=CRITICS),
                               device="cuda")
        steps.dp_group = group
        eager = graphed.EAGER
        for i in range(3):
            steps.super_step(_batches(cfg, i))
        assert graphed.EAGER - eager == 3
        assert steps._graph.graph is None and not steps._graph.seen


# StarGAN v2 at the benchmark's shapes: the AFHQ command, batch 8, 256², bf16
SGV2_ITERS = 3
SGV2_BATCH, SGV2_IMG = 8, 256
SGV2_ADAM = (1000, 5e-3, 2e-2)  # resumed count, second moments' range
SGV2_NETS = ("G", "D", "M", "S", "ema_G", "ema_M", "ema_S")
# a replayed iteration's norm launches: 96 forward, 48 backward
SGV2_LAUNCHES = 144
# how far the graph may stray from eager, in units of the gap between two
# eager runs of the same seed (cuDNN's and the atomic sums' own spread),
# with a floor where that gap happens to be 0
SGV2_GAP_FACTOR, SGV2_FLOOR = 4.0, 1e-6


def _sgv2_solver():
    from de_i2i_gan_torch.train.solver import StarGANv2Config, StarGANv2Solver

    cfg = StarGANv2Config(img_size=SGV2_IMG, num_domains=3, latent_dim=16,
                          style_dim=64, max_conv_dim=512, w_hpf=0.0,
                          lambda_ds=2.0, batch_size=SGV2_BATCH,
                          compute_dtype="bfloat16")
    torch.manual_seed(0)
    s = StarGANv2Solver(cfg, device="cuda")
    s.init_training()
    # every Adam resumed from one drawn state, as the benchmark's check
    # does, so that an update is continuous in its gradient (a fresh Adam
    # with beta1 0 moves each weight by lr * sign(g))
    gen = torch.Generator(device="cuda").manual_seed(7)
    count, low, high = SGV2_ADAM
    with torch.no_grad():
        for _, tx in s.graph_optimizers():
            for p in tx.params:
                st = tx.opt.state[p]
                st["step"].fill_(count)
                st["exp_avg_sq"].uniform_(low, high, generator=gen)
    return s


def _sgv2_batches():
    gen = torch.Generator(device="cuda").manual_seed(11)
    out = []
    for _ in range(SGV2_ITERS):
        def imgs():
            return torch.rand((SGV2_BATCH, SGV2_IMG, SGV2_IMG, 3), generator=gen,
                              device="cuda") * 2 - 1

        out.append({"x_src": imgs(), "x_ref": imgs(), "x_ref2": imgs(),
                    "y_src": torch.randint(0, 3, (SGV2_BATCH,), generator=gen,
                                           device="cuda"),
                    "y_ref": torch.randint(0, 3, (SGV2_BATCH,), generator=gen,
                                           device="cuda"),
                    "z_ref": torch.randn((SGV2_BATCH, 16), generator=gen,
                                         device="cuda"),
                    "z_ref2": torch.randn((SGV2_BATCH, 16), generator=gen,
                                          device="cuda")})
    return out


def _sgv2_leaves(s):
    return {f"{n}.{k}": v.detach().float().clone() for n in SGV2_NETS
            for k, v in getattr(s, n).state_dict().items()}


def _sgv2_run(batches, graph: bool):
    """3 iterations from the drawn state: the graph path (eager, capture
    and replay, replay), or eager throughout with Adam capturable from the
    second, as the graph's. Returns each iteration's losses, each leaf's
    change, the norm launches and replays of each iteration."""
    s = _sgv2_solver()
    if not graph:
        s.graph_ready = lambda: False
    start = _sgv2_leaves(s)
    losses, launches, replays = [], [], []
    for i, batch in enumerate(batches):
        if not graph and i == 1:
            graphed.make_capturable(s)
        n0, r0 = norm_kernels.LAUNCHES + norm_kernels.BWD_LAUNCHES, graphed.REPLAYS
        out = s.train_step(batch)
        torch.cuda.synchronize()
        losses.append({k: v.item() for k, v in out.items()})
        launches.append(norm_kernels.LAUNCHES + norm_kernels.BWD_LAUNCHES - n0)
        replays.append(graphed.REPLAYS - r0)
    now = _sgv2_leaves(s)
    change = {k: now[k] - start[k] for k in start}
    counts = {"step": s.step, **{n: tx.count for n, tx in s.graph_optimizers()}}
    reserved = torch.cuda.max_memory_reserved() / 2 ** 20
    del s, start, now
    torch.cuda.empty_cache()
    return dict(losses=losses, change=change, launches=launches,
                replays=replays, counts=counts, reserved_mib=reserved)


def _by_net(a, b):
    """L2 norm of ``a - b`` (two dicts of leaves' changes) by net."""
    out = {}
    for k in a:
        net = k.split(".")[0]
        out[net] = out.get(net, 0.0) + float((a[k] - b[k]).double().square().sum())
    return {n: v ** 0.5 for n, v in out.items()}


@pytest.mark.gpu
def test_sgv2_graphed_iterations_equal_eager():
    """StarGAN v2 at the cell's shapes (AFHQ, batch 8, 256², bf16), 3
    iterations: the graph path against an eager run, within the gap that a
    second eager run of the same seed shows, by loss and by net's change
    (the 7 nets); 144 norm launches a replayed iteration; the update
    counts equal. Prints each gap and the reserved memory."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.cuda.reset_peak_memory_stats()
    batches = _sgv2_batches()
    eager = _sgv2_run(batches, graph=False)
    again = _sgv2_run(batches, graph=False)
    torch.cuda.reset_peak_memory_stats()
    graph = _sgv2_run(batches, graph=True)
    print(f"sgv2 graph path: max_memory_reserved {graph['reserved_mib']:.1f} "
          f"MiB (eager {eager['reserved_mib']:.1f}); norm launches "
          f"{graph['launches']} (eager {eager['launches']})")
    assert graph["replays"] == [0, 1, 1] and eager["replays"] == [0, 0, 0]
    assert graph["launches"] == eager["launches"] == [SGV2_LAUNCHES] * 3
    assert graph["counts"] == eager["counts"] == {
        "step": 3, "G": 6, "D": 6, "M": 3, "S": 3}
    for i in range(SGV2_ITERS):
        for k, want in eager["losses"][i].items():
            noise = abs(again["losses"][i][k] - want)
            got = abs(graph["losses"][i][k] - want)
            print(f"sgv2 iteration {i} {k}: eager {want!r} graph gap {got:.3e} "
                  f"eager gap {noise:.3e}")
            assert got <= SGV2_GAP_FACTOR * noise + SGV2_FLOOR * max(
                abs(want), 1.0), (i, k)
    noise = _by_net(again["change"], eager["change"])
    got = _by_net(graph["change"], eager["change"])
    size = _by_net(eager["change"], {k: 0.0 for k in eager["change"]})
    for net in SGV2_NETS:
        print(f"sgv2 change of {net}: norm {size[net]:.4e} graph gap "
              f"{got[net]:.3e} eager gap {noise[net]:.3e}")
        assert got[net] <= SGV2_GAP_FACTOR * noise[net] + SGV2_FLOOR * size[net], net
