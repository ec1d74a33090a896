"""The port's data parallelism, its parts (``de_i2i_gan_torch/parallel``,
``nn/blocks.py::BatchNorm`` with a group, ``train/optim.py::Optimizer``
with a group): two CPU ranks over gloo where a collective runs
(``tests/torch_dp_workers.py``), against one process on the global batch,
and the JAX package's arithmetic for the decisions (``mesh_from_flag``,
``process_shard``, ``shard_for_process``).
"""
import jax
import numpy as np
import pytest
import torch

from de_i2i_gan_tpu.data import datasets as jax_datasets
from de_i2i_gan_tpu.parallel import distributed as jax_distributed
from de_i2i_gan_tpu.parallel import mesh as jax_mesh
from de_i2i_gan_torch.data import datasets
from de_i2i_gan_torch.nn.blocks import BatchNorm
from de_i2i_gan_torch.parallel import distributed, mesh
from de_i2i_gan_torch.train.optim import make_optimizer
from de_i2i_gan_torch.config import TrainConfig
from tests import torch_dp_workers as workers

torch.set_num_threads(1)

CPU2 = ["cpu", "cpu"]


def rel(a, b):
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


# ------------------------------------------------------------- BatchNorm
@pytest.mark.parametrize("groups", [1, 2])
def test_batchnorm_over_two_ranks_is_the_global_batch(groups):
    """Output, running statistics, input gradient and parameter gradients
    of two ranks equal one process's BatchNorm on the global batch in its
    group layout, within 1e-6 relative."""
    rng = np.random.default_rng(groups)
    x = (rng.normal(0.5, 2.0, (8, 6, 5, 5))).astype(np.float32)
    w = rng.normal(0, 1, x.shape).astype(np.float32)
    bn = BatchNorm(6).train()
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5)
        bn.bias.normal_()
        bn.running_mean.normal_()
        bn.running_var.uniform_(0.5, 1.5)
    state = {k: v.clone() for k, v in bn.state_dict().items()}
    xt = torch.from_numpy(x).requires_grad_()
    y = bn(xt, bn_groups=groups)
    loss = (y * torch.from_numpy(w)).sum() / len(x)
    gx, gw, gb = torch.autograd.grad(loss, [xt, bn.weight, bn.bias])
    ranks = distributed.launch(workers.bn_ranks, CPU2, groups, x, w, state)
    for r, got in enumerate(ranks):
        ref_y = workers.rank_rows(y.detach().numpy(), groups, 2, r)
        ref_gx = workers.rank_rows(gx.numpy(), groups, 2, r)
        assert rel(got["y"], torch.from_numpy(ref_y)) < 1e-6
        assert rel(got["gx"], torch.from_numpy(ref_gx)) < 1e-6
        assert rel(got["gw"], gw) < 1e-6 and rel(got["gb"], gb) < 1e-6
        assert rel(got["running_mean"], bn.running_mean) < 1e-6
        assert rel(got["running_var"], bn.running_var) < 1e-6
    for k in ("running_mean", "running_var"):
        assert torch.equal(ranks[0][k], ranks[1][k])


def test_batchnorm_without_a_group_is_unchanged():
    """No group: the F.batch_norm path, bit for bit."""
    x = torch.randn(4, 3, 4, 4, generator=torch.Generator().manual_seed(0))
    a, b = BatchNorm(3).train(), BatchNorm(3).train()
    assert a.group is None
    torch.testing.assert_close(a(x, bn_groups=2), torch.cat([
        torch.nn.functional.batch_norm(p, None, None, b.weight, b.bias, True,
                                       0.0, 1e-5) for p in x.chunk(2)]),
                               rtol=0, atol=0)


# ------------------------------------------------------------- optimizer
def test_optimizer_applies_the_mean_of_the_ranks_gradients():
    """Two ranks with different gradients apply their mean; Adam's moments
    end identical on both, and equal one process's fed the means."""
    rng = np.random.default_rng(0)
    grads = [[rng.normal(0, 1, (3, 4)).astype(np.float32) for _ in range(2)]
             for _ in range(2)]
    p0 = torch.from_numpy(rng.normal(0, 1, (3, 4)).astype(np.float32))
    ranks = distributed.launch(workers.optimizer_ranks, CPU2, grads,
                               {"p": p0})
    p = torch.nn.Parameter(p0.clone())
    tx = make_optimizer(TrainConfig(optimizer="adam"), [p], 1e-2, 10, 2)
    for i in range(2):
        tx.step([torch.from_numpy((grads[0][i] + grads[1][i]) / 2)])
    st = tx.opt.state[p]
    for got in ranks:
        assert got["count"] == 2
        torch.testing.assert_close(got["p"], p.detach(), rtol=1e-6, atol=1e-7)
        torch.testing.assert_close(got["exp_avg"], st["exp_avg"], rtol=1e-6,
                                   atol=1e-8)
        torch.testing.assert_close(got["exp_avg_sq"], st["exp_avg_sq"],
                                   rtol=1e-6, atol=1e-10)
    for k in ("p", "exp_avg", "exp_avg_sq"):
        assert torch.equal(ranks[0][k], ranks[1][k])


# ------------------------------------------------------ shards, decisions
@pytest.mark.parametrize("n_items,world", [(10, 1), (10, 2), (11, 3), (7, 4)])
def test_process_shard_matches_jax(n_items, world, monkeypatch):
    """Equal contiguous shards, the remainder dropped, as JAX's
    ``process_shard`` and ``_ShardView``."""
    items = list(range(n_items))
    for r in range(world):
        monkeypatch.setattr(jax, "process_index", lambda r=r: r)
        monkeypatch.setattr(jax, "process_count", lambda: world)
        monkeypatch.setattr(distributed, "rank", lambda r=r: r)
        monkeypatch.setattr(distributed, "world_size", lambda: world)
        assert distributed.process_shard(n_items) == \
            jax_distributed.process_shard(n_items)
        view = datasets.shard_for_process(items)
        ref = jax_datasets.shard_for_process(items)
        assert len(view) == len(ref) == n_items // world
        assert [view[i] for i in range(len(view))] == \
            [ref[i] for i in range(len(ref))]


class _Devices:
    def __init__(self, n):
        self.devices = [f"d{i}" for i in range(n)]


def _jax_decision(mode, batch, n, monkeypatch):
    """JAX's ``mesh_from_flag`` with ``n`` devices: (size or None, error)."""
    monkeypatch.setattr(jax, "devices", lambda *a: list(range(n)))
    monkeypatch.setattr(jax, "local_devices", lambda *a: list(range(n)))
    monkeypatch.setattr(jax_mesh, "Mesh", lambda d, axes: _Devices(len(d)))
    try:
        m = jax_mesh.mesh_from_flag(mode, batch)
    except RuntimeError as e:
        return None, str(e)
    return (None if m is None else len(m.devices)), None


@pytest.mark.parametrize("mode", ["auto", "on", "off"])
@pytest.mark.parametrize("cards,batch", [(0, 8), (1, 8), (2, 8), (3, 8),
                                         (4, 8)])
def test_mesh_from_flag_decides_as_jax(mode, cards, batch, monkeypatch,
                                       capsys):
    """The visible cards (every card under 'auto', as JAX takes every
    device; the first --num_devices otherwise): the same mesh size, the
    same error and the same fallback line as the JAX function."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    for env in ("WORLD_SIZE", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(env, raising=False)
    num = None if mode == "auto" or cards == 0 else cards
    try:
        got = mesh.mesh_from_flag(mode, batch, "0", num)
        err = None
    except RuntimeError as e:
        got, err = None, str(e)
    out = capsys.readouterr().out
    want, jerr = _jax_decision(mode, batch, max(cards, 1), monkeypatch)
    jout = capsys.readouterr().out
    assert (None if got is None else len(got.devices)) == want
    assert err == jerr and out == jout
    if got is not None:
        assert got.devices == tuple(f"cuda:{i}" for i in range(cards))


@pytest.mark.parametrize("gpu_ids,num,want", [
    ("0,1", None, ("cuda:0", "cuda:1")),
    ("2,0", None, ("cuda:2", "cuda:0")),
    ("0,0", None, ("cuda:0", "cuda:0")),
    ("-1", 2, ("cpu", "cpu")),
    ("-1", None, ("cpu",)),
    ("0", 3, ("cuda:0", "cuda:1", "cuda:2")),
    ("1", None, ("cuda:1",))])
def test_visible_devices(gpu_ids, num, want, monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert mesh.visible_devices("on", gpu_ids, num) == want


def test_mesh_under_torchrun_counts_the_launch(monkeypatch):
    """Under torchrun the world is the launch's and this host's ranks take
    the first devices."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    assert mesh.mesh_from_flag("auto", 8).devices == ("cuda:0", "cuda:1")
    with pytest.raises(RuntimeError, match="batch_size 3 does not divide 2"):
        mesh.mesh_from_flag("on", 3)


@pytest.mark.parametrize("devices,backend", [
    (("cuda:0", "cuda:1"), "nccl"), (("cuda:0",), "nccl"),
    (("cuda:0", "cuda:0"), "gloo"), (("cpu", "cpu"), "gloo"),
    (("cpu",), "gloo")])
def test_backend_rule(devices, backend):
    assert distributed.backend_for(devices) == backend


def test_shard_batch_takes_this_ranks_rows(monkeypatch):
    batch = {"a": np.arange(24).reshape(2, 4, 3), "b": torch.arange(4),
             "masks": [np.arange(8).reshape(4, 2)]}
    monkeypatch.setattr(distributed, "world_size", lambda: 2)
    monkeypatch.setattr(distributed, "rank", lambda: 1)
    got = mesh.shard_batch({"a": batch["a"], "n": 3}, batch_axis=1)
    np.testing.assert_array_equal(got["a"], batch["a"][:, 2:])
    assert mesh.shard_batch(batch["b"]).tolist() == [2, 3]
    np.testing.assert_array_equal(mesh.shard_batch(batch["masks"])[0],
                                  batch["masks"][0][2:])
    assert got["n"] == 3
    with pytest.raises(ValueError, match="does not split over 2 ranks"):
        mesh.shard_batch(np.zeros((3, 2)))


def test_rank_seed_keeps_rank_zero_on_the_single_process_stream(monkeypatch):
    assert distributed.rank_seed(124) == 124
    monkeypatch.setattr(distributed, "rank", lambda: 1)
    assert distributed.rank_seed(124) != 124


def test_single_process_is_a_no_op():
    """Without a group: rank 0 of 1, no barrier, replicate does nothing,
    the metrics come back as they are."""
    assert distributed.rank() == 0 and distributed.world_size() == 1
    assert distributed.is_primary() and distributed.device() is None
    distributed.barrier()
    steps = workers.build("wgan_clip")
    before = mesh.state_digest(steps)
    mesh.replicate(steps)
    mesh.sync_running_styles(steps)
    assert mesh.state_digest(steps) == before
    rows = [[torch.tensor(1.0), torch.tensor(2.0)]]
    assert mesh.reduce_metrics(rows).tolist() == [[1.0, 2.0]]
    assert mesh.run(lambda x, m: (x, m), None, 5) == (5, None)


def test_state_digest_sees_one_bit(monkeypatch):
    steps = workers.build("wgan_clip")
    a = mesh.state_digest(steps)
    with torch.no_grad():
        w = next(steps.G.parameters())
        w.view(-1)[0] = torch.nextafter(w.view(-1)[0], torch.tensor(1e9))
    b = mesh.state_digest(steps)
    assert sum(a[k] != b[k] for k in a) == 1
