"""Data parallelism, counterpart of ``de_i2i_gan_tpu/parallel/mesh.py``.

GSPMD runs the JAX step on the global batch as if on one device: BatchNorm
statistics and loss means are global, and every network's gradient is the
global mean. The port reaches the same numbers with one process a device
(``parallel/distributed.py``): every rank holds a replica of every net,
optimizer and EMA, takes its own rows of the global batch, and

  * ``train/optim.py::Optimizer.step`` averages each network's gradients
    over the ranks, one flattened all-reduce an update (the per-network
    all-reduce GSPMD inserts);
  * ``nn/blocks.py::BatchNorm`` normalizes in train mode with the moments of
    the global batch (the f32 sums and sums of squares of each group,
    all-reduced, and their gradients all-reduced in the backward pass), and
    moves its running statistics from them, equal on every rank;
  * SEAN's running styles sum their accumulators over the ranks before they
    are finalized (``reduce_running_styles``).

A ``Mesh`` names this host's devices, one rank each. ``mesh_from_flag``
resolves ``--data_parallel`` as the JAX function does; ``replicate``
broadcasts rank 0's state after init or resume (``put_replicated``);
``shard_batch`` takes this rank's rows of a global batch;
``make_parallel_step`` attaches the group to a steps object. The spatial
mesh (``spatial_sharded_inference``) is not ported (ROADMAP A.9).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from de_i2i_gan_torch.parallel import distributed


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The devices of this host's ranks, one rank a device (a device may
    repeat: ranks that share a card talk over gloo)."""

    devices: Tuple[str, ...]


def visible_devices(mode: str, gpu_ids: str = "0",
                    num_devices: Optional[int] = None) -> Tuple[str, ...]:
    """The devices ``--data_parallel`` may spread over: the ``--gpu_ids``
    list when it names several; else the first ``--num_devices`` cards;
    else, under 'auto', every visible card; else the one ``--gpu_ids``
    device. ``--gpu_ids -1`` gives ``--num_devices`` CPU ranks."""
    ids = [int(i) for i in str(gpu_ids).split(",") if i.strip()]
    if ids[0] < 0:
        return ("cpu",) * (num_devices or 1)
    if len(ids) > 1:
        return tuple(f"cuda:{i}" for i in ids)
    if num_devices:
        return tuple(f"cuda:{i}" for i in range(num_devices))
    if mode == "auto" and torch.cuda.device_count() > 1:
        return tuple(f"cuda:{i}" for i in range(torch.cuda.device_count()))
    return (f"cuda:{ids[0]}",)


def mesh_from_flag(mode: str, batch_size: int, gpu_ids: str = "0",
                   num_devices: Optional[int] = None) -> Optional[Mesh]:
    """Resolve ``--data_parallel`` ('auto' | 'on' | 'off') to a Mesh, with
    the JAX function's decisions and messages.

    'auto': data-parallel over the visible devices (all hosts' under
    ``torchrun``) when more than one is visible and the per-host batch
    divides the local ranks; None otherwise. 'on' raises instead of
    falling back."""
    if mode == "off":
        return None
    if distributed.under_torchrun():
        # one rank a process: this host's ranks take the first devices
        local = distributed.local_ranks()
        devices = visible_devices("on", gpu_ids, num_devices or local)[:local]
        n_local, n_total = len(devices), distributed.launch_world()
    else:
        devices = visible_devices(mode, gpu_ids, num_devices)
        n_local = n_total = len(devices)
    if n_total <= 1:
        if mode == "on":
            raise RuntimeError("--data_parallel on: only one device visible")
        return None
    if batch_size % n_local != 0:
        msg = (f"--data_parallel: batch_size {batch_size} does not divide "
               f"{n_local} local devices")
        if mode == "on":
            raise RuntimeError(msg)
        print(f"[data_parallel] {msg}; running single-device")
        return None
    return Mesh(tuple(devices))


def run(fn, mesh: Optional[Mesh], *args):
    """The CLIs' scale-out of ``fn(*args, mesh)``, which trains and returns
    its trainer, steps or solver: in this process without a mesh; on this
    rank under ``torchrun``, or in a process that is a rank already
    (joining first, the arguments taken from rank 0); else on one spawned
    rank a device of the mesh (``launch``), and then it returns each rank's
    ``state_digest``."""
    if mesh is None:
        return fn(*args, None)
    if distributed.under_torchrun() or dist.is_initialized():
        distributed.initialize(mesh.devices)
        return fn(*distributed.broadcast_object(args), mesh)
    return distributed.launch(_digest_of, mesh.devices, fn, *args, mesh)


def _digest_of(fn, *args):
    return state_digest(fn(*args))


def state_digest(trained) -> dict:
    """A SHA-256 digest of every tensor of the train state of ``trained``
    (a trainer, or steps or a solver) by name, and its counts: equal
    digests are equal states, bit for bit. SEAN's running-style
    accumulators are left out, since each rank holds its own share of
    them between finalizes."""
    import hashlib

    from de_i2i_gan_torch.train.checkpoint import train_state

    out = {}

    def walk(tree, path):
        for k, v in tree.items():
            p = f"{path}/{k}" if path else str(k)
            if isinstance(v, dict):
                walk(v, p)
            elif isinstance(v, torch.Tensor):
                if k.rsplit(".", 1)[-1] in ACCUMULATORS and \
                        "moments" not in p:
                    continue
                data = v.detach().cpu().contiguous().reshape(-1)
                out[p] = hashlib.sha256(
                    data.view(torch.uint8).numpy().tobytes()).hexdigest()
            else:
                out[p] = v

    walk(train_state(getattr(trained, "steps", trained)), "")
    return out


# --------------------------------------------------------------- the batch
def shard_batch(batch: Any, batch_axis: int = 0) -> Any:
    """This rank's rows of a global batch along ``batch_axis`` (axis 1 for
    the (num_critics | iters_per_launch, B, ...) super-batches), in a dict,
    list or tuple of tensors or arrays; non-array leaves pass through."""
    n, r = distributed.world_size(), distributed.rank()
    if isinstance(batch, dict):
        return {k: shard_batch(v, batch_axis) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(shard_batch(v, batch_axis) for v in batch)
    if not hasattr(batch, "shape") or n == 1:
        return batch
    rows = batch.shape[batch_axis]
    if rows % n:
        raise ValueError(f"batch axis {batch_axis} of {rows} rows does not "
                         f"split over {n} ranks")
    per = rows // n
    index = (slice(None),) * batch_axis + (slice(r * per, (r + 1) * per),)
    return batch[index]


# --------------------------------------------------------------- the state
def _state_tensors(steps) -> list:
    """Every parameter, buffer and optimizer moment of ``steps`` (the EMA
    nets with them), as live tensors; optimizer step counters excluded."""
    from de_i2i_gan_torch.train.checkpoint import train_state

    out = []

    def walk(tree, key=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, k)
            elif isinstance(v, torch.Tensor) and not (k == "step" and key):
                out.append(v)

    walk(train_state(steps))
    return out


def _running_style_layers(steps):
    from de_i2i_gan_torch.models.starganv2 import SEANv2
    from de_i2i_gan_torch.nn.normalization import SEAN

    for name in ("G", "ema_G"):
        net = getattr(steps, name, None)
        if net is not None:
            yield from (m for m in net.modules()
                        if isinstance(m, (SEAN, SEANv2)))


ACCUMULATORS = ("sum", "sumsq", "count")


@torch.no_grad()
def replicate(steps, group=None) -> None:
    """Rank 0's parameters, buffers, optimizer moments and EMA tensors on
    every rank (after init or resume, as ``put_replicated``). SEAN's
    running-style accumulators then keep rank 0's values on rank 0 and
    start from zero elsewhere: each rank adds its own codes, and their sum
    over the ranks is what one process over the global batch holds."""
    if not dist.is_initialized():
        return
    distributed.broadcast_(_state_tensors(steps), group)
    if dist.get_rank(group) != 0:
        for m in _running_style_layers(steps):
            for name in ACCUMULATORS:
                getattr(m, name).zero_()


@torch.no_grad()
def reduce_running_styles(module: torch.nn.Module, group=None,
                          keep_on_primary: bool = False) -> None:
    """Sum the running-style accumulators of every SEAN layer of ``module``
    over the ranks of ``group``, in one all-reduce: before a finalize every
    rank then holds the global sums; with ``keep_on_primary`` (before a
    checkpoint) rank 0 holds them and the others start again from zero."""
    from de_i2i_gan_torch.models.starganv2 import SEANv2
    from de_i2i_gan_torch.nn.normalization import SEAN

    accs = [getattr(m, name) for m in module.modules()
            if isinstance(m, (SEAN, SEANv2)) for name in ACCUMULATORS]
    if not accs:
        return
    distributed.all_reduce_(accs, group)
    if keep_on_primary and dist.get_rank(group) != 0:
        for t in accs:
            t.zero_()


def sync_running_styles(steps) -> None:
    """Rank 0's running-style accumulators become the global ones, before
    rank 0 writes a checkpoint; every rank calls it (a no-op without a
    group)."""
    group = getattr(steps, "dp_group", None)
    if group is None:
        return
    for name in ("G", "ema_G"):
        net = getattr(steps, name, None)
        if net is not None:
            reduce_running_styles(net, group, keep_on_primary=True)


def make_parallel_step(steps, group=None):
    """Attach ``group`` (the default group when None) to ``steps`` as
    ``steps.dp_group``: its optimizers average their gradients over it, its
    BatchNorm layers normalize with the global moments, and its SEAN
    running styles are reduced over it before they are finalized. Returns
    ``steps``."""
    from de_i2i_gan_torch.nn.blocks import BatchNorm
    from de_i2i_gan_torch.train.optim import Optimizer

    group = group or dist.group.WORLD
    steps.dp_group = group
    for value in list(vars(steps).values()):
        if isinstance(value, Optimizer):
            value.group = group
        elif isinstance(value, torch.nn.Module):
            for m in value.modules():
                if isinstance(m, BatchNorm):
                    m.group = group
    return steps


def reduce_metrics(rows: Sequence[Sequence[torch.Tensor]], group=None
                   ) -> torch.Tensor:
    """The (n, k) metric means of ``rows`` averaged over the ranks: one
    all-reduce, on the card when any value is there (a step may report a
    host scalar beside its device losses, as StarGAN v2's lambda_ds)."""
    device = next((v.device for r in rows for v in r if v.is_cuda),
                  torch.device("cpu"))
    stacked = torch.stack([torch.stack([v.float().to(device) for v in r])
                           for r in rows])
    if dist.is_initialized():
        distributed.all_reduce_([stacked], group, average=True)
    return stacked
