"""Process groups, counterpart of ``de_i2i_gan_tpu/parallel/distributed.py``.

The JAX package runs one process a host and a mesh over the host's chips.
The port runs one process a card (a rank), each holding a replica of every
net, optimizer and EMA and taking its own rows of the global batch:

  * ``initialize``: a process started by ``torchrun`` joins the group from
    its environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``); a single
    process does nothing, as JAX's ``initialize`` does
  * ``launch``: the CLIs' spawner for ``--num_devices N`` or ``--gpu_ids
    a,b``: one process a device, joined through a ``FileStore`` in a
    temporary directory (no TCP port is chosen, so concurrent launches
    cannot collide)
  * ``process_shard``: this rank's equal, contiguous shard of a dataset, the
    remainder dropped (unequal loader lengths would deadlock the
    collectives)
  * the backend rule (``backend_for``): NCCL when every rank has a CUDA
    device of its own; gloo on the CPU, or when ranks share a device. It
    goes by the devices, never by trying one backend and then the other.

``all_reduce_`` and ``broadcast_`` move a list of tensors in one collective
per (device, dtype), flattened: the gradient all-reduce, the replication
from rank 0 and the metric reduction use them.
"""
from __future__ import annotations

import os
import shutil
import tempfile
from pathlib import Path
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

# the device of this rank, set when it joins (launch or initialize)
_DEVICE: Optional[str] = None


def backend_for(devices: Sequence[str]) -> str:
    """'nccl' when every rank has a CUDA device of its own, else 'gloo'."""
    cuda = all(torch.device(d).type == "cuda" for d in devices)
    return "nccl" if cuda and len(set(devices)) == len(devices) else "gloo"


def _join(devices: Sequence[str], rank: int, world: int, local_rank: int,
          **init) -> None:
    global _DEVICE
    _DEVICE = devices[local_rank]
    if torch.device(_DEVICE).type == "cuda":
        torch.cuda.set_device(torch.device(_DEVICE))
    else:
        # CPU ranks share the host's cores: each takes its share, where
        # every rank's default of all of them would oversubscribe the host
        torch.set_num_threads(max(1, min(torch.get_num_threads(),
                                         (os.cpu_count() or 1)
                                         // len(devices))))
    dist.init_process_group(backend_for(devices), rank=rank, world_size=world,
                            **init)


def under_torchrun() -> bool:
    """Whether ``torchrun`` (or another launcher) started this process as
    one rank of several."""
    return launch_world() > 1


def launch_world() -> int:
    """The ranks of a ``torchrun`` launch, before they join."""
    return int(os.environ.get("WORLD_SIZE", "1"))


def local_ranks() -> int:
    """Ranks on this host: the launcher's ``LOCAL_WORLD_SIZE``, else the
    whole world (``launch`` spawns every rank on one host)."""
    return int(os.environ.get("LOCAL_WORLD_SIZE", world_size()))


def initialize(devices: Sequence[str]) -> None:
    """Join the process group of a ``torchrun`` launch, on
    ``devices[LOCAL_RANK]``; a no-op for a single process or once
    joined."""
    if not under_torchrun() or dist.is_initialized():
        return
    _join(devices, int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]),
          int(os.environ.get("LOCAL_RANK", "0")), init_method="env://")


def _entry(local_rank: int, fn: Callable, devices: Sequence[str],
           store_path: str, out_dir: str, args: tuple) -> None:
    store = dist.FileStore(store_path, len(devices))
    _join(devices, local_rank, len(devices), local_rank, store=store)
    try:
        out = fn(*args)
        torch.save(out, Path(out_dir) / f"rank{local_rank}.pt")
    finally:
        dist.destroy_process_group()


def launch(fn: Callable, devices: Sequence[str], *args) -> List:
    """Run ``fn(*args)`` in one spawned process a device of ``devices``,
    each a rank of one group; wait for them all and return what each
    returned, by rank (values ``torch.save`` can write, on the CPU). A rank
    that raises makes this raise."""
    tmp = tempfile.mkdtemp(prefix="dig_launch_")
    try:
        torch.multiprocessing.spawn(
            _entry, args=(fn, list(devices), os.path.join(tmp, "store"), tmp,
                          args),
            nprocs=len(devices), join=True)
        return [torch.load(Path(tmp) / f"rank{r}.pt", map_location="cpu",
                           weights_only=False)
                for r in range(len(devices))]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary() -> bool:
    return rank() == 0


def device() -> Optional[str]:
    """This rank's device, once it has joined a group."""
    return _DEVICE if dist.is_initialized() else None


def barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


def process_shard(n_items: int) -> slice:
    """This rank's contiguous shard of ``n_items``: every rank gets exactly
    ``n_items // world`` items, the remainder dropped, so every rank runs
    the same number of steps an epoch."""
    per = n_items // world_size()
    start = rank() * per
    return slice(start, start + per)


def rank_seed(seed: int) -> int:
    """The seed of this rank's step generator: ``seed`` on rank 0, so that it
    draws what a single process draws, and a stream of its own on every
    other rank."""
    return seed + 1_000_003 * rank()


def broadcast_object(obj):
    """Rank 0's ``obj`` on every rank."""
    if not dist.is_initialized():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def _buckets(tensors: Sequence[torch.Tensor]):
    by = {}
    for t in tensors:
        by.setdefault((t.device, t.dtype), []).append(t)
    return by.values()


def _coalesced(tensors: Sequence[torch.Tensor], collective) -> None:
    for bucket in _buckets(tensors):
        flat = torch.cat([t.reshape(-1) for t in bucket])
        collective(flat)
        with torch.no_grad():
            for t, v in zip(bucket, flat.split([t.numel() for t in bucket])):
                t.copy_(v.view_as(t))


def all_reduce_(tensors: Sequence[torch.Tensor], group=None,
                average: bool = False) -> None:
    """Sum (or average) each tensor over the ranks of ``group``, in place:
    one all-reduce per (device, dtype)."""
    n = dist.get_world_size(group)

    def reduce(flat):
        dist.all_reduce(flat, group=group)
        if average:
            flat.div_(n)

    _coalesced(tensors, reduce)


def broadcast_(tensors: Sequence[torch.Tensor], group=None, src: int = 0
               ) -> None:
    """Rank ``src``'s values of each tensor on every rank, in place."""
    _coalesced(tensors, lambda flat: dist.broadcast(flat, src=src,
                                                    group=group))
