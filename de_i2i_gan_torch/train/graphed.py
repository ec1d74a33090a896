"""A training iteration replayed as one CUDA graph: DefectGAN's super-step
(``DefectGanSteps.super_step``) and StarGAN v2's iteration
(``StarGANv2Solver.train_step``).

An eager iteration makes thousands of kernel launches, each a Python call
and a launch on the host: about 9k a DefectGAN super-step (5 critics, batch
8, 256², about 200 ms of kernels) and 14.5k a StarGAN v2 AFHQ iteration
(batch 8, 256², about 500 ms), so the host sets the pace. A graph replays
the same kernels, in the same order and precision, from one launch.

An owner (the steps or the solver) hands a call here only where
``eligible`` holds, all of it observable from the call: a CUDA device, no
process group (``dp_group``), what the owner's ``graph_ready()`` asks of
itself, and no generator or a CUDA ``torch.Generator`` that a graph can
register. ``DefectGanSteps.graph_ready`` asks for no ``remat`` (its rerun
saves and restores the generator's state on the host, which a replay cannot
repeat) and Adam or AdamW (whose ``capturable`` form reads its step and
learning rate on the device); ``StarGANv2Solver.graph_ready`` for AdaIN
without FusedProp or a high-pass (``w_hpf`` 0: no FAN heatmaps, no masks).
Every other call runs the eager body as before.

One machine (``SuperStepGraph``) serves both owners; each owner says what
differs between them:

  * ``_super_step(batches, generator)``: the eager body, which a graph
    captures; it returns the iteration's losses as 0-d tensors;
  * ``graph_optimizers()``: its optimizers by name (DefectGAN's D, G, E;
    StarGAN v2's G, D, M, S), whose update counts the host keeps;
  * ``graph_scalars()``: the host floats the body reads besides the
    optimizers' learning rates, each as ``(holder, attribute, count)``: the
    body calls ``holder.attribute(count)`` (StarGAN v2's ``_lambda_ds`` of
    its step; DefectGAN has none).

An owner holds at most one graph, for the first set of the batch's keys,
shapes, dtypes and devices (``batch_key``) that it is called with twice:

  * a key's first call runs eagerly: the capture's warm-up (cuDNN's
    algorithm choice, cuBLAS handles, the norm library's first-use
    attributes, the optimizers' lazy state);
  * its second call captures the eager body into the graph, on the device
    of the owner, and replays it once;
  * later calls copy each row into the graph's static input (one device
    copy a key) and replay;
  * calls of any other key run eagerly: a graph's private memory pool holds
    the iteration's activations (about 10 GiB at batch 8, 256², in either
    model), and no caller trains on two shapes.

The optimizers become ``capturable`` at the owner's first capture: Adam's
step counts move to the device. Every host float the body reads is a slot
of the graph, a 0-d device tensor made at the read during the capture
(``_Graph.scalars``) outside the graph's memory pool, which the host fills
before a replay where its value changes: each learning rate from its
optimizer's schedule at the count of that update, and each of the owner's
``graph_scalars`` from its function at the owner's count. A float read on
the host would be baked into the graph at its capture value. StarGAN v2's
``lambda_ds`` decays every iteration, so its two slots (the G loss of the
latent and of the reference pass) are filled before every replay; a
DefectGAN learning rate moves at an epoch boundary, which can fall between
two critics.

What the capture counts on the host (the owner's ``step``, each
``Optimizer.count``, and every count registered with
``profiling.register_host_counts``, such as the norm kernels' launches) is
taken back after the capture and added again after each replay. The spans
the capture opens become nodes of the graph
(``utils/profiling.py::captured``), and each replay while recording is on
keeps their records with the device ms of that replay
(``profiling.replayed``). Each call returns loss tensors of its own, copied
out of the graph's static outputs in one clone.

The counter sources ``train.graph_replays`` and ``train.eager_super_steps``
count the iterations, of either owner, that replayed a graph and those that
ran eagerly.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

import torch

from de_i2i_gan_torch.utils import profiling

REPLAYS = 0
EAGER = 0
profiling.register_counter("train.graph_replays", lambda: REPLAYS)
profiling.register_counter("train.eager_super_steps", lambda: EAGER)

GRAPH_DEVICES = ("cuda",)  # device types whose streams capture graphs
GRAPHED_OPTIMIZERS = ("adam", "adamw")


def count_eager() -> None:
    global EAGER
    EAGER += 1


def eligible(owner, generator: Optional[torch.Generator]) -> bool:
    """Whether an iteration of ``owner`` with ``generator`` may run as a
    graph; see the module's docstring."""
    return (owner.device.type in GRAPH_DEVICES and owner.dp_group is None
            and owner.graph_ready()
            and (generator is None or (
                isinstance(generator, torch.Generator)
                and generator.device.type == "cuda"))
            and not torch.cuda.is_current_stream_capturing())


def batch_key(batches: Dict[str, torch.Tensor]) -> tuple:
    return tuple((k, tuple(v.shape), v.dtype, v.device)
                 for k, v in batches.items())


def schedules(owner) -> List[tuple]:
    """Each host float the body reads, as ``(holder, attribute, count)``:
    the optimizers' learning rates, then the owner's ``graph_scalars``."""
    return ([(tx, "schedule", tx.count) for _, tx in owner.graph_optimizers()]
            + list(owner.graph_scalars()))


def host_counts(owner) -> Tuple[Dict[str, int], Dict[str, Dict[str, int]]]:
    """What an iteration advances on the host: the owner's own counts (its
    ``step``, each optimizer's updates) and the registered host counts."""
    own = {"step": owner.step}
    own.update({n: tx.count for n, tx in owner.graph_optimizers()})
    return own, profiling.host_counts()


def difference(after, before):
    """``after`` less ``before``, two ``host_counts``."""
    own = {k: v - before[0][k] for k, v in after[0].items()}
    return own, {name: {k: v - before[1][name][k] for k, v in counts.items()}
                 for name, counts in after[1].items()}


def advance(owner, delta, sign: int = 1) -> None:
    """Add ``sign`` times ``delta`` (a ``difference``)."""
    own, registered = delta
    owner.step += sign * own["step"]
    for n, tx in owner.graph_optimizers():
        tx.count += sign * own[n]
    profiling.add_host_counts({
        name: {k: sign * v for k, v in counts.items()}
        for name, counts in registered.items()})


def make_capturable(owner) -> None:
    """The optimizers' Adam in its ``capturable`` form, once: step counts
    on the parameters' device (a tensor learning rate is set in the
    capture)."""
    for _, tx in owner.graph_optimizers():
        for group in tx.opt.param_groups:
            if group.get("capturable"):
                continue
            group["capturable"] = True
            for p in group["params"]:
                state = tx.opt.state[p]
                state["step"] = state["step"].to(p.device, torch.float32)


@contextlib.contextmanager
def _swapped(holder, attribute: str, value):
    """``holder.attribute`` is ``value`` inside the block; after it, what
    it was (an instance's own attribute, or its class's again)."""
    own = vars(holder)
    had, saved = attribute in own, own.get(attribute)
    setattr(holder, attribute, value)
    try:
        yield
    finally:
        if had:
            setattr(holder, attribute, saved)
        else:
            delattr(holder, attribute)


class _Graph:
    """One captured iteration: the graph, its static inputs, its losses
    stacked in one static tensor, its host-float slots (each the index of
    a ``schedules`` entry and an offset from its count at the replay) and
    their 0-d device tensors, the spans its capture recorded, and what one
    replay advances on the host."""

    def __init__(self, batches: Dict[str, torch.Tensor], generator):
        self.graph = torch.cuda.CUDAGraph()
        self.generator = generator
        self.inputs = {k: torch.empty_like(v) for k, v in batches.items()}
        self.names: List[str] = []
        self.dtypes: List[torch.dtype] = []
        self.losses: Optional[torch.Tensor] = None
        self.slots: List[Tuple[int, int]] = []
        self.scalars: List[torch.Tensor] = []
        self.filled: Optional[List[float]] = None
        self.spans: list = []
        self.delta: tuple = ({}, {})


class SuperStepGraph:
    """The graph of one owner and the batch keys it has seen. It holds no
    reference to the owner, so dropping the owner frees the graph and its
    memory pool."""

    def __init__(self):
        self.key: Optional[tuple] = None
        self.graph: Optional[_Graph] = None
        self.seen: set = set()

    def __call__(self, owner, batches: Dict[str, torch.Tensor],
                 generator) -> Optional[Dict[str, torch.Tensor]]:
        """The iteration's losses from the graph, or None where this call
        runs eagerly (a batch key's first call, a key other than the
        graph's, or a generator other than the one the graph registered)."""
        key = batch_key(batches)
        g = self.graph
        if g is None:
            if key not in self.seen:
                self.seen.add(key)
                return None
            with torch.cuda.device(owner.device):
                g = self.graph = self._capture(owner, batches, generator)
            self.key = key
        elif key != self.key or g.generator is not generator:
            return None
        with torch.cuda.device(owner.device):
            return self._replay(owner, g, batches)

    def _capture(self, owner, batches, generator) -> _Graph:
        g = _Graph(batches, generator)
        for k, v in batches.items():
            g.inputs[k].copy_(v)
        make_capturable(owner)
        stream = torch.cuda.current_stream(owner.device)
        if generator is not None:
            g.graph.register_generator_state(generator)
        before = host_counts(owner)
        try:
            with contextlib.ExitStack() as slots:
                for i, (holder, attribute, count) in enumerate(
                        schedules(owner)):
                    slots.enter_context(_swapped(
                        holder, attribute,
                        self._slot(g, i, count, owner.device, stream)))
                with profiling.captured() as g.spans, torch.cuda.graph(
                        g.graph, capture_error_mode="thread_local"):
                    out = owner._super_step(g.inputs, generator)
                    g.names = list(out)
                    g.dtypes = [out[k].dtype for k in g.names]
                    g.losses = torch.stack([out[k].float() for k in g.names])
        finally:
            g.delta = difference(host_counts(owner), before)
            advance(owner, g.delta, -1)  # the capture ran nothing
        return g

    @staticmethod
    def _slot(g: _Graph, index: int, base: int, device: torch.device,
              stream):
        """A stand-in for the ``index``-th host function of ``schedules``
        during the capture: each call makes a slot, a 0-d tensor of
        ``g.scalars``, and ``g.slots`` notes the function and the count it
        was called with, as an offset from ``base``, the count at the
        capture.

        The slot is allocated on ``stream``, which fills the slots and
        replays the graph and is not capturing, so the caching allocator
        takes it from its shared pool. A block of the graph's own pool may
        have served a tensor freed earlier in the capture, whose kernels
        would overwrite the host's value in each replay before the slot is
        read. ``empty``: a fill would be a node of the graph."""

        def read(count: int) -> torch.Tensor:
            g.slots.append((index, count - base))
            with torch.cuda.stream(stream):
                g.scalars.append(torch.empty((), dtype=torch.float32,
                                             device=device))
            return g.scalars[-1]
        return read

    def _replay(self, owner, g: _Graph, batches) -> Dict[str, torch.Tensor]:
        global REPLAYS
        for k, v in batches.items():
            g.inputs[k].copy_(v)
        now = schedules(owner)
        values = []
        for index, off in g.slots:
            holder, attribute, count = now[index]
            values.append(float(getattr(holder, attribute)(count + off)))
        for j, v in enumerate(values):
            if g.filled is None or g.filled[j] != v:
                g.scalars[j].fill_(v)  # a kernel on the stream: no sync
        g.filled = values
        anchor = None
        if g.spans and profiling.is_recording():
            anchor = torch.cuda.Event(enable_timing=True)
            anchor.record()
        g.graph.replay()
        advance(owner, g.delta)
        REPLAYS += 1
        if anchor is not None:
            profiling.replayed(g.spans, anchor)
        losses = g.losses.clone()
        return {k: v if v.dtype == dt else v.to(dt)
                for k, v, dt in zip(g.names, losses.unbind(), g.dtypes)}
