"""DefectGAN's training super-step replayed as one CUDA graph.

An eager super-step makes about 9k kernel launches, each a Python call and
a launch on the host: on a card whose kernels take about 200 ms a
super-step (5 critics, batch 8, 256²), the host sets the pace. A graph
replays the same kernels, in the same order and precision, from one launch.

``DefectGanSteps.super_step`` hands a call here only where ``eligible``
holds, all of it observable from the call: a CUDA device, no process group
(``dp_group``), no ``remat`` (its rerun saves and restores the generator's
state on the host, which a replay cannot repeat), Adam or AdamW (whose
``capturable`` form reads its step and learning rate on the device), and no
generator or a CUDA ``torch.Generator`` that a graph can register. Every
other call runs the eager body as before.

A ``DefectGanSteps`` holds at most one graph (``SuperStepGraph``), for the
first set of the batch's keys, shapes, dtypes and devices (``batch_key``)
that it is called with twice:

  * a key's first call runs eagerly: the capture's warm-up (cuDNN's
    algorithm choice, cuBLAS handles, the norm library's first-use
    attributes, the optimizers' lazy state);
  * its second call captures the eager body
    (``DefectGanSteps._super_step``) into the graph, on the device of the
    steps, and replays it once;
  * later calls copy each row into the graph's static input (one device
    copy a key) and replay;
  * calls of any other key run eagerly: a graph's private memory pool holds
    the step's activations (about 10 GiB at batch 8, 256²), and no caller
    trains on two shapes.

The optimizers of a ``DefectGanSteps`` become ``capturable`` at its first
capture: Adam's step counts move to the device, and in the graph each
update reads its learning rate from a slot of a device tensor of the graph,
which the host fills from the optimizer's schedule before a replay where
the values change (an epoch boundary between two critics moves the critics
after it alone).

What the capture counts on the host (``DefectGanSteps.step``, each
``Optimizer.count``, and every count registered with
``profiling.register_host_counts``, such as the norm kernels' launches) is
taken back after the capture and added again after each replay. The
spans the capture opens become nodes of the graph
(``utils/profiling.py::captured``), and each replay while recording is on
keeps their records with the device ms of that replay
(``profiling.replayed``). Each call returns loss tensors of its own, copied
out of the graph's static outputs in one clone.

The counter sources ``train.graph_replays`` and ``train.eager_super_steps``
count the super-steps that replayed a graph and those that ran eagerly.
"""
from __future__ import annotations

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


def eligible(steps, generator: Optional[torch.Generator]) -> bool:
    """Whether a super-step of ``steps`` with ``generator`` may run as a
    graph; see the module's docstring."""
    return (steps.device.type in GRAPH_DEVICES and steps.dp_group is None
            and not steps.cfg.remat
            and steps.tcfg.optimizer in GRAPHED_OPTIMIZERS
            and (generator is None or (
                isinstance(generator, torch.Generator)
                and generator.device.type == "cuda"))
            and not torch.cuda.is_current_stream_capturing())


def batch_key(batches: Dict[str, torch.Tensor]) -> tuple:
    return tuple((k, tuple(v.shape), v.dtype, v.device)
                 for k, v in batches.items())


def _optimizers(steps) -> List[Tuple[str, object]]:
    return [(n, getattr(steps, f"tx_{n}")) for n in ("D", "G", "E")
            if getattr(steps, f"tx_{n}") is not None]


def host_counts(steps) -> Tuple[Dict[str, int], Dict[str, Dict[str, int]]]:
    """What a super-step advances on the host: the steps' own counts (D
    updates, each optimizer's updates) and the registered host counts."""
    own = {"step": steps.step}
    own.update({n: tx.count for n, tx in _optimizers(steps)})
    return own, profiling.host_counts()


def difference(after, before):
    """``after`` less ``before``, two ``host_counts``."""
    own = {k: v - before[0][k] for k, v in after[0].items()}
    return own, {name: {k: v - before[1][name][k] for k, v in counts.items()}
                 for name, counts in after[1].items()}


def advance(steps, delta, sign: int = 1) -> None:
    """Add ``sign`` times ``delta`` (a ``difference``)."""
    own, registered = delta
    steps.step += sign * own["step"]
    for n, tx in _optimizers(steps):
        tx.count += sign * own[n]
    profiling.add_host_counts({
        name: {k: sign * v for k, v in counts.items()}
        for name, counts in registered.items()})


def make_capturable(steps) -> None:
    """The optimizers' Adam in its ``capturable`` form, once: step counts
    on the parameters' device (a tensor learning rate is set in the
    capture)."""
    for _, tx in _optimizers(steps):
        for group in tx.opt.param_groups:
            if group.get("capturable"):
                continue
            group["capturable"] = True
            for p in group["params"]:
                state = tx.opt.state[p]
                state["step"] = state["step"].to(p.device, torch.float32)


class _Graph:
    """One captured super-step: the graph, its static inputs, its losses
    stacked in one static tensor, its learning-rate slots (each an
    optimizer and an offset from its count at the replay), the spans its
    capture recorded, and what one replay advances on the host."""

    def __init__(self, batches: Dict[str, torch.Tensor], generator):
        self.graph = torch.cuda.CUDAGraph()
        self.generator = generator
        self.inputs = {k: torch.empty_like(v) for k, v in batches.items()}
        self.names: List[str] = []
        self.dtypes: List[torch.dtype] = []
        self.losses: Optional[torch.Tensor] = None
        self.slots: List[Tuple[object, int]] = []
        self.lrs: Optional[torch.Tensor] = None
        self.filled: Optional[List[float]] = None
        self.spans: list = []
        self.delta: tuple = ({}, {})


class SuperStepGraph:
    """The graph of one ``DefectGanSteps`` and the batch keys it has seen.
    It holds no reference to the steps, so dropping them frees the graph
    and its memory pool."""

    def __init__(self):
        self.key: Optional[tuple] = None
        self.graph: Optional[_Graph] = None
        self.seen: set = set()

    def __call__(self, steps, batches: Dict[str, torch.Tensor],
                 generator) -> Optional[Dict[str, torch.Tensor]]:
        """The super-step's losses from the graph, or None where this call
        runs eagerly (a batch key's first call, a key other than the
        graph's, or a generator other than the one the graph registered)."""
        key = batch_key(batches)
        g = self.graph
        if g is None:
            if key not in self.seen:
                self.seen.add(key)
                return None
            with torch.cuda.device(steps.device):
                g = self.graph = self._capture(steps, batches, generator)
            self.key = key
        elif key != self.key or g.generator is not generator:
            return None
        with torch.cuda.device(steps.device):
            return self._replay(steps, g, batches)

    def _capture(self, steps, batches, generator) -> _Graph:
        g = _Graph(batches, generator)
        for k, v in batches.items():
            g.inputs[k].copy_(v)
        make_capturable(steps)
        rows = next(iter(batches.values())).shape[0]
        g.lrs = torch.zeros(rows + 2, dtype=torch.float32, device=steps.device)
        schedules = {tx: tx.schedule for _, tx in _optimizers(steps)}
        for tx in schedules:
            tx.schedule = self._slot(g, tx)
        if generator is not None:
            g.graph.register_generator_state(generator)
        before = host_counts(steps)
        try:
            with profiling.captured() as g.spans, \
                    torch.cuda.graph(g.graph, capture_error_mode="thread_local"):
                out = steps._super_step(g.inputs, generator)
                g.names = list(out)
                g.dtypes = [out[k].dtype for k in g.names]
                g.losses = torch.stack([out[k].float() for k in g.names])
        finally:
            for tx, schedule in schedules.items():
                tx.schedule = schedule
            g.delta = difference(host_counts(steps), before)
            advance(steps, g.delta, -1)  # the capture ran nothing
        return g

    @staticmethod
    def _slot(g: _Graph, tx):
        """A schedule for the capture: each update of ``tx`` takes the next
        slot of ``g.lrs``, and ``g.slots`` notes whose count it reads."""
        base = tx.count

        def schedule(count: int) -> torch.Tensor:
            g.slots.append((tx, count - base))
            return g.lrs[len(g.slots) - 1]
        return schedule

    def _replay(self, steps, g: _Graph, batches) -> Dict[str, torch.Tensor]:
        global REPLAYS
        for k, v in batches.items():
            g.inputs[k].copy_(v)
        lrs = [float(tx.schedule(tx.count + off)) for tx, off in g.slots]
        if lrs != g.filled:
            g.lrs[:len(lrs)].copy_(torch.tensor(lrs, dtype=torch.float32))
            g.filled = lrs
        anchor = None
        if g.spans and profiling.is_recording():
            anchor = torch.cuda.Event(enable_timing=True)
            anchor.record()
        g.graph.replay()
        advance(steps, g.delta)
        REPLAYS += 1
        if anchor is not None:
            profiling.replayed(g.spans, anchor)
        losses = g.losses.clone()
        return {k: v if v.dtype == dt else v.to(dt)
                for k, v, dt in zip(g.names, losses.unbind(), g.dtypes)}
