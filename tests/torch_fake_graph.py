"""Stand-ins that run ``de_i2i_gan_torch/train/graphed.py``'s graph path on
the CPU, so that its host logic (which calls engage, the host-float slots,
the counts it takes back and adds, the counters, the spans) is tested where
no card is, for either owner: ``DefectGanSteps`` or ``StarGANv2Solver``.

``install(monkeypatch)`` lets CPU owners engage the path (``GRAPH_DEVICES``
takes the CPU; Adam keeps its CPU form) and puts ``FakeGraph`` in place of
``torch.cuda.CUDAGraph``:

  * its capture runs the body on the CPU and then puts back every tensor
    of the owner and the random state, since a capture runs nothing;
  * its ``replay`` runs the body again on the graph's static inputs, each
    host float (a learning rate, StarGAN v2's ``lambda_ds``) read from the
    graph's slots in order (as a float, so that the CPU arithmetic is
    eager's), writes the losses into the static output and takes back what
    the rerun did on the host (counts, spans), since a replay does nothing
    there.
"""
from __future__ import annotations

import contextlib

import torch

from de_i2i_gan_torch.train import graphed
from de_i2i_gan_torch.utils import profiling

NETS = ("G", "E", "M", "S", "D", "ema_G", "ema_M", "ema_S")


def _tensors(steps):
    """Every tensor an iteration moves: parameters, buffers, optimizer
    state."""
    out = []
    for n in NETS:
        net = getattr(steps, n, None)
        if net is not None:
            out += list(net.parameters()) + list(net.buffers())
    for _, tx in steps.graph_optimizers():
        for p in tx.params:
            out += [v for v in tx.opt.state[p].values()
                    if isinstance(v, torch.Tensor)]
    return out


@contextlib.contextmanager
def nothing_runs(steps, generator):
    """The block's effect on the steps' tensors and the random state,
    taken back."""
    tensors = _tensors(steps)
    saved = [t.detach().clone() for t in tensors]
    rng = torch.get_rng_state()
    gen = None if generator is None else generator.get_state()
    try:
        yield
    finally:
        with torch.no_grad():
            for t, v in zip(tensors, saved):
                t.copy_(v)
        torch.set_rng_state(rng)
        if generator is not None:
            generator.set_state(gen)


def _host(steps):
    """The steps' counts and the registered host counts, read here and not
    through ``graphed``, so that a count ``graphed`` leaves out shows."""
    own = [steps.step] + [tx.count for _, tx in steps.graph_optimizers()]
    return own, profiling.host_counts()


def _take_back(steps, before):
    """Puts the counts back to ``before``: a replay counts nothing on the
    host."""
    registered = profiling.host_counts()
    steps.step = before[0][0]
    for (_, tx), count in zip(steps.graph_optimizers(), before[0][1:]):
        tx.count = count
    profiling.add_host_counts({
        name: {k: before[1][name][k] - v for k, v in counts.items()}
        for name, counts in registered.items()})


class FakeGraph:
    """``reads``: each host float a replay read, as (attribute, value)."""

    def __init__(self):
        self.steps = self.g = None
        self.reads = []

    def register_generator_state(self, generator):
        pass

    def replay(self):
        steps, g = self.steps, self.g
        slots = iter(g.scalars)

        def reader(attribute):
            def read(count):
                value = float(next(slots))
                self.reads.append((attribute, value))
                return value
            return read

        before = _host(steps)
        try:
            with contextlib.ExitStack() as stack:
                for holder, attribute, _ in graphed.schedules(steps):
                    stack.enter_context(graphed._swapped(
                        holder, attribute, reader(attribute)))
                with profiling.captured():
                    out = steps._super_step(g.inputs, g.generator)
        finally:
            _take_back(steps, before)
        with torch.no_grad():
            g.losses.copy_(torch.stack([out[k].float() for k in g.names]))


class _Event:
    def __init__(self, *args, **kw):
        pass

    def record(self, stream=None):
        pass


def install(monkeypatch) -> None:
    capture = graphed.SuperStepGraph._capture

    def fake_capture(self, steps, batches, generator):
        with nothing_runs(steps, generator):
            g = capture(self, steps, batches, generator)
        g.graph.steps, g.graph.g = steps, g
        return g

    monkeypatch.setattr(graphed, "GRAPH_DEVICES", ("cuda", "cpu"))
    monkeypatch.setattr(graphed, "make_capturable", lambda steps: None)
    monkeypatch.setattr(graphed.SuperStepGraph, "_capture", fake_capture)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda *a, **kw: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "device",
                        lambda *a, **kw: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a, **kw: None)
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda *a, **kw: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "Event", _Event)
