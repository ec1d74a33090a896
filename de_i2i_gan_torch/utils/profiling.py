"""Tracing: the port's spans and counters, and the operator's Chrome trace.

- ``span(name)``: a context manager around one layer's work. It records
  only while recording is on: while a ``torch.profiler`` profile is active,
  or inside ``recording()``. Off, it is one state check and returns a
  shared no-op context: no profiler range, no CUDA event, no allocation.
  A recording span keeps
    * inside a profiler, a ``torch.profiler.record_function`` range of its
      name, so it sits in the Chrome trace beside the kernels it launched
      (outside one a range has no reader, and open ranges cost a
      DefectGAN training step on an H100 about 2.5%: ``recording()``
      alone opens none);
    * its host start and duration (``time.perf_counter_ns``);
    * where CUDA is in use and the current stream is not capturing a graph,
      two timing ``torch.cuda.Event``s on the current stream: the span's
      time on the device clock, from its first to its last work, idle
      inside it included (inside ``captured()``, external timing events
      that become nodes of the graph);
    * its parent (the span open on this thread when it opened) and its
      root (the outermost such span), so every span of one step shares the
      root's id;
    * the change, over its extent, of every registered counter source.
- ``register_counter(name, read)``: a counter source, ``read()`` giving the
  counter's running total (the norm kernels register ``norm.launches``, the
  pad kernels ``pad.launches``, ``nn/conv_grad.py`` the second backward
  calls of its convolution, ``conv.double_backward``).
- ``register_host_counts(name, read, add)``: counts the host keeps as it
  launches work, which a CUDA graph's replay does not move: ``read()``
  gives them as a dict, ``add(delta)`` adds such a dict to them. A module
  whose counter source reads such counts registers them here too, and
  ``train/graphed.py`` takes back what a capture counted and adds it again
  after each replay, for every registration (``host_counts()``,
  ``add_host_counts(delta)``).
- ``captured()`` and ``replayed(spans, anchor)``: the spans of a CUDA
  graph. Inside ``captured()`` every span records (recording is forced
  on) into a list of its own, not the registry, its edges timing events
  captured into the graph; after each replay, while recording is on,
  ``replayed`` keeps a record of each of them, nested as at capture under
  the span open at the replay, its counters as at capture, no host time,
  and its device ms read from the graph's events (``train/graphed.py``
  replays DefectGAN's super-step and StarGAN v2's iteration so).
- ``report()``: by span name, the count, the summed host and device ms,
  the self ms on each clock (a span's duration less the part of it its
  child spans cover) and the summed counter changes. Events are resolved
  to ms only here, so no span synchronizes. ``records()`` gives each
  span, ``dropped()`` how many spans the cap turned away, ``reset()``
  empties the registry.
- ``trace(log_dir)``: ``torch.profiler`` over a code region (the CPU, and
  the card when there is one), written as ``<log_dir>/trace.json``, with
  the region's spans and their report in ``<log_dir>/spans.json``.

The registry is one per process (``REGISTRY``): spans open deep inside the
models and trainers, where no caller could hand one down.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import threading
import time
from pathlib import Path
from typing import Callable, Dict, List

import torch

CAP = 1 << 16  # spans kept; later ones are dropped and counted

_profiler_enabled = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()


class _Span:
    """One recording span; becomes its record when it closes."""

    __slots__ = ("reg", "name", "id", "parent", "root", "range",
                 "t0", "host_ns", "events", "start_counts", "counters",
                 "device_ms", "device_start_ms")

    def __init__(self, reg: "Registry", name: str):
        self.reg, self.name = reg, name

    def __enter__(self):
        reg = self.reg
        stack = reg._stack()
        self.id = next(reg._ids)
        self.parent = stack[-1].id if stack else None
        self.root = stack[0].id if stack else self.id
        stack.append(self)
        self.range = None
        if _profiler_enabled():
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        self.start_counts = {k: read() for k, read in reg.sources.items()}
        self.events = None
        if torch.cuda.is_initialized():
            if not torch.cuda.is_current_stream_capturing():
                self.events = (torch.cuda.Event(enable_timing=True),
                               torch.cuda.Event(enable_timing=True))
            elif reg._capture() is not None:
                # external: the capture records them as nodes of the graph
                self.events = (
                    torch.cuda.Event(enable_timing=True, external=True),
                    torch.cuda.Event(enable_timing=True, external=True))
            if self.events is not None:
                self.events[0].record()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.host_ns = time.perf_counter_ns() - self.t0
        if self.events is not None:
            self.events[1].record()
        reg = self.reg
        self.counters = {k: read() - self.start_counts[k]
                         for k, read in reg.sources.items()
                         if k in self.start_counts}
        if self.range is not None:
            self.range.__exit__(*exc)
        self.range = self.start_counts = None
        self.device_ms = self.device_start_ms = None
        reg._stack().pop()
        reg._keep(self)
        return False


def _self_ms(spans: List[_Span], start, duration) -> Dict[int, float]:
    """Each span's duration less the union of its children's intervals
    (clipped to its own), on the clock that ``start`` and ``duration``
    read; spans with no reading on that clock are left out."""
    kids: Dict[int, list] = {}
    for s in spans:
        if s.parent is not None and duration(s) is not None:
            kids.setdefault(s.parent, []).append(
                (start(s), start(s) + duration(s)))
    out = {}
    for s in spans:
        d = duration(s)
        if d is None:
            continue
        end, covered = start(s) + d, 0.0
        reach = start(s)
        for lo, hi in sorted(kids.get(s.id, [])):
            lo, hi = max(lo, reach), min(hi, end)
            if hi > lo:
                covered += hi - lo
                reach = hi
        out[s.id] = d - covered
    return out


class Registry:
    """Spans and counter sources of one process; see the module's
    docstring."""

    def __init__(self, cap: int = CAP):
        self.cap = cap
        self.sources: Dict[str, Callable[[], float]] = {}
        self.host: Dict[str, tuple] = {}  # name: (read, add)
        self._forced = 0
        self._local = threading.local()
        self._ids = itertools.count()
        self._records: List[_Span] = []
        self._dropped = 0
        self._ref = None  # the device clock's zero: a kept start event
        self._lock = threading.Lock()

    def is_recording(self) -> bool:
        return bool(self._forced) or _profiler_enabled()

    def span(self, name: str):
        if self._forced or _profiler_enabled():
            return _Span(self, name)
        return _OFF

    @contextlib.contextmanager
    def recording(self):
        with self._lock:
            self._forced += 1
        try:
            yield self
        finally:
            with self._lock:
                self._forced -= 1

    @contextlib.contextmanager
    def captured(self):
        """Every span this thread opens inside records, into the yielded
        list and not the registry: a CUDA graph's capture. Their timing
        events are nodes of the graph; see ``replayed``."""
        spans: List[_Span] = []
        self._local.capture = spans
        try:
            with self.recording():
                yield spans
        finally:
            self._local.capture = None

    def replayed(self, spans: List[_Span], anchor) -> None:
        """While recording is on, a record of each of ``spans`` (what a
        ``captured()`` capture recorded) for one replay of its graph: ids of
        their own, nested as at capture, their top level under the span
        open on this thread; their counters as at capture; 0 host ms; device
        ms read from the graph's events, placed on the device clock after
        ``anchor``, an event recorded before the replay on its stream.
        Synchronizes the device first: the next replay records the same
        events again."""
        if not spans or not self.is_recording():
            return
        if any(s.events is not None for s in spans):
            torch.cuda.synchronize()
        stack = self._stack()
        top = stack[-1] if stack else None
        t0 = time.perf_counter_ns()
        ids: Dict[int, int] = {}
        roots: Dict[int, int] = {}
        for s in sorted(spans, key=lambda s: s.id):
            r = _Span(self, s.name)
            r.id = ids[s.id] = next(self._ids)
            r.parent = ids.get(s.parent, None if top is None else top.id)
            r.root = (r.id if r.parent is None else
                      roots.get(r.parent, None if top is None else top.root))
            roots[r.id] = r.root
            r.t0, r.host_ns, r.counters = t0, 0, dict(s.counters)
            r.range = r.start_counts = None
            r.events = r.device_ms = r.device_start_ms = None
            if s.events is not None:
                start, end = s.events
                r.events = (anchor, None)
                r.device_start_ms = anchor.elapsed_time(start)
                r.device_ms = start.elapsed_time(end)
            self._keep(r)

    def register_counter(self, name: str, read: Callable[[], float]) -> None:
        self.sources[name] = read

    def register_host_counts(self, name: str,
                             read: Callable[[], Dict[str, int]],
                             add: Callable[[Dict[str, int]], None]) -> None:
        self.host[name] = (read, add)

    def host_counts(self) -> Dict[str, Dict[str, int]]:
        """Every registration's counts, by its name."""
        return {name: read() for name, (read, _) in self.host.items()}

    def add_host_counts(self, delta: Dict[str, Dict[str, int]]) -> None:
        """Adds ``delta`` (a difference of two ``host_counts``) to them."""
        for name, counts in delta.items():
            self.host[name][1](counts)

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _capture(self):
        return getattr(self._local, "capture", None)

    def _keep(self, span: _Span) -> None:
        capture = self._capture()
        if capture is not None:
            capture.append(span)
            return
        with self._lock:
            if len(self._records) < self.cap:
                self._records.append(span)
            else:
                self._dropped += 1

    def reset(self) -> None:
        with self._lock:
            self._records = []
            self._dropped = 0
            self._ref = None

    def dropped(self) -> int:
        return self._dropped

    def _resolve(self, records: List[_Span]) -> None:
        """Device ms of each record whose events are not read yet; starts
        from the start event of the first span read since the last reset.
        A replayed record (``replayed``) holds its anchor and no end: its
        ms are read already, its start from the anchor."""
        todo = [r for r in records if r.events is not None]
        if not todo:
            return
        torch.cuda.synchronize()
        if self._ref is None:
            self._ref = min(todo, key=lambda r: r.id).events[0]
        for r in todo:
            start, end = r.events
            base = self._ref.elapsed_time(start)
            if end is None:
                r.device_start_ms += base
            else:
                r.device_start_ms = base
                r.device_ms = start.elapsed_time(end)
            r.events = None

    def records(self) -> List[dict]:
        """Each kept span in the order it opened, its times in ms."""
        with self._lock:
            spans = sorted(self._records, key=lambda r: r.id)
        self._resolve(spans)
        t0 = spans[0].t0 if spans else 0
        return [{"id": r.id, "name": r.name, "parent": r.parent,
                 "root": r.root,
                 "host_start_ms": (r.t0 - t0) / 1e6, "host_ms": r.host_ns / 1e6,
                 "device_start_ms": r.device_start_ms,
                 "device_ms": r.device_ms, "counters": dict(r.counters)}
                for r in spans]

    def report(self) -> Dict[str, dict]:
        """By span name: ``count``, ``host_ms``, ``self_host_ms``,
        ``device_ms`` and ``self_device_ms`` (None where the spans have no
        device events), ``counters`` (summed changes by source)."""
        with self._lock:
            spans = list(self._records)
        self._resolve(spans)
        self_host = _self_ms(spans, lambda r: r.t0 / 1e6,
                             lambda r: r.host_ns / 1e6)
        self_dev = _self_ms(spans, lambda r: r.device_start_ms,
                            lambda r: r.device_ms)
        out: Dict[str, dict] = {}
        for r in spans:
            e = out.setdefault(r.name, {
                "count": 0, "host_ms": 0.0, "self_host_ms": 0.0,
                "device_ms": 0.0, "self_device_ms": 0.0, "counters": {}})
            e["count"] += 1
            e["host_ms"] += r.host_ns / 1e6
            e["self_host_ms"] += self_host[r.id]
            if r.device_ms is None or e["device_ms"] is None:
                e["device_ms"] = e["self_device_ms"] = None
            else:
                e["device_ms"] += r.device_ms
                e["self_device_ms"] += self_dev[r.id]
            for k, v in r.counters.items():
                e["counters"][k] = e["counters"].get(k, 0) + v
        return out


REGISTRY = Registry()
span = REGISTRY.span
recording = REGISTRY.recording
is_recording = REGISTRY.is_recording
captured = REGISTRY.captured
replayed = REGISTRY.replayed
register_counter = REGISTRY.register_counter
register_host_counts = REGISTRY.register_host_counts
host_counts = REGISTRY.host_counts
add_host_counts = REGISTRY.add_host_counts
report = REGISTRY.report
records = REGISTRY.records
dropped = REGISTRY.dropped
reset = REGISTRY.reset


@contextlib.contextmanager
def trace(log_dir: str | Path = "./logs/torch_trace"):
    """Profile the region (CPU, and CUDA when available) and write
    ``<log_dir>/trace.json`` and ``<log_dir>/spans.json`` (the region's
    span records, their report and the count dropped); yields the
    profiler. The registry is emptied on entry."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    reset()
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(log_dir / "trace.json"))
    spans = {"records": records(), "report": report(), "dropped": dropped()}
    (log_dir / "spans.json").write_text(json.dumps(spans, indent=1))
