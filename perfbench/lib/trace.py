"""Reduction of a ``torch.profiler`` Chrome trace of the traced window to
the numbers the per-layer metrics read.

The window is the host range ``WINDOW`` (``record_function``), which opens
on an idle device and closes on a synchronize. Inside it:
  * ``busy_s``: the union of the intervals in which a kernel, memcpy or
    memset runs (device time, each interval counted once);
  * ``kernel_s``, ``launches``: the kernels' summed time and their count;
  * ``non_gemm_s``: the time of kernels launched outside the convolution
    and matrix-product ops: a kernel's launch (the runtime call with its
    correlation id) is matched to the host ops open around it on its
    thread;
  * ``norm_kernel_s``: kernels whose name holds ``NORM_KERNEL``;
  * ``device_ops``: the kernels with the most time, summed by name;
  * ``idle_gaps``: the longest stretches with nothing on the device, each
    named by the innermost host op or range open when it began.
"""
from __future__ import annotations

import bisect
import json
from collections import defaultdict
from typing import Dict, List, Tuple

WINDOW = "perfbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
GEMM_OPS = frozenset((
    "aten::convolution", "aten::_convolution", "aten::convolution_backward",
    "aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm", "aten::matmul",
    "aten::linear", "aten::addmv", "aten::mv"))
NORM_KERNEL = "modulated_instance_norm"
TOP = 10


def load(path) -> List[dict]:
    with open(path) as f:
        data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data


def union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _host_ops(events: List[dict]) -> Dict[object, list]:
    """Host ops and ranges by thread, as (start, end, name) sorted by start
    (the outer of two that start together first)."""
    by_tid: Dict[object, list] = defaultdict(list)
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in HOST_CATS \
                and e.get("name") != WINDOW:
            a = float(e["ts"])
            by_tid[e.get("tid")].append((a, a + float(e.get("dur", 0)), e["name"]))
    for ops in by_tid.values():
        ops.sort(key=lambda o: (o[0], -o[1]))
    return by_tid


def _under_gemm(ops: list, times: List[float]) -> List[bool]:
    """For each time (ascending) on one thread: whether a convolution or
    matrix-product op is open. One sweep with the stack of open ops."""
    stack: list = []
    gemm = 0
    j = 0
    out = []

    def pop_until(t):
        nonlocal gemm
        while stack and stack[-1][1] < t:
            gemm -= stack.pop()[2] in GEMM_OPS

    for t in times:
        while j < len(ops) and ops[j][0] <= t:
            pop_until(ops[j][0])
            stack.append(ops[j])
            gemm += ops[j][2] in GEMM_OPS
            j += 1
        pop_until(t)
        out.append(gemm > 0)
    return out


def _innermost(by_tid: Dict[object, list], t: float) -> str:
    """The host op or range open at t that began last, on any thread."""
    best = None
    for ops in by_tid.values():
        i = bisect.bisect_right(ops, (t, float("inf"), ""))
        for a, b, name in reversed(ops[max(0, i - 4096):i]):
            if b >= t:
                if best is None or a > best[0]:
                    best = (a, name)
                break
    return best[1] if best else "(no host op open)"


def summarize(events: List[dict]) -> dict:
    window = [e for e in events if e.get("name") == WINDOW
              and e.get("cat") == "user_annotation"]
    if not window:
        raise ValueError(f"the trace has no {WINDOW} range")
    w0 = float(window[0]["ts"])
    w1 = w0 + float(window[0]["dur"])
    device = [e for e in events if e.get("ph") == "X"
              and e.get("cat") in DEVICE_CATS
              and float(e["ts"]) < w1 and float(e["ts"]) + float(e["dur"]) > w0]
    spans = union([(max(float(e["ts"]), w0), min(float(e["ts"]) + float(e["dur"]), w1))
                   for e in device])
    busy_us = sum(b - a for a, b in spans)
    kernels = [e for e in device if e["cat"] == "kernel"]

    launches: Dict[object, list] = defaultdict(list)
    for e in events:
        if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {}):
            launches[e.get("tid")].append((float(e["ts"]), e["args"]["correlation"]))
    host = _host_ops(events)
    gemm_launch = set()
    for tid, calls in launches.items():
        calls.sort()
        flags = _under_gemm(host.get(tid, []), [t for t, _ in calls])
        gemm_launch.update(c for (_, c), f in zip(calls, flags) if f)
    by_name: Dict[str, float] = defaultdict(float)
    non_gemm_us = norm_us = 0.0
    for k in kernels:
        dur = float(k["dur"])
        by_name[k["name"]] += dur
        if NORM_KERNEL in k["name"]:
            norm_us += dur
        if k.get("args", {}).get("correlation") not in gemm_launch:
            non_gemm_us += dur

    edges = [w0] + [t for s in spans for t in s] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[1] - g[0], reverse=True)
    return {
        "window_s": (w1 - w0) / 1e6,
        "busy_s": busy_us / 1e6,
        "kernel_s": sum(float(k["dur"]) for k in kernels) / 1e6,
        "launches": len(kernels),
        "non_gemm_s": non_gemm_us / 1e6,
        "norm_kernel_s": norm_us / 1e6,
        "device_ops": [[name[:200], us / 1e6] for name, us in sorted(
            by_name.items(), key=lambda kv: kv[1], reverse=True)[:TOP]],
        "idle_gaps": [[_innermost(host, a)[:200], (b - a) / 1e6]
                      for a, b in gaps[:TOP]],
    }
