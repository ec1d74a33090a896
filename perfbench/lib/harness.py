"""One run of one cell: set-up, the measured window, the traced window
(``--trace 1``), the check of what the window produced, and the result
line.

Training cells: the first ``warmup`` steps of the traffic are set-up. They
run through the window's own call on distinct rows of the pool, and the
harness keeps their readings: each step's losses, Adam's first moments
after step 1, and each parameter's change over the steps. The window then
runs steps back to back on the same object and closes on a synchronize.

Serving cells: ``warmup`` requests are set-up. In the window one caller
sends a request, waits for its outputs in host memory, and sends the next;
a seeded sample of the answers is kept.

After the window (and the traced window) the program is freed and the
reference, plain float32 with TF32 off, follows the same steps from the
same weights and inputs, or answers the sampled requests; ``compare``
gives the numbers and ``cells/<workload>.json`` their limits.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import random
import statistics
import sys
import tempfile
import time
import traceback
from typing import Dict, List, Tuple

import torch

from perfbench.lib import compare, flops, inputs, spec
from perfbench.lib import trace as trace_lib

FORBIDDEN = ("jax", "jaxlib", "flax", "de_i2i_gan_tpu")
MIB = 2 ** 20


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _sync(device) -> None:
    if str(device).startswith("cuda"):
        torch.cuda.synchronize()


@contextlib.contextmanager
def float32_exact():
    """TF32 off for matrix products and convolutions."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _floats(metrics: Dict[str, torch.Tensor]) -> Dict[str, float]:
    names = list(metrics)
    values = torch.stack([torch.as_tensor(metrics[k]).detach().double().cpu()
                          for k in names]).tolist()
    return dict(zip(names, values))


def training_readings(obj, steps: int, totals) -> dict:
    """Drive ``obj`` (the program, the reference or a control) through its
    first ``steps`` steps and read what the check compares: each step's
    losses (``totals(terms, step)``), the norms of each network's first
    gradient (Adam's first moment after its first update), each leaf's
    change over the steps."""
    init = {k: v.detach().clone() for k, v in obj.leaves().items()}
    losses, grad = [], {}
    for i in range(steps):
        losses.append(totals(_floats(obj.step(i)), i))
        if i == 0:
            grad = obj.first_moment_norms()
    now = obj.leaves()
    change = compare.norms({k: now[k].detach() - init[k] for k in init})
    return {"losses": losses, "grad": grad, "change": change}


class Reservoir:
    """A uniform sample of ``k`` of the items offered, drawn from the seed."""

    def __init__(self, k: int, seed: int):
        self.k, self.n, self.items = k, 0, []
        self.rng = random.Random(inputs.stream(seed, inputs.SAMPLE))

    def offer(self, index: int, item) -> None:
        self.n += 1
        if len(self.items) < self.k:
            self.items.append((index, item))
        else:
            j = self.rng.randrange(self.n)
            if j < self.k:
                self.items[j] = (index, item)


def _p95(values: List[float]) -> float:
    if len(values) == 1:
        return values[0]
    return statistics.quantiles(values, n=100, method="inclusive")[94]


def _profile(call, first: int, count: int, device) -> dict:
    from torch.profiler import ProfilerActivity, profile, record_function

    _sync(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(trace_lib.WINDOW):
            for j in range(count):
                call(first + j)
            _sync(device)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        return trace_lib.summarize(trace_lib.load(path))


def step_cost(fam, config: dict, traffic: dict) -> Tuple[int, list]:
    """FLOPs of one step or request of the reference at the cell's shapes,
    and its norm calls, counted on the meta device."""
    calls: list = []
    ref = fam.Reference(config, traffic, 0, device="meta", norm_calls=calls)
    with flops.FlopCounter() as counter:
        if traffic["kind"] == "train":
            ref.step(0)
        else:
            ref.answer(0)
    return counter.flops, calls


def reference_readings(fam, config: dict, traffic: dict, seed: int, device,
                       sample=None, precision: str = "float32"):
    """What the reference (or, with ``precision`` float8, the control)
    reads: the first steps of training, or the answers to the sampled
    requests."""
    with float32_exact():
        ref = fam.Reference(config, traffic, seed, device, precision=precision)
        if traffic["kind"] == "train":
            return training_readings(ref, traffic["warmup"],
                                     lambda t, i: fam.loss_totals(config, t, i))
        with torch.no_grad():
            return [ref.answer(i) for i, _ in sample]


def check(fam, config: dict, traffic: dict, cell: dict, seed: int, device,
          program_readings=None, sample=None) -> Dict[str, Tuple[float, str]]:
    """The numbers ``correct`` rests on: the reference against the
    program's readings of training, or its sample of answers."""
    ref = reference_readings(fam, config, traffic, seed, device, sample)
    if traffic["kind"] == "train":
        return compare.training(program_readings, ref,
                                cell.get("median_nets"))
    return compare.answers([a for _, a in sample], ref)


def _train_window(prog, first: int, seconds: float, device) -> Tuple[int, float, int]:
    """Steps back to back from step ``first`` until ``seconds`` have passed,
    then a synchronize. Returns (steps, window seconds, steps with a
    non-finite loss), the last read once the window has closed."""
    outs = []
    t0 = time.perf_counter()
    while True:
        outs.append(prog.step(first + len(outs)))
        if time.perf_counter() - t0 >= seconds:
            break
    _sync(device)
    window = time.perf_counter() - t0
    finite = torch.stack([torch.stack([torch.as_tensor(v).float().reshape(())
                                       .to(device) for v in o.values()])
                          for o in outs]).isfinite().all(dim=1)
    return len(outs), window, int((~finite).sum().item())


def _serve_window(prog, first: int, seconds: float, sample: Reservoir
                  ) -> Tuple[int, float, List[float]]:
    """One caller: each request from ``first`` on waits for its outputs in
    host memory before the next. Returns (requests, window seconds, each
    request's latency)."""
    latencies: List[float] = []
    t0 = t1 = time.perf_counter()
    while t1 - t0 < seconds:
        a = time.perf_counter()
        answer = prog.answer(first + len(latencies))
        t1 = time.perf_counter()
        sample.offer(first + len(latencies), answer)
        latencies.append(t1 - a)
    return len(latencies), t1 - t0, latencies


def _traced(fam, config: dict, traffic: dict, call, first: int, steps: int,
            seconds: float, kind: str, per_layer, device) -> Tuple[dict, dict]:
    """The traced window after the measured one; returns the per-layer
    metrics and the trace's summary."""
    t = _profile(call, first, traffic["trace_steps"], device)
    peaks = spec.load_json(spec.PERFBENCH / "lib" / "peaks.json").get(kind)
    step_flops, calls = step_cost(fam, config, traffic)
    bound = 0.0 if peaks is None else flops.norm_bound_s(
        calls, flops.element_bytes(config["precision"]),
        peaks["hbm_bytes_per_s"], peaks["f32_flops_per_s"])
    summary = {"mode": traffic["kind"], "steps": steps, "seconds": seconds,
               "flops_per_step": step_flops, "norm_bound_s_per_step": bound,
               "peak_flops_per_s": None if peaks is None
               else peaks["bf16_flops_per_s"],
               "trace": t, "traced_steps": traffic["trace_steps"]}
    metrics = {}
    for m in per_layer:
        value = spec.metric_reader(m["name"])(summary)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    return metrics, t


def _judge(numbers: Dict[str, Tuple[float, str]], limits: Dict[str, float],
           failed: int) -> Tuple[bool, dict, List[str]]:
    """``correct``, the numbers compared with their limits, and the lines
    that print them (the numbers without a limit first, as readings)."""
    lines, checks, correct = [], {}, failed == 0
    for name, (value, where) in numbers.items():
        if name not in limits:
            lines.insert(0, f"reading {name} {value!r} (not compared; worst at "
                            f"{where})")
            continue
        limit = limits[name]
        ok = limit is not None and math.isfinite(value) and value <= limit
        correct = correct and ok
        checks[name] = {"value": value, "limit": limit}
        lines.append(f"check {name} {value!r} limit {limit!r} "
                     f"({'ok' if ok else 'FAILED'}; worst at {where})")
    return correct, checks, lines


def run(config: dict, traffic: dict, cell: dict, seed: int,
        seconds: float, trace: bool, device="cuda", t_start=None,
        metric_names=(), per_layer=()) -> Tuple[dict, List[str]]:
    """One run; returns the result line's object and the check lines."""
    t_start = time.perf_counter() if t_start is None else t_start
    on_gpu = str(device).startswith("cuda")
    fam = spec.family(config["family"])
    mode, warm = traffic["kind"], traffic["warmup"]

    prog = fam.Program(config, traffic, seed, device)
    readings = None
    if mode == "train":
        readings = training_readings(
            prog, warm, lambda t, i: fam.loss_totals(config, t, i))
    else:
        for i in range(warm):
            prog.answer(i)
    _sync(device)
    if on_gpu:
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start

    sample = Reservoir(traffic.get("sample", 0), seed)
    latencies: List[float] = []
    failed = 0
    if mode == "train":
        done, window, failed = _train_window(prog, warm, seconds, device)
    else:
        done, window, latencies = _serve_window(prog, warm, seconds, sample)
    peak = torch.cuda.max_memory_allocated() if on_gpu else 0

    kind = torch.cuda.get_device_name(0) if on_gpu else "cpu"
    dev = {"platform": "gpu" if on_gpu else "cpu", "kind": kind, "count": 1,
           "memory_peak_bytes": int(peak)}
    result: dict = {"correct": False, "attempted": done, "failed": failed}
    if trace:
        call = prog.step if mode == "train" else prog.answer
        metrics, t = _traced(fam, config, traffic, call, warm + done, done,
                             window, kind, per_layer, device)
        dev.update(busy_s=t["busy_s"], window_s=t["window_s"])
        result["breakdown"] = {"device_ops": t["device_ops"],
                               "idle_gaps": t["idle_gaps"]}
    else:
        rate = done * fam.units_per_step(config, traffic) / window
        values = {"setup_s": setup_s, "peak_mem_mib": peak / MIB,
                  "train_samples_per_s": rate, "serve_images_per_s": rate,
                  "serve_p95_ms": 1e3 * _p95(latencies) if latencies else None}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in metric_names}
    result["metrics"] = metrics
    result["device"] = dev

    prog.release()
    del prog
    if on_gpu:
        torch.cuda.empty_cache()
    numbers = check(fam, config, traffic, cell, seed, device, readings,
                    sample.items)
    result["correct"], result["checks"], lines = _judge(numbers, cell["limits"],
                                                        failed)
    return result, lines


def main(argv=None, t_start=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    try:
        bench = spec.benchmark()
        w = spec.workload(bench, args.workload)
        if not torch.cuda.is_available() or torch.cuda.device_count() < w["chips"]:
            print(f"perfbench: {args.workload} needs {w['chips']} CUDA "
                  f"device(s); this machine has "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 3
        result, lines = run(
            spec.config(bench, w["config"]), spec.traffic(w["traffic"]),
            spec.cell(w["name"]), args.seed, args.seconds,
            bool(args.trace), "cuda", t_start,
            spec.metrics_of(bench, "end_to_end", w["name"]),
            spec.metrics_of(bench, "per_layer", w["name"]))
    except Exception:
        traceback.print_exc()
        return 1
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: the run loaded {bad}; nothing it runs may",
              file=sys.stderr)
        return 4
    sys.stdout.flush()
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0
