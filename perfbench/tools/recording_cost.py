"""What recording the program's spans costs a training cell, in one process:
windows of the cell's steps back to back, in turns with recording off and
inside ``de_i2i_gan_torch.utils.profiling.recording()``, without the torch
profiler, after the cell's warm-up steps.

    python3 perfbench/tools/recording_cost.py --workload <cell> --seed <n> \\
        --seconds 10 --pairs 6 [--out cost.jsonl]

Each window is one JSON line (``recording``, ``steps``, ``seconds``,
``samples_per_s``, and for a recorded window the super-steps its spans
counted); the last line gives each side's median, the on side's change from
the off side's as a share, the change within each pair of windows, and the
host us that one empty span costs off and on.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from perfbench.lib import harness, spec  # noqa: E402


def measure(config: dict, traffic: dict, seed: int, seconds: float,
            pairs: int, device="cuda", emit=print) -> dict:
    """``pairs`` pairs of windows, off then on in even pairs and on then
    off in odd ones; returns the summary line."""
    from de_i2i_gan_torch.utils import profiling

    fam = spec.family(config["family"])
    prog = fam.Program(config, traffic, seed, device)
    first = traffic["warmup"]
    for i in range(first):
        prog.step(i)
    rates = {False: [], True: []}
    for pair in range(pairs):
        for on in ((False, True) if pair % 2 == 0 else (True, False)):
            profiling.reset()
            with profiling.recording() if on else contextlib.nullcontext():
                done, window, _ = harness._train_window(prog, first, seconds,
                                                        device)
            first += done
            rate = done * fam.units_per_step(config, traffic) / window
            rates[on].append(rate)
            line = {"recording": on, "steps": done, "seconds": window,
                    "samples_per_s": rate}
            if on:
                line["recorded_super_steps"] = profiling.report().get(
                    "train.super_step", {}).get("count", 0)
            emit(json.dumps(line))
    profiling.reset()
    off, on = (statistics.median(rates[k]) for k in (False, True))
    pairs = [b / a - 1 for a, b in zip(rates[False], rates[True])]
    return {"device": torch.cuda.get_device_name(0)
            if str(device).startswith("cuda") else "cpu",
            "median_off": off, "median_on": on, "on_change": on / off - 1,
            "pair_changes": pairs,
            "median_pair_change": statistics.median(pairs),
            "span_us": {k: span_us(k) for k in ("off", "on")}}


def span_us(mode: str, n: int = 2000) -> float:
    """Host us to open and close one empty span, recording ``off`` or
    ``on`` (the events then record on the current stream)."""
    from de_i2i_gan_torch.utils import profiling

    with profiling.recording() if mode == "on" else contextlib.nullcontext():
        t0 = time.perf_counter()
        for _ in range(n):
            with profiling.span("recording_cost"):
                pass
        t = time.perf_counter() - t0
    profiling.reset()
    return 1e6 * t / n


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--pairs", type=int, default=6)
    p.add_argument("--out")
    args = p.parse_args(argv)
    bench = spec.benchmark()
    w = spec.workload(bench, args.workload)
    out = open(args.out, "a") if args.out else None

    def emit(line):
        print(line, flush=True)
        if out:
            out.write(line + "\n")

    try:
        emit(json.dumps(measure(spec.config(bench, w["config"]),
                                spec.traffic(w["traffic"]), args.seed,
                                args.seconds, args.pairs, "cuda", emit)))
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
