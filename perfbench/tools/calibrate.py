"""Readings that the correctness limits are set from, at a cell's own size
on the chip, in one process:

  * the program's numbers on each of ``--seeds`` (the lower readings);
  * the control's on each of ``--control-seeds``: the reference computed
    in float8 in the program's place (the upper readings);
  * the witness's on each of ``--witness-seeds``: the reference in
    bfloat16, as plain PyTorch would compute it;
  * for training cells, the program with half of each batch left out on
    each of ``--fault-seeds``.

    python3 perfbench/tools/calibrate.py --workload <cell> --seeds 1,2,3 \\
        --control-seeds 4,5,6 --witness-seeds 7,8,9 --fault-seeds 10,11,12 \\
        [--out readings.jsonl]

Each reading is one JSON line, on standard output and in ``--out``, with
the numbers and, for training, each step's losses and every leaf's norms
on both sides.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from perfbench.lib import compare, harness, spec  # noqa: E402


def halve(rows: dict, batch: int) -> dict:
    """Each array cut to the first half of its batch axis."""
    out = {}
    for k, v in rows.items():
        axis = list(v.shape).index(batch)
        out[k] = v.narrow(axis, 0, batch // 2)
    return out


def readings(fam, config, traffic, seed, device, kind):
    """The readings of the program (``kind`` program), of the control
    (control: the reference in float8), of a witness (witness: the
    reference with its convolutions and dense layers in bfloat16) or of the
    program with half of each batch (half)."""
    if kind in ("control", "witness"):
        obj = fam.Reference(config, traffic, seed, device,
                            precision="float8" if kind == "control" else "bfloat16")
    else:
        obj = fam.Program(config, traffic, seed, device)
        if kind == "half":
            rows = obj.rows
            obj.rows = lambda i: halve(rows(i), traffic["batch"])
    with harness.float32_exact() if kind in ("control", "witness") else torch.enable_grad():
        if traffic["kind"] == "train":
            out = harness.training_readings(
                obj, traffic["warmup"], lambda t, i: fam.loss_totals(config, t, i))
        else:
            with torch.no_grad():
                out = [(i, tuple(t.cpu() for t in obj.answer(i)))
                       for i in range(traffic["sample"])]
    del obj
    torch.cuda.empty_cache()
    return out


def reading(fam, config, traffic, cell, seed, device, kind) -> dict:
    got = readings(fam, config, traffic, seed, device, kind)
    if traffic["kind"] == "train":
        ref = harness.reference_readings(fam, config, traffic, seed, device)
        nums = compare.training(got, ref, cell.get("median_nets"))
        extra = {"loss_gap_by_step": [
            compare.loss_gap([a], [b]) for a, b in zip(got["losses"], ref["losses"])],
            "losses": got["losses"], "ref_losses": ref["losses"],
            "grad": got["grad"], "ref_grad": ref["grad"],
            "change": got["change"], "ref_change": ref["change"]}
    else:
        ref = harness.reference_readings(fam, config, traffic, seed, device, got)
        nums = compare.answers([a for _, a in got], ref)
        extra = {}
    return {"numbers": {k: v[0] for k, v in nums.items()},
            "where": {k: v[1] for k, v in nums.items()}, **extra}


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--witness-seeds", default="")
    p.add_argument("--out")
    args = p.parse_args()
    bench = spec.benchmark()
    w = spec.workload(bench, args.workload)
    config, traffic = spec.config(bench, w["config"]), spec.traffic(w["traffic"])
    fam = spec.family(config["family"])
    out = open(args.out, "a") if args.out else None
    plan = [("program", s) for s in args.seeds.split(",") if s]
    plan += [("control", s) for s in args.control_seeds.split(",") if s]
    plan += [("witness", s) for s in args.witness_seeds.split(",") if s]
    if traffic["kind"] == "train":
        plan += [("half", s) for s in args.fault_seeds.split(",") if s]
    for kind, s in plan:
        t0 = time.perf_counter()
        got = reading(fam, config, traffic, spec.cell(w["name"]), int(s), "cuda", kind)
        line = json.dumps({"workload": args.workload, "kind": kind, "seed": int(s),
                           **got, "seconds": time.perf_counter() - t0,
                           "device": torch.cuda.get_device_name(0)})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
