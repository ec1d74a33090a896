"""Tiny versions of the benchmark's configurations and traffic, for the
CPU: the same families and code paths at widths a test can hold, in
float32."""
from __future__ import annotations

import copy

from perfbench.lib import spec

DEFECTGAN = dict(image_size=32, ngf=8, ndf=8, num_res=2, hidden_nc=16,
                 num_layers=2, compute_dtype="float32")

# Serving traffic as a traffic file would give it, and its limits as a cell
# file would: no benchmark cell serves yet, and the harness's serving loop
# is tested here. The limits are those the chip's readings gave for
# requests of 32 images at the published widths (PERF.md, section 2).
SERVE = {"kind": "serve", "batch": 32, "pool": 16, "warmup": 3,
         "trace_steps": 20, "sample": 8}
SERVE_CELL = {"limits": {"out_max_gap": 0.12, "out_mean_gap": 0.015}}


def _resize(schema: dict, old: int, new: int) -> None:
    for s in schema.values():
        s["shape"] = [new if d == old else d for d in s["shape"]]


def config(name: str, **over) -> dict:
    c = copy.deepcopy(spec.load_json(spec.PERFBENCH / "configs" / f"{name}.json"))
    c["model"].update(DEFECTGAN, **over)
    for schema in c["inputs"].values():
        _resize(schema, 256, c["model"]["image_size"])
    c["precision"] = c["model"]["compute_dtype"]
    return c


def traffic(name: str, batch: int = 2, **over) -> dict:
    base = SERVE if name == "serve" else spec.traffic(name)
    return dict(base, batch=batch, **over)


def cell(config_name: str, traffic_name: str) -> dict:
    if traffic_name == "serve":
        return SERVE_CELL
    return spec.cell(f"{config_name}.{traffic_name}")
