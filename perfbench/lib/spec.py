"""Finds what ``BENCHMARK.json`` names, by name: a workload's
configuration file, its traffic mix (``traffic/<traffic>.json``), its
correctness limits (``cells/<workload>.json``), the family module that
drives the program and its reference (``families/<family>.py``, the
family named in the configuration file) and each per-layer metric's reader
(``metrics/<metric>.py``). ``problems`` checks the file against the rules
of its format: names, units, sources, bounds, and that every file it names
exists."""
from __future__ import annotations

import importlib
import importlib.util
import json
import re
from pathlib import Path
from typing import Callable, Dict, List

PERFBENCH = Path(__file__).resolve().parents[1]
ROOT = PERFBENCH.parent

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
E2E_SOURCES = ("host_clock", "device_trace")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
TOP_KEYS = ("command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload named {name!r} in BENCHMARK.json")


def config(bench: dict, name: str, root: Path = ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return load_json(root / c["file"])
    raise KeyError(f"no configuration named {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    return load_json(PERFBENCH / "traffic" / f"{name}.json")


def cell(name: str) -> dict:
    return load_json(PERFBENCH / "cells" / f"{name}.json")


def family(name: str):
    if not NAME.match(name) or "." in name:
        raise ValueError(f"bad family name {name!r}")
    return importlib.import_module(f"perfbench.families.{name}")


def metric_reader(name: str) -> Callable[[dict], object]:
    """``read(summary)`` of ``metrics/<name>.py``: the metric's value, or
    None where the run has nothing for it to read."""
    path = PERFBENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def metrics_of(bench: dict, kind: str, workload_name: str) -> List[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics a workload reports."""
    return [m for m in bench[kind]
            if workload_name in m.get("workloads", [workload_name])]


def _one_line(s, limit=200) -> bool:
    return (isinstance(s, str) and 1 <= len(s) <= limit and "\n" not in s
            and "\t" not in s)


def problems(bench: dict, root: Path = ROOT) -> List[str]:
    """What in ``bench`` breaks the rules of its format (an empty list
    when nothing does)."""
    out: List[str] = []
    if tuple(sorted(bench)) != tuple(sorted(TOP_KEYS)):
        out.append(f"top-level keys {sorted(bench)}")
    cmd, paths = bench.get("command", []), bench.get("paths", [])
    if not (1 <= len(cmd) <= 32 and all(_one_line(w) for w in cmd)):
        out.append("command")
    if not (1 <= len(paths) <= 16 and all(PATH.match(p) and not p.startswith("/")
                                           and ".." not in p for p in paths)):
        out.append("paths")
    rs = bench.get("run_seconds")
    if not (isinstance(rs, int) and 1 <= rs <= 51):
        out.append("run_seconds")
    configs = {c["name"]: c for c in bench.get("configs", [])}
    workloads = {w["name"]: w for w in bench.get("workloads", [])}
    seen: Dict[tuple, int] = {}
    for kind, keys in (("configs", {"name", "source", "file", "reduced", "why"}),
                       ("workloads", {"name", "config", "traffic", "chips", "why"}),
                       ("end_to_end", {"name", "unit", "better", "bound", "source"}),
                       ("per_layer", {"name", "unit", "better", "source", "layer",
                                      "moves"})):
        metric = kind in ("end_to_end", "per_layer")
        for e in bench.get(kind, []):
            extra = set(e) - keys - ({"workloads"} if metric else set())
            if extra or keys - set(e):
                out.append(f"{kind} {e.get('name')}: keys {sorted(e)}")
            if not NAME.match(str(e.get("name", ""))):
                out.append(f"{kind} name {e.get('name')!r}")
            key = ("metric" if metric else kind, e.get("name"))
            seen[key] = seen.get(key, 0) + 1
    out += [f"duplicate name {k}" for k, n in seen.items() if n > 1]
    for c in configs.values():
        f = root / c["file"]
        if not f.exists() or not any(c["file"].startswith(p.rstrip("/") + "/")
                                     for p in paths):
            out.append(f"config file {c['file']}")
        if not (_one_line(c["source"]) and _one_line(c["why"])
                and len(c["reduced"]) <= 16
                and all(NAME.match(k) for k in c["reduced"])):
            out.append(f"config {c['name']} source/why/reduced")
        if not any(w["config"] == c["name"] for w in workloads.values()):
            out.append(f"config {c['name']} is used by no workload")
    if not 1 <= len(configs) <= 24 or not 1 <= len(workloads) <= 24:
        out.append("number of configs or workloads")
    pairs = set()
    for w in workloads.values():
        if w["config"] not in configs or w["chips"] not in (1, 4) \
                or not NAME.match(w["traffic"]) or not _one_line(w["why"]):
            out.append(f"workload {w['name']}")
        if (w["config"], w["traffic"]) in pairs:
            out.append(f"workload {w['name']}: pair repeated")
        pairs.add((w["config"], w["traffic"]))
        if not (PERFBENCH / "traffic" / f"{w['traffic']}.json").exists():
            out.append(f"traffic file of {w['name']}")
        if not (PERFBENCH / "cells" / f"{w['name']}.json").exists():
            out.append(f"cell file of {w['name']}")
    e2e = {m["name"]: m for m in bench.get("end_to_end", [])}
    if "setup_s" not in e2e or not 1 <= len(e2e) <= 16:
        out.append("end_to_end: setup_s or count")
    for m in list(e2e.values()) + bench.get("per_layer", []):
        if not UNIT.match(m.get("unit", "")) or m.get("better") not in (
                "lower", "higher"):
            out.append(f"metric {m['name']}: unit or better")
        for w in m.get("workloads", []):
            if w not in workloads:
                out.append(f"metric {m['name']}: unknown workload {w}")
    for m in e2e.values():
        if m["source"] not in E2E_SOURCES or not (
                isinstance(m["bound"], (int, float)) and 0.01 <= m["bound"] <= 0.25):
            out.append(f"end_to_end {m['name']}: source or bound")
    per_layer = bench.get("per_layer", [])
    if not 1 <= len(per_layer) <= 128:
        out.append("per_layer count")
    for m in per_layer:
        if m["source"] not in SOURCES or not _one_line(m["layer"]) \
                or m["moves"] not in e2e:
            out.append(f"per_layer {m['name']}: source, layer or moves")
            continue
        moved = e2e[m["moves"]]
        for w in m.get("workloads", list(workloads)):
            if w not in moved.get("workloads", list(workloads)):
                out.append(f"per_layer {m['name']}: {w} does not report "
                           f"{m['moves']}")
        if not (PERFBENCH / "metrics" / f"{m['name']}.py").exists():
            out.append(f"per_layer {m['name']}: no reader")
    for w in workloads:
        reported = [m for m in e2e.values()
                    if w in m.get("workloads", list(workloads))]
        if len(reported) < 2 or not any(
                w in m.get("workloads", list(workloads)) for m in per_layer):
            out.append(f"workload {w} reports too few metrics")
    return out
