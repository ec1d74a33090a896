"""BENCHMARK.json against the rules its format keeps, and every file the
harness finds by name."""
import re

from perfbench.lib import spec

BENCH = spec.benchmark()


def test_benchmark_file_is_valid():
    assert spec.problems(BENCH) == []


def test_files_found_by_name():
    for w in BENCH["workloads"]:
        config = spec.config(BENCH, w["config"])
        assert spec.family(config["family"]).Program
        traffic = spec.traffic(w["traffic"])
        assert config["inputs"][traffic["kind"]]
        limits = spec.cell(w["name"])["limits"]
        assert limits and all(isinstance(v, float) for v in limits.values())
    for m in BENCH["per_layer"]:
        assert callable(spec.metric_reader(m["name"]))


def test_names_and_units():
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[kind]:
            assert name.match(e["name"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])


def test_every_moved_metric_is_reported():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", [w])
    for w in BENCH["workloads"]:
        reported = spec.metrics_of(BENCH, "end_to_end", w["name"])
        assert {"setup_s", "peak_mem_mib"} <= {m["name"] for m in reported}
        assert len(reported) >= 3
        assert spec.metrics_of(BENCH, "per_layer", w["name"])


def test_problems_found():
    bad = dict(BENCH, run_seconds=60)
    assert "run_seconds" in spec.problems(bad)
    bad = dict(BENCH, per_layer=[dict(BENCH["per_layer"][0], moves="nothing")])
    assert any("moves" in p for p in spec.problems(bad))
