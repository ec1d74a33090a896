"""The port's benchmark: one run of one cell of ``BENCHMARK.json``
(``python perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``). See ``README.md``."""
