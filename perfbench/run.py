"""One run of one benchmark cell:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the check lines last on standard error and one JSON object as the
last line of standard output. Fails, printing no result, where the cell's
CUDA devices are missing. Kernel caches stay at fixed paths inside the
checkout (``build/``), so only a checkout's first run builds them.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = str(ROOT / "build" / "perfbench" / sub)

from perfbench.lib.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
