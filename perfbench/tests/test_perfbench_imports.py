"""Nothing the benchmark runs loads JAX or the JAX package (top-level
module names compared whole), and the reference imports nothing of the
program."""
import ast
import json
import subprocess
import sys
from pathlib import Path

PERFBENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "de_i2i_gan_tpu"}


def _loaded(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=PERFBENCH.parent, capture_output=True, text=True, check=True)
    return set(json.loads(out.stdout.splitlines()[-1]))


def test_entry_and_reference_load_no_jax():
    loaded = _loaded(
        "import perfbench.lib.harness, perfbench.tools.calibrate\n"
        "import perfbench.families.defectgan\n"
        "import de_i2i_gan_torch.train.steps")
    assert not loaded & FORBIDDEN
    assert "de_i2i_gan_torch" in loaded  # the program, which is fine


def test_reference_loads_no_program():
    loaded = _loaded("import perfbench.reference.defectgan.steps")
    assert not loaded & (FORBIDDEN | {"de_i2i_gan_torch"})


def test_reference_sources_import_no_program():
    for path in (PERFBENCH / "reference").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] not in FORBIDDEN | {"de_i2i_gan_torch"}, path


def test_forbidden_modules_whole_names():
    from perfbench.lib import harness
    sys.modules.setdefault("jaxtyping_lookalike", sys)
    try:
        assert "jaxtyping_lookalike" not in harness.forbidden_modules()
    finally:
        del sys.modules["jaxtyping_lookalike"]
