"""The port's StarGAN v2 iteration (``StarGANv2Solver.train_step``, AdaIN)
against the benchmark's plain reference (``perfbench/reference/starganv2``)
on the CPU, both in float32, at a small size: 32x32 images, ``max_conv_dim``
64, batch 2, 3 domains, the benchmark family's seeded weights and inputs.
Compared: step 1's loss terms, each network's first gradient (Adam's first
moment after its first update, beta1 0), and every leaf's change over 2
iterations, the EMA copies included.

Both sides start from the family's resumed Adam state (the configuration's
``resume``: one update count, the same second moments drawn from the seed).
A fresh Adam with beta1 = 0 moves every weight by lr * sign(g) at its first
update, so an element whose gradient sits at a kink of a leaky ReLU takes
the other sign on one side and moves by 2 * lr: after D's two updates G's
first gradient then differs by about 0.6% (median leaf) between two float32
computations. From the resumed state an update, lr * g / sqrt(v) with
sqrt(v) near 0.1, is continuous in the gradient, and two float32
computations stay within their reduction order over 2 iterations.
"""
import ast
import copy
import json
import math
import statistics
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from perfbench.lib import compare, harness, spec

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SEED = 2 ** 31 + 5
NETS = ("D", "G", "M", "S")
# (median leaf, worst leaf) of a network's first gradient, in the norms of
# compare.leaf_gaps. D's comes before any update: float32's reduction order
# through R1's double backward, which reads 4e-7 and 3e-6 at most. G's, M's
# and S's follow D's two updates, and the L1 terms (sty, ds, cyc) have
# near-ties: on one thread one element of the 128 of sty flips its sign and
# moves M's median leaf by 1.5e-4; the worst leaf reads 4e-4. A side in
# bfloat16 reads 3e-3 and more for the median leaf.
GRAD_BANDS = {"D": (1e-5, 1e-4), "G": (1e-3, 2e-3), "M": (1e-3, 2e-3),
              "S": (1e-3, 2e-3)}
EMA = ("ema_G", "ema_M", "ema_S")


def small_config() -> dict:
    c = copy.deepcopy(spec.load_json(spec.PERFBENCH / "configs"
                                     / "starganv2_afhq256.json"))
    c["model"].update(img_size=32, max_conv_dim=64, compute_dtype="float32")
    c["precision"] = "float32"
    for s in c["inputs"]["train"].values():
        s["shape"] = [32 if d == 256 else d for d in s["shape"]]
    return c


CONFIG = small_config()
TRAFFIC = dict(spec.traffic("train_b8"), batch=2)
FAM = spec.family("starganv2")


@pytest.fixture(scope="module")
def readings():
    """(program, reference) readings of 2 iterations, with step 1's raw
    loss terms in ``terms``."""
    prog = FAM.Program(CONFIG, TRAFFIC, SEED, "cpu")
    ref = FAM.Reference(CONFIG, TRAFFIC, SEED, "cpu")
    out = []
    for obj in (prog, ref):
        terms = []

        def keep(t, i, terms=terms):
            terms.append(t)
            return t

        r = harness.training_readings(obj, 2, keep)
        r["terms"] = terms[0]
        out.append(r)
    return out


def test_step_one_loss_terms(readings):
    prog, ref = readings
    assert set(prog["terms"]) == set(ref["terms"]) | {"G/lambda_ds"}
    # float32 on both sides, summed in other orders; D's update moves the
    # later terms by float32's rounding of its gradient, 1e-6 of them
    for k, v in ref["terms"].items():
        assert prog["terms"][k] == pytest.approx(v, rel=5e-5, abs=1e-7), k


@pytest.mark.parametrize("net", NETS)
def test_first_gradient(readings, net):
    prog, ref = readings
    assert set(prog["grad"]) == set(ref["grad"])
    kept = [k for k in compare.moved(ref["grad"]) if k.split(".")[0] == net]
    assert kept
    gaps = compare.leaf_gaps(prog["grad"], ref["grad"], kept)
    median, worst = GRAD_BANDS[net]
    assert statistics.median(gaps.values()) <= median, net
    assert max(gaps.values()) <= worst, max(gaps, key=gaps.get)


@pytest.mark.parametrize("net", NETS + EMA)
def test_leaves_after_two_iterations(readings, net):
    prog, ref = readings
    assert set(prog["change"]) == set(ref["change"])
    moved = compare.moved(ref["grad"])
    leaves = [k for k in ref["change"] if k.split(".")[0] == net
              and (k in moved or k.removeprefix("ema_") in moved)]
    assert leaves
    gaps = compare.leaf_gaps(prog["change"], ref["change"], leaves)
    # each update carries the gradients' rounding on, and the EMA's step of
    # 1e-3 of the update is near float32's resolution of a weight: the
    # median leaf reads 3e-4, the worst 1e-2 (an EMA norm scale)
    assert statistics.median(gaps.values()) <= 2e-3, net
    assert max(gaps.values()) <= 3e-2, max(gaps, key=gaps.get)


def test_loss_totals_are_the_updates_losses():
    terms = {f"{n}/{p}_{k}": 1.0 for p in ("latent", "ref")
             for n, ks in (("D", ("real", "fake", "reg")),
                           ("G", ("adv", "sty", "ds", "cyc"))) for k in ks}
    totals = FAM.loss_totals(CONFIG, terms, 50_000)
    # lambda_reg 1, lambda_sty 1, lambda_cyc 1; lambda_ds 2 halved at
    # ds_iter / 2
    assert totals == {"D_latent": 3.0, "D_ref": 3.0, "G_latent": 2.0,
                      "G_ref": 2.0}


def test_weights_and_inputs_as_the_source_draws_them():
    w = FAM.make_weights(CONFIG, TRAFFIC, SEED, "cpu")
    conv = w["G"]["encode_0.conv1.weight"]
    assert conv.std().item() == pytest.approx(
        math.sqrt(2.0 / conv[0].numel()), rel=0.02)
    dense = w["M"]["shared_1.weight"]
    assert dense.std().item() == pytest.approx(math.sqrt(2.0 / 512), rel=0.02)
    assert not w["D"]["head.bias"].any()
    assert w["G"]["to_rgb_norm.scale"].eq(1).all()
    rows = FAM.make_pool(CONFIG, TRAFFIC, SEED, "cpu")
    assert len(rows) == TRAFFIC["pool"]
    r = rows[0]
    assert r["y_src"].dtype == torch.int64 and r["y_src"].shape == (2,)
    assert 0 <= int(r["y_ref"].min()) and int(r["y_ref"].max()) < 3
    z = torch.cat([x["z_ref"] for x in rows] + [x["z_ref2"] for x in rows])
    assert z.shape[1] == 16 and torch.isfinite(z).all()
    assert abs(z.mean().item()) < 0.3 and z.std().item() == pytest.approx(
        1.0, abs=0.2)


def test_norm_calls_of_an_iteration():
    """At the cell's size the reference's iteration runs 96 AdaIN norms, 48
    of them with a backward, as the program's kernels launch."""
    config = spec.load_json(spec.PERFBENCH / "configs" / "starganv2_afhq256.json")
    _, calls = harness.step_cost(FAM, config, spec.traffic("train_b8"))
    assert len(calls) == 96 and sum(b for _, b in calls) == 48


def test_reference_imports_neither_the_port_nor_jax():
    forbidden = {"jax", "jaxlib", "flax", "de_i2i_gan_tpu", "de_i2i_gan_torch"}
    code = ("import perfbench.reference.starganv2.steps, sys, json\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert not set(json.loads(out.stdout.splitlines()[-1])) & forbidden
    for path in (ROOT / "perfbench" / "reference" / "starganv2").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            assert not {n.split(".")[0] for n in names} & forbidden, path
