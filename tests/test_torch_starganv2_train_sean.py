"""One whole StarGAN v2 SEANv2 ``train_step`` in both packages, and one with
DiffAugment fed the JAX package's draws, from one continued JAX
``SolverState`` (``tests/test_torch_starganv2_train_step.py``).

SEAN runs the reference pass alone: one D update and one G update. The G
pass tracks the style codes of x_fake and x_fake2 into G's statistics; the
step then moves ``ema_G``'s statistics, all five buffers (the accumulators
too), toward G's by 1 - beta. No frozen ViT is attached here, so the style
term is inactive, as the JAX suite runs it (``allow_degraded_losses``);
``tests/test_torch_starganv2_frozen.py`` holds the term with the ViT.

Compared as in the AdaIN file: the metrics (rtol 2e-4), each net's update
and Adam moments per tensor (``STEP_REL``), the counts, the EMA generator
(1e-6) and ``step``; besides, G's and ema_G's SEAN statistics (1e-5).
The DiffAugment run (every policy on D's real and fake batches and on the
G pass's fakes) takes the draws the JAX step makes from its keys: the
step's second key for the D pass (its first subkey for the real images,
the second for the fakes), its fourth for the G pass (its first subkey).
"""
import torch

import jax

from de_i2i_gan_torch.utils import diffaug
from tests.test_torch_starganv2_train import BATCH, IMG, close_sean_stats
from tests.test_torch_starganv2_train_step import check_step, step_run
from tests.test_torch_train_options import jax_draws

torch.set_num_threads(1)

POLICY = "color,translation,cutout"


def check_sean_step(run):
    state, after, jmetrics, port, metrics = run
    check_step(state, after, jmetrics, port, metrics, nets=("G", "D"),
               passes=1)
    assert sorted(metrics) == sorted(
        [f"D/ref_{k}" for k in ("real", "fake", "reg")] +
        [f"G/ref_{k}" for k in ("adv", "sty", "ds", "cyc")] + ["G/lambda_ds"])
    assert metrics["G/ref_sty"].item() == 0.0
    close_sean_stats(port.G, after.G.state["sean_stats"])
    close_sean_stats(port.ema_G, after.ema_sean_stats)
    assert port.M is None and port.tx_M is None


def test_sean_train_step_matches_jax():
    """D ref, G ref (tracking on x_fake and x_fake2), the EMA of G and of
    its statistics."""
    run = step_run("sean")
    check_sean_step(run)
    state, after = run[0], run[1]
    # 2 tracked forwards of the batch, on top of the perturbed counts
    tracked = {k: v for k, v in jax.tree_util.tree_flatten_with_path(
        after.G.state["sean_stats"])[0]}
    before = {k: v for k, v in jax.tree_util.tree_flatten_with_path(
        state.G.state["sean_stats"])[0]}
    counts = [k for k in tracked if "count" in jax.tree_util.keystr(k)]
    assert counts and all(tracked[k].sum() - before[k].sum() == 2 * BATCH
                          for k in counts)


def test_diff_augment_train_step_matches_jax(monkeypatch):
    key = jax.random.PRNGKey(3)  # step_run's step key for seed 0
    keys = jax.random.split(key, 4)
    d1, d2 = jax.random.split(keys[1])
    g1, _ = jax.random.split(keys[3])
    shape = (BATCH, IMG, IMG, 3)
    draws = [jax_draws(k, shape, POLICY) for k in (d1, d2, g1)]

    def fed(shape_, policy, generator=None, device=None, dtype=None):
        assert policy == POLICY and tuple(shape_) == shape
        return draws.pop(0)

    monkeypatch.setattr(diffaug, "draw_diff_augment", fed)
    check_sean_step(step_run.__wrapped__("sean", diff_aug=POLICY))
    assert not draws  # every D and G batch was augmented
