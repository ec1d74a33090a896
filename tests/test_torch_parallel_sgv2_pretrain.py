"""The StarGAN v2 solver over two CPU ranks (gloo) against the port's one
process, as ``test_torch_parallel_sgv2.py`` holds ``train_step``: one
``pretrain_step`` from a continued Adam state, the masks fed in as rows of
the global batch's, and SEAN's running styles after an ``update_stats``
sweep of two batches.
"""
import torch

from tests.test_torch_parallel_steps import (MOMENT_ATOL, MOMENT_REL_L2,
                                             check_agree, flat, two_ranks)

torch.set_num_threads(1)


def test_starganv2_pretrain_iteration_over_two_ranks(tmp_path):
    check_agree(*two_ranks("sgv2_pretrain", tmp_path, continued=True),
                moments_l2=(MOMENT_REL_L2, MOMENT_ATOL))


def test_starganv2_update_stats_over_two_ranks(tmp_path):
    """The EMA generator's running styles after a sweep of two batches:
    each rank tracks its rows, the finalize sums the ranks' codes."""
    single, ranks, before = two_ranks("sgv2_stats", tmp_path)
    check_agree(single, ranks, before)
    stds = [v for k, v in flat(single["state"]).items()
            if k.startswith("ema_G") and k.endswith(".std")]
    assert stds and all(not torch.equal(s, torch.zeros_like(s)) for s in stds)
