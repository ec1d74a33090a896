"""One super-step (or iteration) of each trainer over two CPU ranks (gloo)
against the port's one process on the same global batch: MAE, pix2pix at
batch 2, WGAN with clipping and with the gradient penalty; the StarGAN v2
solver's ``train_step`` and ``pretrain_step`` and SEAN's running styles
after an ``update_stats`` sweep (``test_torch_parallel_sgv2.py``). DefectGAN,
with the JAX package's step beside it, is in
``test_torch_parallel_defectgan.py``.

The tolerances are the JAX suite's for data parallel against one device
(``tests/test_parallel.py``): metrics rtol 2e-3 atol 1e-4, the state after
the step rtol 2e-3 atol 2e-5. The two ranks' states are equal bit for bit.
Random draws are fed in (WGAN's noise and penalty weights, the MAE masks)
as rows of the global batch's.
"""
import pytest
import torch

from de_i2i_gan_torch.parallel import distributed
from de_i2i_gan_torch.train.checkpoint import train_state
from tests import torch_dp_workers as workers

torch.set_num_threads(1)

METRIC_RTOL, METRIC_ATOL = 2e-3, 1e-4
STATE_RTOL, STATE_ATOL = 2e-3, 2e-5
# StarGAN v2's Adam moments with beta1 = 0 are the update's gradients. G's
# is ill-conditioned (its cycle term runs G twice, its L1 terms have
# near-ties): another batch split alone moves single elements of it past
# the element-wise band, so the moments are held per tensor in relative L2,
# at the band of tests/test_torch_starganv2_train.py (G_GRAD_REL), with an
# atol for the gradients that are zero in exact arithmetic
MOMENT_REL_L2, MOMENT_ATOL = 1e-2, 2e-5


def flat(tree, path=""):
    out = {}
    for k, v in tree.items():
        p = f"{path}/{k}" if path else str(k)
        if isinstance(v, dict):
            out.update(flat(v, p))
        else:
            out[p] = v
    return out


def two_ranks(kind, tmp_path, continued=False):
    """(one process's metrics and state, the two ranks' results, the state
    before) of one step of ``kind`` on one global batch."""
    steps = workers.build(kind)
    if continued:
        workers.continued_adam(steps)
    path = tmp_path / "state.pt"
    torch.save(train_state(steps), path)
    before = flat(torch.load(path, weights_only=True))
    batch = workers.make_batch(kind)
    single = workers.result(steps, workers.step(kind, steps, batch))
    ranks = distributed.launch(workers.ranks_step, ["cpu", "cpu"], kind,
                               str(path), batch)
    return single, ranks, before


def check_agree(single, ranks, before, accumulators=(), moments_l2=None):
    """Rank 0 against one process, and the ranks against each other; the
    ``accumulators`` (keys ending so) sum over the ranks; with
    ``moments_l2`` = (rel, atol) the optimizer moments are held in relative
    L2 at those bands."""
    for k, v in single["metrics"].items():
        for r in ranks:
            assert r["metrics"][k] == pytest.approx(
                v, rel=METRIC_RTOL, abs=METRIC_ATOL), k
    want = flat(single["state"])
    got = [flat(r["state"]) for r in ranks]
    assert sorted(got[0]) == sorted(want)
    moved = 0
    for k, v in want.items():
        if not isinstance(v, torch.Tensor):
            assert got[0][k] == got[1][k] == v, k
            continue
        if k.rsplit(".", 1)[-1] in accumulators:
            torch.testing.assert_close(got[0][k] + got[1][k], v, rtol=1e-6,
                                       atol=1e-6, msg=k)
            continue
        assert torch.equal(got[0][k], got[1][k]), f"ranks differ at {k}"
        if moments_l2 is not None and "/moments/" in k:
            rel_l2, atol_l2 = moments_l2
            gap = (got[0][k] - v).norm().item()
            assert gap <= rel_l2 * v.norm().item() + \
                atol_l2 * v.numel() ** 0.5, k
        else:
            torch.testing.assert_close(got[0][k].float(), v.float(),
                                       rtol=STATE_RTOL, atol=STATE_ATOL,
                                       msg=k)
        moved += not torch.equal(v, before[k])
    assert moved > 0


@pytest.mark.parametrize("kind", ["mae", "pix2pix", "wgan_clip", "wgan_gp"])
def test_trainer_step_over_two_ranks(kind, tmp_path):
    check_agree(*two_ranks(kind, tmp_path))
