"""One DefectGAN super-step over two CPU ranks (gloo) against the port's one
process and against the JAX package's ``super_step``, all on one global
batch of 4 (2 critics, the tiny config, float32, SGD): AdaIN, whose G step
normalizes its fused 2B forwards with ``bn_groups=2``, and SEAN with
spectral norm, running statistics (finalized after the step, the ranks'
codes summed) and distillation.

The JAX side runs unsharded on the CPU: the JAX suite's own
``tests/test_parallel.py`` holds its sharded step to the unsharded one. The
state comes from the JAX package's ``init_state``, moved off its init
values, through ``load_jax_train_state`` (``test_torch_train_step.py``).
Tolerances are the JAX suite's for data parallel against one device:
metrics rtol 2e-3 atol 1e-4, parameters rtol 2e-3 atol 2e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from de_i2i_gan_tpu.config import DefectGanConfig as JaxConfig
from de_i2i_gan_tpu.config import TrainConfig as JaxTrainConfig
from de_i2i_gan_torch.parallel import distributed
from de_i2i_gan_torch.train.checkpoint import train_state
from de_i2i_gan_torch.train.jax_import import load_jax_train_state
from tests import torch_dp_workers as workers
from tests.test_torch_parallel_steps import check_agree, flat
from tests.test_torch_train_step import _JaxSteps, _params, _trees, perturb

torch.set_num_threads(1)

METRIC_RTOL, METRIC_ATOL = 2e-3, 1e-4
PARAM_RTOL, PARAM_ATOL = 2e-3, 2e-5


@pytest.fixture(scope="module", params=["adain", "sean"])
def runs(request, tmp_path_factory):
    """(JAX state after, JAX metrics, the port's single process, the two
    ranks, the state before) of one super-step from one state."""
    kind = request.param
    cfg_kw, tcfg_kw = workers.DG[kind], workers.DG_SGD
    jsteps = _JaxSteps(JaxConfig(**cfg_kw), JaxTrainConfig(**tcfg_kw))
    state = jax.jit(jsteps.init_state)(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    g_state = jax.device_get(state.G.state)
    state = state.replace(
        G=state.G.replace(
            params=perturb(jax.device_get(state.G.params), rng),
            state={**g_state,
                   "batch_stats": perturb(g_state["batch_stats"], rng)}),
        D=state.D.replace(params=perturb(jax.device_get(state.D.params), rng)),
        ema_G=perturb(state.G.params, rng))
    if state.E is not None:
        state = state.replace(E=state.E.replace(
            params=perturb(jax.device_get(state.E.params), rng)))
    batch = workers.make_batch(kind)
    after, jmetrics = jax.jit(jsteps.super_step)(
        state, {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.PRNGKey(1))

    steps = workers.build(kind)
    load_jax_train_state(steps, **_trees(state))
    path = tmp_path_factory.mktemp(kind) / "state.pt"
    torch.save(train_state(steps), path)
    before = flat(torch.load(path, weights_only=True))
    metrics = steps.super_step({k: torch.from_numpy(v)
                                for k, v in batch.items()})
    if kind == "sean":
        steps.update_per_epoch()
    single = workers.result(steps, {k: v.item() for k, v in metrics.items()})
    ranks = distributed.launch(workers.ranks_step, ["cpu", "cpu"], kind,
                               str(path), batch)
    return kind, jax.device_get(after), jax.device_get(jmetrics), single, \
        ranks, before


def test_two_ranks_equal_one_process(runs):
    """Every metric and every tensor of the state (BatchNorm statistics,
    spectral u/v, SEAN's finalized statistics, the EMA generator) within
    the tolerances; the ranks' states equal bit for bit."""
    _, _, _, single, ranks, before = runs
    check_agree(single, ranks, before)


def test_two_ranks_equal_the_jax_super_step(runs):
    """The ranks' metrics and G's, E's and D's parameters after the step
    against the JAX super-step on the global batch."""
    kind, after, jmetrics, _, ranks, _ = runs
    got = ranks[0]["metrics"]
    assert sorted(got) == sorted(jmetrics)
    for k, v in jmetrics.items():
        assert got[k] == pytest.approx(float(v), rel=METRIC_RTOL,
                                       abs=METRIC_ATOL), k
    steps = workers.build(kind)
    state = ranks[0]["state"]
    for net in ("G", "E", "D"):
        module = getattr(steps, net)
        if module is None:
            continue
        module.load_state_dict(state[net])
        for key, (tensor, ref) in _params(module, getattr(after, net).params
                                          ).items():
            np.testing.assert_allclose(tensor.detach().numpy(), ref,
                                       rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                       err_msg=f"{net} {key}")
