"""Rank functions for the port's data-parallel tests: two CPU ranks over
gloo (``de_i2i_gan_torch.parallel.distributed.launch``, a ``FileStore`` in
a temporary directory). Spawned ranks import this module afresh, so it
imports torch and the port only, and every function a rank runs lives at
module level.

``build`` makes each trainer's steps at a tiny size, the same in the test
process and in every rank; ``step`` runs one super-step or iteration of a
kind; ``ranks_step`` is a rank's side: the state the test process saved,
the group attached, this rank's rows of the global batch (and of the noise
or masks fed in), the step, then the rank's state and metrics.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from de_i2i_gan_torch.config import (
    DefectGanConfig, MAEConfig, TrainConfig, WGanConfig)
from de_i2i_gan_torch.parallel.mesh import (
    make_parallel_step, reduce_metrics, replicate, shard_batch)
from de_i2i_gan_torch.train.checkpoint import (
    clone_state, load_train_state, train_state)

# the tiny bench.py CPU config (ngf=ndf=8, num_res 2, hidden_nc 16)
TINY = dict(image_size=32, label_nc=4, ngf=8, ndf=8, num_res=2, hidden_nc=16,
            num_layers=2, style_norm_block_type="adain", use_pallas=True)
DG = {"adain": TINY,
      "sean": dict(TINY, style_norm_block_type="sean", embed_nc=24,
                   num_embeds=3, use_spectral=True, use_running_stats=True,
                   style_distill=True)}
CRITICS, BATCH = 2, 4  # global batch: 2 rows a rank
DG_SGD = dict(batch_size=BATCH, num_critics=CRITICS, lr=(2e-2, 1e-2),
              optimizer="sgd", ema_decay=0.999)
MAE_CFG = dict(TINY, image_size=32)
MAE = dict(mask_ratio=0.75, patch_size=8, mask_token_type="position")
MAE_SGD = dict(batch_size=BATCH, num_critics=CRITICS, lr=(2e-2, 1e-2),
               optimizer="sgd", loss_weight=(10, 3, 1))
P2P_CFG = dict(image_size=32, label_nc=2, ngf=8, ndf=8, num_res=2,
               hidden_nc=16, num_layers=2, style_norm_block_type="spade",
               cycle_gan=True)
P2P_SGD = dict(batch_size=2, lr=(2e-2, 1e-2), optimizer="sgd",
               ema_decay=0.999)
P2P_IPL = 2
WGAN = dict(image_size=32, noise_dim=16, ngf=8, ndf=8, num_layers=2,
            num_critics=2)
WGAN_SGD = dict(batch_size=BATCH, num_critics=2, lr=(2e-2, 1e-2),
                optimizer="sgd")
# StarGAN v2 at the JAX suite's tiny config (its first conv is 2**14 //
# img_size wide) and a global batch of 2: it has no BatchNorm
SGV2_IMG, SGV2_BATCH = 64, 2
SGV2 = dict(img_size=SGV2_IMG, num_domains=3, style_dim=8, latent_dim=4,
            hidden_nc=16, embed_nc=12, w_hpf=0.0, max_conv_dim=64,
            num_embeds=5, ds_iter=10, allow_degraded_losses=True)
# the training iteration's comparison runs in float64 (parameters, Adam's
# state, activations and inputs): in float32 its L1 terms' near-ties take
# another sign under another batch split, and G's gradient with them
FLOAT64_KINDS = ("sgv2_train",)

# the batch axis of each kind's input: super-batches carry a leading
# (critics | iterations) axis
BATCH_AXIS = {"adain": 1, "sean": 1, "mae": 1, "pix2pix": 1, "wgan_clip": 1,
              "wgan_gp": 1, "sgv2_train": 0, "sgv2_pretrain": 0,
              "sgv2_stats": 1}


def build(kind: str):
    """The steps (or solver) of ``kind`` on the CPU, weights from seed 0."""
    from de_i2i_gan_torch.train.jax_import import (
        init_starganv2_weights, init_weights)

    if kind in DG:
        from de_i2i_gan_torch.train.steps import DefectGanSteps
        steps = DefectGanSteps(DefectGanConfig(**DG[kind]),
                               TrainConfig(**DG_SGD), device="cpu")
        steps.init_training()
    elif kind == "mae":
        from de_i2i_gan_torch.train.mae_steps import MAESteps
        steps = MAESteps(DefectGanConfig(**MAE_CFG), MAEConfig(**MAE),
                         TrainConfig(**MAE_SGD), device="cpu",
                         iters_per_epoch=10, num_epochs=2)
        steps.init_training()
    elif kind == "pix2pix":
        from de_i2i_gan_torch.train.pix2pix_steps import Pix2PixSteps
        steps = Pix2PixSteps(DefectGanConfig(**P2P_CFG), TrainConfig(**P2P_SGD),
                             num_d_scales=2, n_layers_d=2, device="cpu")
    elif kind.startswith("wgan"):
        from de_i2i_gan_torch.train.wgan_steps import WGanSteps
        steps = WGanSteps(WGanConfig(**WGAN), TrainConfig(**WGAN_SGD),
                          iters_per_epoch=10, num_epochs=2,
                          gp_weight=10.0 if kind == "wgan_gp" else 0.0,
                          device="cpu")
    else:
        from de_i2i_gan_torch.train.solver import (
            StarGANv2Config, StarGANv2Solver)
        norm = "sean" if kind == "sgv2_stats" else "adain"
        dtype = torch.float64 if kind in FLOAT64_KINDS else torch.float32
        saved = torch.get_default_dtype()
        torch.set_default_dtype(dtype)  # every parameter and Adam moment
        try:
            steps = StarGANv2Solver(StarGANv2Config(
                **SGV2, norm_type=norm,
                compute_dtype=str(dtype).removeprefix("torch.")), device="cpu")
            if kind == "sgv2_pretrain":
                steps.init_pretrain(MAE["mask_ratio"], 8, "position")
            steps.init_training()
            init_starganv2_weights(steps, 0)
        finally:
            torch.set_default_dtype(saved)
        return steps
    init_weights(steps, 0)
    return steps


def continued_adam(steps, seed: int = 1) -> None:
    """Every Adam state of ``steps`` as after many updates (count 100, nu
    drawn near 1e-2): an update is then lr * m / sqrt(nu), continuous in
    the gradient, where a fresh state with beta1 = 0 moves a weight by
    about lr * sign(g)."""
    gen = torch.Generator().manual_seed(seed)
    for tx in (v for k, v in vars(steps).items() if k.startswith("tx_")):
        if tx is None:
            continue
        for p in tx.params:
            st = tx.opt.state[p]
            st["step"].fill_(100.0)
            st["exp_avg"].normal_(0.0, 1e-3, generator=gen)
            st["exp_avg_sq"].uniform_(0.5e-2, 2e-2, generator=gen)


def make_batch(kind: str, seed: int = 0) -> dict:
    """A global batch (numpy) of ``kind``, and what it feeds: WGAN's noise
    ``z`` and penalty weights ``eps``, the MAE ``mask``."""
    rng = np.random.default_rng(seed)

    def imgs(*lead, size=32, c=3):
        return rng.uniform(-1, 1, (*lead, size, size, c)).astype(np.float32)

    if kind in DG:
        labels = np.eye(4, dtype=np.float32)[rng.integers(0, 4, (CRITICS,
                                                                 BATCH))]
        b = {"bg": imgs(CRITICS, BATCH), "df": imgs(CRITICS, BATCH),
             "df_labels": labels}
        if kind == "sean":
            for k in ("nm_embeds", "df_embeds"):
                b[k] = rng.normal(0, 1, (CRITICS, BATCH, 3, 24)).astype(
                    np.float32)
        return b
    if kind == "mae":
        mask = (rng.uniform(size=(BATCH, 32, 32, 1)) > 0.75).astype(
            np.float32)
        return {"imgs": imgs(CRITICS, BATCH),
                "labels": np.eye(4, dtype=np.float32)[
                    rng.integers(0, 4, (CRITICS, BATCH))], "mask": mask}
    if kind == "pix2pix":
        return {"input": imgs(P2P_IPL, 2), "target": imgs(P2P_IPL, 2)}
    if kind.startswith("wgan"):
        return {"imgs": imgs(CRITICS, BATCH),
                "z": rng.normal(0, 1, (CRITICS + 1, BATCH, 16)).astype(
                    np.float32),
                "eps": rng.uniform(size=(CRITICS, BATCH, 1, 1, 1)).astype(
                    np.float32)}
    n, size = SGV2_BATCH, SGV2_IMG
    if kind == "sgv2_stats":  # two batches of the update_stats sweep
        return {"x_src": imgs(2, n, size=size),
                "s_ref": rng.normal(0, 1, (2, n, 5, 12)).astype(np.float32),
                "y_ref": rng.integers(0, 3, (2, n))}
    y_src = rng.integers(0, 3, n).astype(np.int64)
    b = {k: imgs(n, size=size) for k in ("x_src", "x_ref", "x_ref2")}
    b.update(y_src=y_src, y_ref=(y_src + 1 + rng.integers(0, 2, n)) % 3,
             z_ref=rng.normal(0, 1, (n, 4)).astype(np.float32),
             z_ref2=rng.normal(0, 1, (n, 4)).astype(np.float32))
    if kind == "sgv2_pretrain":
        b["mask"] = (rng.uniform(size=(n, size, size, 1)) > 0.65).astype(
            np.float32)
    if kind in FLOAT64_KINDS:
        b = {k: v.astype(np.float64) if v.dtype.kind == "f" else v
             for k, v in b.items()}
    return b


@contextlib.contextmanager
def _fed_masks(mask: np.ndarray):
    """Both MAE paths draw ``mask`` (this process's rows) wherever they
    would draw a shifted patch mask."""
    from de_i2i_gan_torch.train import mae_steps, solver
    fed = torch.from_numpy(np.ascontiguousarray(mask))

    def port_mask(b, h, w, p, r, generator=None, device="cpu"):
        return fed[:b].to(device)

    real = mae_steps.generate_shifted_mask, solver.generate_shifted_mask
    mae_steps.generate_shifted_mask = solver.generate_shifted_mask = port_mask
    try:
        yield
    finally:
        mae_steps.generate_shifted_mask, solver.generate_shifted_mask = real


def step(kind: str, steps, batch: dict) -> dict:
    """One super-step (or iteration) of ``kind`` on ``batch`` (this
    process's rows); returns its metrics as floats."""
    batch = {k: torch.as_tensor(v) for k, v in batch.items()}
    mask = batch.pop("mask", None)
    with (_fed_masks(mask.numpy()) if mask is not None
          else contextlib.nullcontext()):
        return _step(kind, steps, batch)


def _step(kind: str, steps, batch: dict) -> dict:
    if kind.startswith("wgan"):
        z, eps = batch.pop("z"), batch.pop("eps")
        m = steps.super_step(batch, z=z, eps=eps)
    elif kind == "sgv2_train":
        m = steps.train_step(batch)
    elif kind == "sgv2_pretrain":
        m = steps.pretrain_step(batch)
    elif kind == "sgv2_stats":
        # the update_stats sweep over two batches, then the finalize
        for i in range(batch["x_src"].shape[0]):
            steps.track_stats_step(batch["x_src"][i], batch["s_ref"][i],
                                   batch["y_ref"][i])
        steps.finalize_ema_stats()
        m = {}
    else:
        m = steps.super_step(batch)
    if kind == "sean":
        steps.update_per_epoch()  # SEAN's running statistics, finalized
    return {k: float(v) for k, v in m.items()}


def result(steps, metrics: dict) -> dict:
    return {"metrics": metrics, "state": clone_state(train_state(steps))}


def ranks_step(kind: str, state_path: str, batch: dict) -> dict:
    """A rank's side of a data-parallel step: the saved state, the group,
    this rank's rows, one step; its state and metrics."""
    torch.set_num_threads(1)
    steps = build(kind)
    load_train_state(steps, torch.load(state_path, weights_only=True))
    make_parallel_step(steps)
    replicate(steps)
    rows = {k: shard_batch(v, batch_axis=0 if k == "mask" else
                           BATCH_AXIS[kind]) for k, v in batch.items()}
    metrics = step(kind, steps, rows)
    # the global batch's means, as the trainers log them
    keys = list(metrics)
    if keys:
        means = reduce_metrics([[torch.tensor(metrics[k]) for k in keys]])
        metrics = dict(zip(keys, means[0].tolist()))
    return result(steps, metrics)


def bn_ranks(groups: int, x: np.ndarray, w: np.ndarray, state: dict) -> dict:
    """A rank's BatchNorm in train mode with ``groups`` groups: this rank's
    share of each group of the global ``x``, the loss sum(y * w) / (the
    global rows), its gradients summed over the ranks as the optimizer's
    all-reduce would average them."""
    import torch.distributed as dist

    from de_i2i_gan_torch.nn.blocks import BatchNorm
    torch.set_num_threads(1)
    n, r = dist.get_world_size(), dist.get_rank()
    bn = BatchNorm(x.shape[1]).train()
    bn.load_state_dict(state)
    bn.group = dist.group.WORLD
    mine = rank_rows(x, groups, n, r)
    xr = torch.from_numpy(mine).requires_grad_()
    y = bn(xr, bn_groups=groups)
    loss = (y * torch.from_numpy(rank_rows(w, groups, n, r))).sum() / len(x)
    gx, gw, gb = torch.autograd.grad(loss, [xr, bn.weight, bn.bias])
    for g in (gw, gb):
        dist.all_reduce(g)
    return {"y": y.detach(), "gx": gx, "gw": gw, "gb": gb,
            "running_mean": bn.running_mean, "running_var": bn.running_var}


def rank_rows(x: np.ndarray, groups: int, n: int, r: int) -> np.ndarray:
    """Rank ``r``'s rows of a global batch laid out in ``groups`` groups:
    its share of each group, group after group."""
    parts = np.split(x, groups)
    return np.concatenate([np.split(p, n)[r] for p in parts])


def optimizer_ranks(grads: list, state: dict) -> dict:
    """Adam over one tensor: this rank's gradient, the update applies the
    mean of the ranks'; the parameter and the moments after two updates."""
    import torch.distributed as dist

    from de_i2i_gan_torch.train.optim import make_optimizer
    torch.set_num_threads(1)
    p = torch.nn.Parameter(state["p"].clone())
    tx = make_optimizer(TrainConfig(optimizer="adam"), [p], 1e-2, 10, 2)
    tx.group = dist.group.WORLD
    for g in grads[dist.get_rank()]:
        tx.step([torch.as_tensor(g)])
    st = tx.opt.state[p]
    return {"p": p.detach(), "exp_avg": st["exp_avg"],
            "exp_avg_sq": st["exp_avg_sq"], "count": tx.count}


def cli_rank(module: str, *argvs: list) -> list:
    """A rank running a training CLI's ``main`` once for each of ``argvs``
    (the process is a rank already, so the CLI trains here), TensorBoard
    left out: it imports TensorFlow, which takes longer than the run.
    Returns the state digest of each run."""
    import importlib

    from de_i2i_gan_torch.parallel.mesh import state_digest
    torch.set_num_threads(1)
    main = importlib.import_module(f"de_i2i_gan_torch.cli.{module}").main
    return [no_tensorboard(lambda a: state_digest(main(a)), argv)
            for argv in argvs]


def no_tensorboard(fn, *args):
    """``fn(*args)`` with the trainers' TensorBoard writer left out, on one
    thread."""
    from de_i2i_gan_torch.train import trainer
    torch.set_num_threads(1)
    writer = trainer.TBWriter
    trainer.TBWriter = lambda _: writer(None)
    try:
        return fn(*args)
    finally:
        trainer.TBWriter = writer
