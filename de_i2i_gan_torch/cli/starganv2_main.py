"""StarGAN v2 entry point, counterpart of
``de_i2i_gan_tpu/cli/starganv2_main.py`` (reference: stargan-v2/main.py:33-268).

    python -m de_i2i_gan_torch.cli.starganv2_main --mode train \
        --train_img_dir data/afhq/train --val_img_dir data/afhq/val \
        --num_domains 3 --w_hpf 0 --lambda_reg 1 --lambda_sty 1 \
        --lambda_ds 2 --lambda_cyc 1
    python -m de_i2i_gan_torch.cli.starganv2_main --mode sample \
        --resume_iter 100000 --num_domains 3 --w_hpf 0 ...

    python -m de_i2i_gan_torch.cli.starganv2_main --mode pretrain \
        --train_img_dir data/afhq/train --num_domains 3 --w_hpf 0 ...
    python -m de_i2i_gan_torch.cli.starganv2_main --mode train \
        --pretrain_dir expr/checkpoints ...

    python -m de_i2i_gan_torch.cli.starganv2_main --mode train \
        --norm_type sean --vit_path /path/to/hf_vit --embed_nc 768 ...
    python -m de_i2i_gan_torch.cli.starganv2_main --mode update_stats \
        --norm_type sean --resume_iter 100000 ...
    python -m de_i2i_gan_torch.cli.starganv2_main --mode train \
        --num_domains 2 --w_hpf 1 --lambda_reg 1 --lambda_sty 1 \
        --lambda_ds 1 --lambda_cyc 1 --wing_ckpt expr/checkpoints/wing.ckpt
    python -m de_i2i_gan_torch.cli.starganv2_main --mode align \
        --inp_dir assets/representative/custom/female --out_dir out \
        --lm_path expr/checkpoints/celeba_lm_mean.npz --wing_ckpt ...

Modes ``train`` (AdaIN or SEAN; ``--eval_every`` runs the metrics),
``pretrain`` (MAE repair pretraining, main.py:76-112), ``sample``
(``--make_video`` adds ``video_ref``), ``eval`` (FID and LPIPS over every
ordered domain pair, ``metrics/eval_starganv2.py``), ``update_stats``
(SEAN's running styles swept over ``--val_img_dir``, solver.py:379-406) and
``align`` (offline face alignment with the FAN, main.py:143-145). The nets
run on CUDA device 0; ``--device cpu`` runs them on the CPU. The metric
nets (InceptionV3, LPIPS) run from weights drawn from a seed, as no
pretrained file is in the repository: their numbers exercise the flow and
mean nothing.

SEAN's fetcher embeds the reference stacks with a frozen ViT-B/16 (f32): the
HF checkpoint of ``--vit_path``, which also joins the G loss (lambda_sty on
x_fake, in the compute dtype), or one drawn from a seed, with a warning and
the style term inactive (``--allow_degraded_losses`` needed), its embeddings
cut to ``--embed_nc``. ``--wing_ckpt`` loads the reference's FAN: with
``w_hpf > 0`` the training iterations take its masks (the reference's
solver.py:263, 529; the JAX CLI reads the FAN in align mode only and trains
without masks), and align mode warps with its landmarks. Checkpoints go to
``<checkpoint_dir>/starganv2/<%06d iteration | latest>_state.pt``, in
pretrain mode to ``starganv2_pretrain/``; ``--resume_iter`` restores one of
the mode's own, strictly but for update_stats (the JAX CLI reads
``starganv2/`` in every mode).
``--mode train --pretrain_dir <dir>`` warm-starts from
``<dir>/starganv2_pretrain/<%06d --pretrain_iter | latest>_state.pt`` by the
filtered restore: G and ``ema_G`` take the pretrained generator, D, M, S
and their EMA nets, optimizers and step what matches; the mask token is left
out. It takes every flag of the JAX CLI; a mode or flag whose feature the
port does not have yet raises ``NotImplementedError`` naming the ROADMAP
item it waits for.
"""
from __future__ import annotations

import argparse
import sys
from collections import defaultdict
from pathlib import Path

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--mode", type=str, default="train",
                   choices=["train", "pretrain", "sample", "eval",
                            "update_stats", "align"])
    p.add_argument("--img_size", type=int, default=256)
    p.add_argument("--num_domains", type=int, default=2)
    p.add_argument("--latent_dim", type=int, default=16)
    p.add_argument("--hidden_dim", type=int, default=512)
    p.add_argument("--hidden_nc", type=int, default=256)
    p.add_argument("--style_dim", type=int, default=64)
    p.add_argument("--embed_nc", type=int, default=768)
    p.add_argument("--norm_type", type=str, default="adain",
                   choices=["adain", "sean"])
    p.add_argument("--w_hpf", type=float, default=1.0)
    p.add_argument("--max_conv_dim", type=int, default=512)
    p.add_argument("--lambda_reg", type=float, default=1.0)
    p.add_argument("--lambda_cyc", type=float, default=1.0)
    p.add_argument("--lambda_sty", type=float, default=1.0)
    p.add_argument("--lambda_ds", type=float, default=1.0)
    p.add_argument("--lambda_rec", type=float, default=10.0,
                   help="MAE pretrain reconstruction weight")
    p.add_argument("--ds_iter", type=int, default=100000)
    p.add_argument("--total_iters", type=int, default=100000)
    p.add_argument("--resume_iter", type=int, default=0)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--val_batch_size", type=int, default=32)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--f_lr", type=float, default=1e-6)
    p.add_argument("--beta1", type=float, default=0.0)
    p.add_argument("--beta2", type=float, default=0.99)
    p.add_argument("--weight_decay", type=float, default=1e-4)
    p.add_argument("--num_embeds", type=int, default=5)
    p.add_argument("--num_outs_per_domain", type=int, default=10)
    p.add_argument("--seed", type=int, default=777)
    p.add_argument("--train_img_dir", type=Path,
                   default=Path("data/celeba_hq/train"))
    p.add_argument("--val_img_dir", type=Path,
                   default=Path("data/celeba_hq/val"))
    p.add_argument("--sample_dir", type=Path, default=Path("expr/samples"))
    p.add_argument("--checkpoint_dir", type=Path,
                   default=Path("expr/checkpoints"))
    p.add_argument("--eval_dir", type=Path, default=Path("expr/eval"))
    p.add_argument("--print_every", type=int, default=10)
    p.add_argument("--sample_every", type=int, default=5000)
    p.add_argument("--save_every", type=int, default=10000)
    p.add_argument("--eval_every", type=int, default=50000)
    p.add_argument("--wing_ckpt", "--wing_path", dest="wing_ckpt",
                   type=Path, default=None)
    p.add_argument("--pretrain_dir", type=Path, default=None,
                   help="warm-start nets from a MAE pretrain checkpoint dir")
    p.add_argument("--pretrain_iter", type=int, default=None)
    p.add_argument("--randcrop_prob", type=float, default=0.5)
    p.add_argument("--num_workers", type=int, default=4,
                   help="host loader threads")
    p.add_argument("--num_val_refs", type=int, default=4)
    p.add_argument("--update_sean_every", type=int, default=1,
                   help="fold SEAN running-style stats every N iters; 1 "
                        "matches the reference (core/solver.py:301 calls "
                        "update_stats() every iteration)")
    p.add_argument("--src_dir", type=Path, default=None,
                   help="sample mode: source image folder (default "
                        "val_img_dir)")
    p.add_argument("--ref_dir", type=Path, default=None,
                   help="sample mode: reference image folder (default "
                        "val_img_dir)")
    p.add_argument("--result_dir", type=Path, default=None,
                   help="sample mode output dir (default sample_dir)")
    p.add_argument("--allow_degraded_losses", action="store_true",
                   help="proceed even when a loss term would silently "
                        "degrade. Off = hard error")
    p.add_argument("--make_video", action="store_true",
                   help="sample mode: also render the reference-guided "
                        "interpolation video")
    p.add_argument("--vit_path", type=str, default=None,
                   help="local HF ViT directory or weight file for the "
                        "frozen sean-mode feature extractor (random init if "
                        "omitted)")
    p.add_argument("--DiffAugment", type=str, default="")
    p.add_argument("--fused_prop", action="store_true",
                   help="FusedProp joint D+G update (arxiv 2004.03335; "
                        "simultaneous-update semantics). Opt-in because the "
                        "update semantics differ from the reference's "
                        "alternating schedule")
    p.add_argument("--data_parallel", type=str, default="auto",
                   choices=["auto", "on", "off"],
                   help="'auto' runs on the one device; 'on' (the batch "
                        "sharded over several) waits for ROADMAP A.9")
    p.add_argument("--compute_dtype", type=str, default="bfloat16")
    # MAE pretrain mode (main.py:171-175)
    p.add_argument("--patch_size", type=int, default=32)
    p.add_argument("--mask_ratio", type=float, default=0.65)
    p.add_argument("--mask_token_type", type=str, default="position")
    # update_stats mode: tracked styles required per domain (solver.py:391)
    p.add_argument("--num_stats_samples", type=int, default=10000)
    # align mode (main.py:143-145 -> core/wing.py align_faces)
    p.add_argument("--inp_dir", type=Path, default=None)
    p.add_argument("--out_dir", type=Path, default=None)
    p.add_argument("--lm_path", type=Path, default=None,
                   help="CelebA mean-landmarks file for FaceAligner")
    p.add_argument("--device", type=str, default="cuda",
                   help="where the nets run: cuda (device 0) or cpu")
    return p


PRETRAIN_NAME = "starganv2_pretrain"  # the pretrain mode's checkpoints
VIT_MODEL_SIZE = "base"  # the frozen ViT of SEAN (ViT-B/16, as the JAX CLI)


def check_ported(args) -> None:
    """Raise ``NotImplementedError`` for a mode or flag whose feature the
    port does not have yet, naming the ROADMAP item it waits for."""
    if args.data_parallel == "on":
        raise NotImplementedError(
            "--data_parallel on is not ported to the PyTorch package yet "
            "(ROADMAP A.9)")


def to_config(args):
    from de_i2i_gan_torch.train.solver import StarGANv2Config
    return StarGANv2Config(
        img_size=args.img_size, num_domains=args.num_domains,
        latent_dim=args.latent_dim, hidden_nc=args.hidden_nc,
        style_dim=args.style_dim, embed_nc=args.embed_nc,
        norm_type=args.norm_type, w_hpf=args.w_hpf,
        max_conv_dim=args.max_conv_dim,
        lambda_reg=args.lambda_reg, lambda_cyc=args.lambda_cyc,
        lambda_sty=args.lambda_sty, lambda_ds=args.lambda_ds,
        lambda_rec=args.lambda_rec,
        ds_iter=args.ds_iter, total_iters=args.total_iters,
        batch_size=args.batch_size, lr=args.lr, f_lr=args.f_lr,
        beta1=args.beta1, beta2=args.beta2, weight_decay=args.weight_decay,
        num_embeds=args.num_embeds, diff_aug=args.DiffAugment,
        fused_prop=args.fused_prop,
        allow_degraded_losses=args.allow_degraded_losses,
        compute_dtype=args.compute_dtype)


def make_fetcher(args, root, transform, batch_size, ref_root=None):
    """Source + reference fetcher over the domain folders under ``root``
    (the references under ``ref_root`` when given)."""
    from de_i2i_gan_torch.data.starganv2_data import (
        BalancedLoader, ImageFolderDataset, InputFetcher, ReferenceDataset,
        make_reference_loader)
    src = BalancedLoader(ImageFolderDataset(root, transform, args.seed),
                         batch_size, seed=args.seed,
                         num_threads=args.num_workers)
    ref = make_reference_loader(ReferenceDataset(ref_root or root, transform,
                                                 args.seed),
                                batch_size, seed=args.seed + 1,
                                num_threads=args.num_workers)
    return InputFetcher(src, ref, args.latent_dim, args.norm_type,
                        args.hidden_nc, args.seed)


class SlicedExtractor:
    """A random ViT's embeddings cut to ``--embed_nc`` (the JAX CLI's
    ``_Sliced``): reduced configs run the SEAN flow without a ViT-sized
    width."""

    def __init__(self, base, dim: int):
        self.base, self.dim, self.device = base, dim, base.device

    def extract(self, x_ref, num_embeds, generator=None):
        e = self.base.extract(x_ref, num_embeds, generator)
        if self.dim > e.shape[-1]:
            raise ValueError(f"--embed_nc {self.dim} > ViT width {e.shape[-1]}")
        return e[..., :self.dim]


def make_train_fetcher(args, img_dir, transform, solver=None):
    """The training fetcher (JAX ``_make_train_fetcher``): sources and
    references, and for SEAN the frozen-ViT embeddings of the reference
    stacks (``SEANInputFetcher``). With ``--vit_path`` the same ViT joins
    ``solver``'s G loss."""
    import logging

    import torch

    from de_i2i_gan_torch.data.starganv2_data import (
        BalancedLoader, RandomReferenceDataset, SEANInputFetcher)
    from de_i2i_gan_torch.models.vit import (
        FeatureExtractor, ViTEncoder, load_hf_vit_weights)
    fetcher = make_fetcher(args, img_dir, transform, args.batch_size)
    if args.norm_type != "sean":
        return fetcher
    vit = ViTEncoder(VIT_MODEL_SIZE, device=args.device,
                     generator=torch.Generator(args.device).manual_seed(0))
    if args.vit_path:
        load_hf_vit_weights(args.vit_path, vit)
        if solver is not None:
            # the style reconstruction embeds x_fake through the same frozen
            # ViT (reference solver.py:515); a random ViT would add its cost
            # for a meaningless term
            solver.set_frozen_nets(vit=vit)
    else:
        logging.getLogger(__name__).warning(
            "sean mode without --vit_path: style embeddings come from a "
            "randomly initialized ViT (shapes/flow exercised, styles not "
            "semantic) and lambda_sty is inactive")
    extractor = FeatureExtractor(vit)
    if args.embed_nc != vit.hidden:
        if args.vit_path:
            raise SystemExit(f"--embed_nc {args.embed_nc} must match the "
                             f"frozen ViT's hidden width ({vit.hidden}) when "
                             "--vit_path is given")
        extractor = SlicedExtractor(extractor, args.embed_nc)
    style = BalancedLoader(
        RandomReferenceDataset(img_dir, args.num_embeds, transform, args.seed),
        args.batch_size, seed=args.seed + 2)
    return SEANInputFetcher(fetcher, style, extractor, args.num_embeds,
                            args.seed)


def train(args, solver) -> None:
    """The training loop (main.py / solver.py:258-349): fetcher ->
    device_prefetch -> ``train_step``, SEAN's statistics, running-mean
    prints, debug grids, checkpoints, ``latest`` at the end."""
    import torch

    from de_i2i_gan_torch.data.pipeline import device_prefetch
    from de_i2i_gan_torch.data.transforms import EvalTransform, TrainTransform
    from de_i2i_gan_torch.train.checkpoint import save_checkpoint

    tf = TrainTransform(args.img_size, jitter=False, vflip=False,
                        randcrop_prob=args.randcrop_prob)
    fetcher = make_train_fetcher(args, args.train_img_dir, tf, solver)
    # fixed val inputs for the periodic debug grids (core/solver.py:228-229);
    # SEAN's come from the train fetcher, which embeds the references
    if args.norm_type != "sean" and Path(args.val_img_dir).is_dir():
        inputs_val = next(make_fetcher(args, args.val_img_dir,
                                       EvalTransform(args.img_size),
                                       args.val_batch_size))
    else:
        inputs_val = next(fetcher)

    # DiffAugment draws; the JAX CLI's PRNGKey(seed) stream
    generator = torch.Generator(device=solver.device).manual_seed(args.seed)
    running = defaultdict(float)
    feed = device_prefetch(fetcher, solver.device)
    try:
        for i, batch in zip(range(args.resume_iter, args.total_iters), feed):
            run_iteration(args, solver, i, batch, generator, running,
                          inputs_val)
    finally:
        feed.close()  # stops the prefetch thread
    save_checkpoint(args.checkpoint_dir, "starganv2", "latest", solver)


def run_iteration(args, solver, i, batch, generator, running, inputs_val):
    """Iteration ``i``: the step, then what the loop does at its cadences."""
    from de_i2i_gan_torch.train.checkpoint import save_checkpoint
    from de_i2i_gan_torch.utils.translate import debug_image

    metrics = solver.train_step(batch, generator)
    if solver.cfg.norm_type == "sean" and \
            (i + 1) % max(args.update_sean_every, 1) == 0:
        solver.update_sean_stats()
    for k, v in metrics.items():
        running[k] += float(v)
    if (i + 1) % args.print_every == 0:
        log = " ".join(f"{k}: [{running[k] / args.print_every:.4f}]"
                       for k in sorted(running))
        print(f"Iteration [{i + 1}/{args.total_iters}] {log}")
        running.clear()
    if (i + 1) % args.sample_every == 0:
        debug_image(solver, inputs_val, i + 1, args.sample_dir)
    if (i + 1) % args.save_every == 0:
        save_checkpoint(args.checkpoint_dir, "starganv2", f"{i + 1:06d}",
                        solver)
    if (i + 1) % args.eval_every == 0:
        # in-training metrics (core/solver.py:346-349)
        from de_i2i_gan_torch.metrics.eval_starganv2 import evaluate_all_tasks
        evaluate_all_tasks(solver, args, step=i + 1)


def pretrain(args, solver) -> None:
    """The MAE pretraining loop (main.py:76-112): fetcher -> device_prefetch
    -> ``pretrain_step``, running-mean prints, checkpoints under
    ``starganv2_pretrain``, ``latest`` at the end."""
    import torch

    from de_i2i_gan_torch.data.pipeline import device_prefetch
    from de_i2i_gan_torch.data.transforms import TrainTransform
    from de_i2i_gan_torch.train.checkpoint import save_checkpoint

    tf = TrainTransform(args.img_size, jitter=False, vflip=False)
    fetcher = make_train_fetcher(args, args.train_img_dir, tf, solver)
    # the masks' draws; the JAX CLI's PRNGKey(seed) stream
    generator = torch.Generator(device=solver.device).manual_seed(args.seed)
    running = defaultdict(float)
    feed = device_prefetch(fetcher, solver.device)
    try:
        for i, batch in zip(range(args.resume_iter, args.total_iters), feed):
            metrics = solver.pretrain_step(batch, generator)
            for k, v in metrics.items():
                running[k] += float(v)
            if (i + 1) % args.print_every == 0:
                log = " ".join(f"{k}: [{running[k] / args.print_every:.4f}]"
                               for k in sorted(running))
                print(f"Pretrain [{i + 1}/{args.total_iters}] {log}")
                running.clear()
            if (i + 1) % args.save_every == 0:
                save_checkpoint(args.checkpoint_dir, PRETRAIN_NAME,
                                f"{i + 1:06d}", solver)
    finally:
        feed.close()  # stops the prefetch thread
    save_checkpoint(args.checkpoint_dir, PRETRAIN_NAME, "latest", solver)


def sample(args, solver) -> None:
    """Reference-guided cycle grid and the latent grid (stargan-v2
    utils.py:110-174)."""
    from de_i2i_gan_torch.data.transforms import EvalTransform
    from de_i2i_gan_torch.utils.png import write_png
    from de_i2i_gan_torch.utils.translate import (
        debug_image, translate_using_latent)

    if args.result_dir is not None:
        args.sample_dir = args.result_dir
    tf = EvalTransform(args.img_size)
    inputs = next(make_fetcher(args, args.src_dir or args.val_img_dir, tf,
                               args.val_batch_size,
                               ref_root=args.ref_dir or args.val_img_dir))
    debug_image(solver, inputs, args.resume_iter, args.sample_dir)
    if args.make_video:
        make_video(args, solver, inputs)
    z_list = [np.random.default_rng(i).standard_normal(
        args.latent_dim).astype(np.float32) for i in range(3)]
    grid = translate_using_latent(solver, inputs["x_src"][:4],
                                  list(range(args.num_domains)), z_list)
    write_png(Path(args.sample_dir) / "latent_grid.png",
              (np.clip(grid, 0, 1) * 255).astype(np.uint8))
    print(f"samples written to {args.sample_dir}")


def make_video(args, solver, inputs):
    """--make_video (main.py sample mode): ``video_ref`` of the first two
    sources over the references sorted by domain (the first four), so that
    same-domain consecutive pairs exist (video_ref only transitions within
    a domain, utils.py:402-407). SEAN needs ``s_ref`` stacks, which the
    sample fetcher does not embed: it skips, as the JAX CLI does. Returns
    the video (or its frame directory), or None."""
    import torch

    from de_i2i_gan_torch.utils.translate import video_ref

    if args.norm_type == "sean" and "s_ref" not in inputs:
        print("[sample] --make_video skipped: sean mode needs s_ref embed "
              "stacks (run with a sean fetcher)")
        return None
    y_ref = np.asarray(inputs["y_ref"])
    order = np.argsort(y_ref, kind="stable")[:4]
    idx = torch.as_tensor(order)
    out = video_ref(
        solver, inputs["x_src"][:2], torch.as_tensor(inputs["x_ref"])[idx],
        y_ref[order], Path(args.sample_dir) / "video_ref.mp4",
        s_ref=(torch.as_tensor(inputs["s_ref"])[idx] if "s_ref" in inputs
               else None))
    print(f"video_ref -> {out}")
    return out


def update_stats(args, solver) -> None:
    """Sweep the EMA generator with its statistics tracked until every
    domain has ``--num_stats_samples`` styles (solver.py:379-406), over the
    SEAN fetcher of ``--val_img_dir``; finalize and save the checkpoint
    ``stats_updated``."""
    from de_i2i_gan_torch.data.transforms import TrainTransform
    from de_i2i_gan_torch.train.checkpoint import save_checkpoint

    if args.norm_type != "sean":
        raise SystemExit("--mode update_stats: only SEAN needs to update stats")
    tf = TrainTransform(args.img_size, jitter=False, vflip=False)
    fetcher = make_train_fetcher(args, args.val_img_dir, tf)
    counts = np.zeros(args.num_domains, np.int64)
    while counts.min() < args.num_stats_samples:
        batch = next(fetcher)
        solver.track_stats_step(batch["x_src"], batch["s_ref"], batch["y_ref"])
        np.add.at(counts, np.asarray(batch["y_ref"]), 1)
        print(dict(enumerate(counts.tolist())))
    solver.finalize_ema_stats()
    save_checkpoint(args.checkpoint_dir, "starganv2", "stats_updated", solver)
    print(f"running styles updated; checkpoint saved under "
          f"{args.checkpoint_dir}")


def align_faces(args) -> list:
    """main.py:143-145 / core/wing.py:407-431: each image of ``--inp_dir``
    resized to ``--img_size``, its FAN landmarks, the similarity warp to the
    mean landmarks of ``--lm_path``, written as PNG to ``--out_dir``.
    Returns the written paths."""
    from PIL import Image

    from de_i2i_gan_torch.models.wing import FaceAligner, WingHeatmapper, make_fan
    from de_i2i_gan_torch.utils.png import write_png

    if not (args.inp_dir and args.out_dir and args.lm_path):
        raise SystemExit("--inp_dir/--out_dir/--lm_path required for align")
    fan = make_fan(args.device, seed=0, wing_ckpt=args.wing_ckpt)
    aligner = FaceAligner(WingHeatmapper(fan, args.img_size), str(args.lm_path),
                          args.img_size)
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    written = []
    for fname in sorted(p for p in Path(args.inp_dir).iterdir()
                        if p.suffix.lower() in (".png", ".jpg", ".jpeg")):
        img = Image.open(fname).convert("RGB").resize(
            (args.img_size, args.img_size), Image.BILINEAR)
        x = np.asarray(img, np.float32)[None] / 127.5 - 1.0
        aligned = aligner.align(x)[0]
        path = out_dir / f"{fname.stem}.png"
        write_png(path, np.clip((aligned + 1) * 127.5, 0, 255).astype(np.uint8))
        written.append(path)
    print(f"aligned {len(written)} images -> {out_dir}")
    return written


def main(argv=None):
    """Run a mode; returns the solver (align mode: the written paths)."""
    from de_i2i_gan_torch.models.wing import make_fan
    from de_i2i_gan_torch.train.checkpoint import load_checkpoint
    from de_i2i_gan_torch.train.jax_import import init_starganv2_weights
    from de_i2i_gan_torch.train.solver import StarGANv2Solver

    args = build_parser().parse_args(argv)
    check_ported(args)
    if args.mode == "align":
        # offline alignment: the frozen FAN and the mean landmarks alone
        return align_faces(args)
    solver = StarGANv2Solver(to_config(args), device=args.device)
    if args.mode == "pretrain":
        # the mask token joins G's optimizer (main.py:76-112)
        solver.init_pretrain(args.mask_ratio, args.patch_size,
                             args.mask_token_type)
    solver.init_training()
    init_starganv2_weights(solver, args.seed)
    run_name = PRETRAIN_NAME if args.mode == "pretrain" else "starganv2"
    if args.resume_iter > 0:
        load_checkpoint(args.checkpoint_dir, run_name,
                        f"{args.resume_iter:06d}", solver,
                        strict=args.mode != "update_stats")
    if args.wing_ckpt is not None and args.w_hpf > 0 and args.mode == "train":
        solver.set_frozen_nets(fan=make_fan(args.device,
                                            wing_ckpt=args.wing_ckpt))
    if args.mode == "train" and args.pretrain_dir is not None:
        # MAE warm start (solver.py:57-69, 236-240): the filtered restore
        tag = f"{args.pretrain_iter:06d}" if args.pretrain_iter else "latest"
        load_checkpoint(args.pretrain_dir, PRETRAIN_NAME, tag, solver,
                        strict=False)
    if args.mode == "train":
        train(args, solver)
    elif args.mode == "pretrain":
        pretrain(args, solver)
    elif args.mode == "update_stats":
        update_stats(args, solver)
    elif args.mode == "eval":
        from de_i2i_gan_torch.metrics.eval_starganv2 import evaluate_all_tasks
        return evaluate_all_tasks(solver, args)
    else:
        sample(args, solver)
    return solver


if __name__ == "__main__":
    main(sys.argv[1:])
