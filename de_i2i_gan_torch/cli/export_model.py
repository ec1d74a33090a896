"""Export trained generators to ``torch.export`` serving artifacts,
counterpart of ``de_i2i_gan_tpu/cli/export_model.py``.

Each artifact is a ``.pt2`` file with the weights in it and a symbolic
batch dimension (``serving.py``). A program holds the device it was traced
on, so ``--platforms`` lists where it will be served: ``cuda`` (the
default; device 0), ``cpu``, or both, one artifact each
(``<name>.<platform>.pt2`` when there are two).

Examples:
  python -m de_i2i_gan_torch.cli.export_model --model defectgan \
      --name run1 --ckpt_dir ./checkpoints --load_from_opt_file \
      ./checkpoints/run1/opt.json --out run1.pt2 --validate
  python -m de_i2i_gan_torch.cli.export_model --model starganv2 \
      --checkpoint_dir expr/checkpoints --resume_iter 100000 \
      --out_dir expr/export --validate

DefectGAN takes its options as ``cli/test_defectgan.py`` does (``--gpu_ids
-1`` exports for the CPU when ``--platforms`` is not given). A loaded
artifact runs as ``serving.load_exported(path).module()(*args)``.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch

PLATFORMS = ("cpu", "cuda")
# the JAX CLI's round-trip bound; a loaded artifact runs the live forward's
# aten ops and kernels, so on the card in bfloat16 too it holds (its
# outputs equal the live forward's bit for bit there)
ATOL = 2e-5


def _devices(platforms, default: str):
    """The torch device of each asked platform."""
    for p in platforms or [default]:
        if p not in PLATFORMS:
            raise ValueError(f"--platforms takes {PLATFORMS}, got {p!r}: a "
                             "torch.export program runs where it was traced")
    return {p: ("cuda:0" if p == "cuda" else "cpu")
            for p in (platforms or [default])}


def _out_path(path: Path, platform: str, several: bool) -> Path:
    return path.with_name(f"{path.stem}.{platform}{path.suffix}") \
        if several else path


def _leaves(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


def _validate(path: Path, direct_fn, args) -> dict:
    """Deserialize the artifact, run it on ``args`` and compare each output
    with the live forward within ``ATOL``; returns the max and mean |d|."""
    from de_i2i_gan_torch.serving import load_exported
    restored = load_exported(path).module()
    with torch.no_grad():
        got, want = _leaves(restored(*args)), _leaves(direct_fn(*args))
    if len(got) != len(want):
        raise AssertionError(f"round trip gave {len(got)} outputs, the live "
                             f"forward {len(want)}")
    diffs = [(g.float() - w.float()).abs() for g, w in zip(got, want)]
    worst = {"max_abs": max(float(d.max()) for d in diffs),
             "mean_abs": max(float(d.mean()) for d in diffs)}
    print(f"[export] round trip vs live forward (batch {args[0].shape[0]}): "
          f"max |d| {worst['max_abs']:.3e}, mean |d| {worst['mean_abs']:.3e}")
    if worst["max_abs"] > ATOL:
        raise AssertionError(f"round-trip mismatch: max abs err "
                             f"{worst['max_abs']} > {ATOL}")
    return worst


def _export_defectgan(argv, rest) -> dict:
    from de_i2i_gan_torch.config.options import (
        Options, device_of, to_defectgan_config, to_train_config)
    from de_i2i_gan_torch.serving import (
        defectgan_example_args, defectgan_serving_module,
        export_defectgan_generator, save_exported)
    from de_i2i_gan_torch.train.checkpoint import load_checkpoint
    from de_i2i_gan_torch.train.jax_import import init_weights
    from de_i2i_gan_torch.train.steps import DefectGanSteps

    opt = Options("defectgan_test").parse(rest, save=False)
    cfg = to_defectgan_config(opt)
    name = opt.load_model_name or opt.name
    default = "cpu" if device_of(opt) == "cpu" else "cuda"
    devices = _devices(argv.platforms, default)
    base = Path(argv.out or f"{name}_generator.pt2")
    written = {}
    for platform, device in devices.items():
        steps = DefectGanSteps(cfg, to_train_config(opt, "bce"), device=device)
        init_weights(steps, opt.seed)
        load_checkpoint(opt.ckpt_dir, name, opt.which_epoch, steps,
                        strict=False)
        program = export_defectgan_generator(steps, use_ema=argv.use_ema)
        out = save_exported(program, _out_path(base, platform,
                                               len(devices) > 1))
        print(f"[export] defectgan generator -> {out} "
              f"({out.stat().st_size / 1e6:.1f} MB, platform={platform})")
        written[platform] = {"path": out}
        if argv.validate:
            gen = torch.Generator().manual_seed(opt.seed)
            args = defectgan_example_args(steps, batch=3, generator=gen)
            written[platform]["validate"] = _validate(
                out, defectgan_serving_module(steps, use_ema=argv.use_ema),
                args)
    return written


def _export_sgv2(argv, a) -> dict:
    from de_i2i_gan_torch.serving import (
        export_sgv2_generator, export_sgv2_mapping,
        export_sgv2_style_encoder, save_exported)
    from de_i2i_gan_torch.train.checkpoint import load_checkpoint
    from de_i2i_gan_torch.train.jax_import import init_starganv2_weights
    from de_i2i_gan_torch.train.solver import StarGANv2Config, StarGANv2Solver

    cfg = StarGANv2Config(
        img_size=a.img_size, num_domains=a.num_domains,
        latent_dim=a.latent_dim, hidden_nc=a.hidden_nc,
        style_dim=a.style_dim, embed_nc=a.embed_nc, num_embeds=a.num_embeds,
        norm_type=a.norm_type, w_hpf=0.0, max_conv_dim=a.max_conv_dim,
        compute_dtype=a.compute_dtype, allow_degraded_losses=True)
    devices = _devices(argv.platforms, "cuda")
    out_dir = Path(a.out_dir or "export")
    written = {}
    for platform, device in devices.items():
        solver = StarGANv2Solver(cfg, device=device)
        init_starganv2_weights(solver, a.seed)
        if a.checkpoint_dir and a.resume_iter > 0:
            load_checkpoint(Path(a.checkpoint_dir), "starganv2",
                            f"{a.resume_iter:06d}", solver, strict=False)
        programs = {"generator": export_sgv2_generator(solver)}
        if cfg.norm_type == "adain":
            programs["style_encoder"] = export_sgv2_style_encoder(solver)
            programs["mapping"] = export_sgv2_mapping(solver)
        paths = {}
        for name, program in programs.items():
            p = save_exported(program, _out_path(
                out_dir / f"{name}.pt2", platform, len(devices) > 1))
            paths[name] = p
            print(f"[export] starganv2 {name} -> {p} "
                  f"({p.stat().st_size / 1e6:.1f} MB, platform={platform})")
        written[platform] = {"paths": paths}
        if argv.validate:
            b = 3
            gen = torch.Generator().manual_seed(a.seed)
            x = torch.rand((b, cfg.img_size, cfg.img_size, 3), generator=gen)
            s_tail = ((cfg.num_embeds, cfg.embed_nc) if cfg.norm_type == "sean"
                      else (cfg.style_dim,))
            s = torch.randn((b, *s_tail), generator=gen)
            y = torch.arange(b) % cfg.num_domains
            args = [t.to(device) for t in (x * 2 - 1, s, y)]
            written[platform]["validate"] = _validate(
                paths["generator"], solver.generate, args)
    return written


def build_parser() -> argparse.ArgumentParser:
    """The flags of both models; the rest go to DefectGAN's options or to
    ``sgv2_parser``."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", choices=("defectgan", "starganv2"),
                   required=True)
    p.add_argument("--platforms", nargs="*", default=None,
                   help="where each artifact will be served: cuda and/or "
                        "cpu (default: cuda; DefectGAN with --gpu_ids -1: "
                        "cpu)")
    p.add_argument("--validate", action="store_true",
                   help="deserialize the artifact and compare one batch "
                        "against the live forward")
    p.add_argument("--use_ema", action="store_true",
                   help="defectgan: export the EMA generator weights")
    p.add_argument("--out", default=None, help="defectgan artifact path")
    return p


def sgv2_parser() -> argparse.ArgumentParser:
    """StarGAN v2's net surface (main.py flag names)."""
    p = argparse.ArgumentParser()
    p.add_argument("--img_size", type=int, default=256)
    p.add_argument("--num_domains", type=int, default=2)
    p.add_argument("--latent_dim", type=int, default=16)
    p.add_argument("--hidden_nc", type=int, default=256)
    p.add_argument("--style_dim", type=int, default=64)
    p.add_argument("--embed_nc", type=int, default=768)
    p.add_argument("--num_embeds", type=int, default=5)
    p.add_argument("--max_conv_dim", type=int, default=512)
    p.add_argument("--norm_type", choices=("adain", "sean"), default="adain")
    p.add_argument("--compute_dtype", type=str, default="float32",
                   help="the nets' compute dtype (the JAX CLI exports "
                        "float32)")
    p.add_argument("--seed", type=int, default=777)
    p.add_argument("--checkpoint_dir", default=None)
    p.add_argument("--resume_iter", type=int, default=0)
    p.add_argument("--out_dir", default=None)
    return p


def main(argv=None) -> dict:
    """Export (and validate); returns {platform: what was written}. The
    flags after the common ones are DefectGAN's options (as
    ``cli/test_defectgan.py`` takes them) or StarGAN v2's net surface; the
    JAX CLI parses both models' flags in one parser, so a DefectGAN flag
    that StarGAN v2 shares (``--hidden_nc``, ``--embed_nc``) never reaches
    DefectGAN there."""
    args, rest = build_parser().parse_known_args(argv)
    if args.model == "defectgan":
        return _export_defectgan(args, rest)
    return _export_sgv2(args, sgv2_parser().parse_args(rest))


if __name__ == "__main__":
    main(sys.argv[1:])
