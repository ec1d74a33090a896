"""Ablation sweeps, counterpart of ``de_i2i_gan_tpu/cli/sweep.py``
(the reference's defectGAN/run.bat, run2.bat: mask_ratio / mask_token_type
sweeps whose FIDs are the repo's published numbers,
utils/visualize.py:59-159).

Each sweep value runs the reference's recipe as subprocesses:
  1. train_mae       --name mae_<axis>_<tag>  --<axis> <value>
  2. train_defectgan --name dg_<axis>_<tag>   --load_model_name mae_...
  3. test_defectgan  --metrics fid --metrics_out  (with --eval)
then writes <out_dir>/sweep_<axis>.json (each value's FID, read from the
run's --metrics_out JSON) and the ablation figure (FID against the value,
``utils.visualize.draw_ablation``).

    python -m de_i2i_gan_torch.cli.sweep --axis mask_ratio \
        --values 0.1 0.4 0.75 0.9 --eval \
        -- --dataset_name synthetic --image_size 64 --num_epochs 1

Everything after `--` is forwarded to every run whose parser takes the
flag. --dry_run prints the commands without running them.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path


def _known_flags(kind: str) -> set:
    from de_i2i_gan_torch.config.options import Options
    return {s for a in Options(kind).parser._actions
            for s in a.option_strings}


def _filter(common, known: set):
    """Drop forwarded flags (and their values) a parser doesn't accept:
    shared train flags like --num_epochs must not break the test runs."""
    out, skip = [], False
    for tok in common:
        if tok.startswith("--"):
            skip = tok.split("=")[0] not in known
            if not skip:
                out.append(tok)
        elif not skip:
            out.append(tok)
    return out


def build_commands(axis: str, values, common, eval_runs: bool,
                   ckpt_dir: str, out_dir: Path):
    py = [sys.executable, "-m"]
    mae_c = _filter(common, _known_flags("mae_train"))
    dg_c = _filter(common, _known_flags("defectgan_train"))
    test_c = _filter(common, _known_flags("defectgan_test"))
    cmds = []
    for v in values:
        tag = str(v).replace(".", "")
        mae_name, dg_name = f"mae_{axis}_{tag}", f"dg_{axis}_{tag}"
        cmds.append((py + ["de_i2i_gan_torch.cli.train_mae",
                           "--name", mae_name, f"--{axis}", str(v),
                           "--ckpt_dir", ckpt_dir] + mae_c, None))
        cmds.append((py + ["de_i2i_gan_torch.cli.train_defectgan",
                           "--name", dg_name,
                           "--load_model_name", mae_name,
                           "--ckpt_dir", ckpt_dir] + dg_c, None))
        if eval_runs:
            mfile = out_dir / f"metrics_{axis}_{tag}.json"
            cmds.append((py + ["de_i2i_gan_torch.cli.test_defectgan",
                               "--name", dg_name, "--metrics", "fid",
                               "--metrics_out", str(mfile),
                               "--ckpt_dir", ckpt_dir] + test_c,
                         (v, mfile)))
    return cmds


def main(argv=None):
    ap = argparse.ArgumentParser(
        usage="sweep.py --axis A --values V... [--eval] [--dry_run] "
              "-- <flags forwarded to every run>")
    ap.add_argument("--axis", type=str, required=True,
                    help="swept flag, e.g. mask_ratio | mask_token_type | "
                         "patch_size")
    ap.add_argument("--values", type=str, nargs="+", required=True)
    ap.add_argument("--eval", action="store_true",
                    help="run FID eval after each trained pair")
    ap.add_argument("--dry_run", action="store_true")
    ap.add_argument("--ckpt_dir", type=str, default="./ckpt")
    ap.add_argument("--out_dir", type=Path, default=Path("./results/sweeps"))
    argv = list(sys.argv[1:] if argv is None else argv)
    common = []
    if "--" in argv:
        i = argv.index("--")
        argv, common = argv[:i], argv[i + 1:]
    args = ap.parse_args(argv)

    args.out_dir.mkdir(parents=True, exist_ok=True)
    cmds = build_commands(args.axis, args.values, common, args.eval,
                          args.ckpt_dir, args.out_dir)
    if args.dry_run:
        for cmd, _ in cmds:
            print(" ".join(cmd))
        return

    fids = {}
    for cmd, meta in cmds:
        print("[sweep]", " ".join(cmd), flush=True)
        subprocess.run(cmd, check=True)
        if meta is not None:
            value, mfile = meta
            fids[value] = json.loads(Path(mfile).read_text()).get("fid")

    if fids:
        out = args.out_dir / f"sweep_{args.axis}.json"
        out.write_text(json.dumps(fids, indent=2, default=str) + "\n")
        print(f"[sweep] results -> {out}: {fids}")
        from de_i2i_gan_torch.utils.visualize import draw_ablation
        draw_ablation(fids, f"MAE {args.axis} sweep", args.axis,
                      args.out_dir / f"sweep_{args.axis}.png")


if __name__ == "__main__":
    main()
