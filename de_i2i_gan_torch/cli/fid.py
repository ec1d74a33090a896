"""Standalone FID / statistics CLI, counterpart of
``de_i2i_gan_tpu/cli/fid.py`` (the reference's pytorch-fid entry point,
defectGAN/metrics/fid_score.py:318-354): the FID between two image folders
(or a folder and a precomputed ``.npz``), ``.npz`` statistics of one folder
for later comparisons, and the per-class mFID over ``stats_*.npy`` files.

    python -m de_i2i_gan_torch.cli.fid path/to/real path/to/fake --dims 2048
    python -m de_i2i_gan_torch.cli.fid path/to/real --save_stats real.npz
    python -m de_i2i_gan_torch.cli.fid --mfid real_stats_dir fake_stats_dir

InceptionV3 runs on CUDA device 0 (``--device cpu``: the CPU), with the
pytorch-fid weights of ``--inception_weights``, or without them from
weights drawn from a seed, whose FID means nothing.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

SUFFIXES = (".png", ".jpg", ".jpeg")


class _Folder:
    """Every image under ``path`` (recursively, sorted), through
    ``EvalTransform``."""

    def __init__(self, path: Path, image_size: int):
        from de_i2i_gan_torch.data.transforms import EvalTransform
        self.files = sorted(f for f in Path(path).rglob("*")
                            if f.suffix.lower() in SUFFIXES)
        self.tf = EvalTransform(image_size)
        self._rng = np.random.default_rng(0)

    def __len__(self):
        return len(self.files)

    def __getitem__(self, i):
        from PIL import Image
        return (self.tf(Image.open(self.files[i]), self._rng),
                np.zeros(1, np.float32), str(self.files[i]))


def main(argv=None) -> dict:
    """Run the asked mode; returns what it printed (``fid``, ``mfid``, or
    the written ``stats`` path)."""
    p = argparse.ArgumentParser()
    p.add_argument("paths", nargs="*", type=Path)
    p.add_argument("--dims", type=int, default=2048)
    p.add_argument("--image_size", type=int, default=299)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--num_imgs", type=int, default=50000)
    p.add_argument("--save_stats", type=Path, default=None)
    p.add_argument("--inception_weights", type=Path, default=None,
                   help="pytorch-fid / torchvision InceptionV3 .pth")
    p.add_argument("--mfid", action="store_true")
    p.add_argument("--device", type=str, default="cuda",
                   help="where InceptionV3 runs: cuda (device 0) or cpu")
    args = p.parse_args(argv)

    from de_i2i_gan_torch.data.pipeline import DataLoader
    from de_i2i_gan_torch.metrics.evaluator import Evaluator
    from de_i2i_gan_torch.metrics.fid import (
        ActivationStats, frechet_distance, load_stats_npz,
        mfid_from_class_stats, save_stats_npz)
    from de_i2i_gan_torch.metrics.inception import (
        BLOCK_INDEX_BY_DIM, InceptionV3, load_torch_inception_weights)

    if args.mfid:
        if len(args.paths) != 2:
            raise SystemExit("--mfid needs two directories of stats_*.npy")
        real_dir, fake_dir = args.paths
        real_stats = {}
        for f in sorted(Path(real_dir).glob("stats_*.npy")):
            acts = np.load(f)
            st = ActivationStats(acts.shape[1])
            st.update(acts)
            real_stats[f.stem[6:]] = st.finalize()
        fake_acts = {f.stem[6:]: np.load(f)
                     for f in sorted(Path(fake_dir).glob("stats_*.npy"))}
        out = mfid_from_class_stats(real_stats, fake_acts)
        print({k: round(v, 3) for k, v in out.items()})
        return {"mfid": out}

    inception = None
    if args.inception_weights:
        inception = load_torch_inception_weights(
            args.inception_weights,
            InceptionV3((BLOCK_INDEX_BY_DIM[args.dims],)))
    ev = Evaluator(dims=args.dims, device=args.device, inception=inception)

    def stats_of(path: Path):
        if str(path).endswith(".npz"):
            return load_stats_npz(path)
        loader = DataLoader(_Folder(path, args.image_size), args.batch_size,
                            shuffle=False, drop_last=False)
        return ev.dataset_statistics(loader, num_imgs=args.num_imgs).finalize()

    if args.save_stats and len(args.paths) == 1:
        save_stats_npz(args.save_stats, *stats_of(args.paths[0]))
        print(f"wrote statistics to {args.save_stats}")
        return {"stats": args.save_stats}

    if len(args.paths) != 2:
        raise SystemExit("need two paths (folders or .npz)")
    fid = frechet_distance(*stats_of(args.paths[0]), *stats_of(args.paths[1]))
    print(f"FID: {fid:.4f}")
    return {"fid": fid}


if __name__ == "__main__":
    main(sys.argv[1:])
