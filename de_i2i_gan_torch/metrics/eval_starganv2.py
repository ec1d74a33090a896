"""StarGAN v2 evaluation, counterpart of
``de_i2i_gan_tpu/metrics/eval_starganv2.py``.

Mirrors the reference's stargan-v2/metrics/eval.py:28-168: for every
ordered domain pair src -> trg, translate every validation source image
``num_outs_per_domain`` times (latent-guided: z ~ N(0, 1) through the
mapping network, or SEAN's running-statistics sampling with std_weight 2,
eval.py:83-95), take the LPIPS diversity over the outputs of each input
(the first four of each batch), and the FID of the task against the real
target domain's statistics. The means over tasks are the headline numbers.
The generated images stream through InceptionV3 on the solver's device; no
PNG round trip. The results go to ``<eval_dir>/results[_<step>]_<mode>.json``.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from de_i2i_gan_torch.data.pipeline import DataLoader
from de_i2i_gan_torch.data.starganv2_data import ImageFolderDataset, list_domains
from de_i2i_gan_torch.data.transforms import EvalTransform
from de_i2i_gan_torch.metrics.evaluator import Evaluator
from de_i2i_gan_torch.metrics.fid import ActivationStats, frechet_distance


def _domain_loader(root: Path, tf, seed: int, domain: int, batch_size: int):
    ds = ImageFolderDataset(root, tf, seed)
    ds.samples = [s for s in ds.samples if s[1] == domain]
    return DataLoader(ds, batch_size, shuffle=False, drop_last=False)


def evaluate_all_tasks(solver, args, evaluator: Optional[Evaluator] = None,
                       mode: str = "latent",
                       step: Optional[int] = None) -> Dict[str, float]:
    """FID and LPIPS of every ordered domain pair of ``--val_img_dir``;
    returns {"FID_<mode>/<src>2<trg>": ..., "LPIPS_<mode>/...": ...,
    ".../mean": ...}. ``mode`` "latent" maps z through the EMA mapping
    network, any other mode through the training one (AdaIN)."""
    ev = evaluator or Evaluator(device=solver.device)
    val_root = Path(args.val_img_dir)
    domains = list_domains(val_root)
    tf = EvalTransform(args.img_size)
    gen = torch.Generator(solver.device).manual_seed(args.seed)
    cfg = solver.cfg
    real_stats = {dom: ev.dataset_statistics(_domain_loader(
        val_root, tf, args.seed, d, args.val_batch_size)).finalize()
        for d, dom in enumerate(domains)}

    results: Dict[str, float] = {}
    fids, lpips_vals = [], []
    for trg_idx, trg in enumerate(domains):
        for src_idx, src in enumerate(domains):
            if src_idx == trg_idx:
                continue
            task = f"{src}2{trg}"
            stats = ActivationStats(ev.dims)
            task_lpips = []
            for imgs, _, _ in _domain_loader(val_root, tf, args.seed, src_idx,
                                             args.val_batch_size):
                imgs = torch.as_tensor(imgs, device=solver.device)
                n = imgs.shape[0]
                y_trg = torch.full((n,), trg_idx, dtype=torch.int64,
                                   device=solver.device)
                outs = []
                for _ in range(args.num_outs_per_domain):
                    if cfg.norm_type == "adain":
                        z = torch.randn((n, args.latent_dim), generator=gen,
                                        device=solver.device)
                        s = solver.style({"z_ref": z}, y_trg, latent=True,
                                         use_ema=mode == "latent")
                        fake = solver.generate(imgs, s, y_trg)
                    else:
                        # SEAN latent mode: running-statistics sampling
                        # with std_weight 2 (eval.py:83-95)
                        noise = torch.randn((n, cfg.hidden_nc), generator=gen,
                                            device=solver.device)
                        fake = solver.generate(imgs, noise, y_trg,
                                               inference_stats=True,
                                               std_weight=2.0)
                    outs.append(fake)
                    stats.update(ev.features(fake).cpu().numpy())
                # LPIPS diversity across the outputs of each input
                group = torch.stack(outs, dim=1)  # (N, K, H, W, C)
                for i in range(min(n, 4)):
                    task_lpips.append(ev.pairwise_lpips(group[i]))
            if stats.n > 1:
                fid = frechet_distance(*stats.finalize(), *real_stats[trg])
                results[f"FID_{mode}/{task}"] = fid
                fids.append(fid)
            if task_lpips:
                lp = float(np.mean(task_lpips))
                results[f"LPIPS_{mode}/{task}"] = lp
                lpips_vals.append(lp)

    if fids:
        results[f"FID_{mode}/mean"] = float(np.mean(fids))
    if lpips_vals:
        results[f"LPIPS_{mode}/mean"] = float(np.mean(lpips_vals))
    out_dir = Path(getattr(args, "eval_dir", "expr/eval"))
    out_dir.mkdir(parents=True, exist_ok=True)
    # in-training evaluations are tagged with their step, as the
    # reference's per-step JSONs (metrics/eval.py:136-137)
    tag = (f"results_{step:06d}_{mode}.json" if step is not None
           else f"results_{mode}.json")
    (out_dir / tag).write_text(json.dumps(results, indent=1))
    print(results)
    return results
