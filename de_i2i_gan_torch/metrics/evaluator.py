"""Metric orchestration for validation and test, counterpart of
``de_i2i_gan_tpu/metrics/evaluator.py``.

Mirrors the reference's defectGAN/metrics/defectgan_metrics.py:10-123
(calculate_metrics_from_model): loop over the defect loader, translate
background images to each defect batch's labels, stream the generated
images through InceptionV3, then compute
  * FID against precomputed real statistics (.npz, mu/sigma), or against
    the defect images' own statistics streamed beside the fakes
  * the Inception Score, from a softmax over the pooled features
  * intra-condition LPIPS diversity over generated pairs
The nets run on the evaluator's device (CUDA unless asked for the CPU);
only each batch's features come to the host, into float64 moments. Without
weights both nets are drawn from a seed (``seeded_inception``,
``seeded_lpips``): the numbers exercise the flow and mean nothing.
"""
from __future__ import annotations

from pathlib import Path
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from de_i2i_gan_torch.metrics.fid import (
    ActivationStats, frechet_distance, inception_score, load_stats_npz)
from de_i2i_gan_torch.metrics.inception import (
    BLOCK_INDEX_BY_DIM, seeded_inception)
from de_i2i_gan_torch.metrics.lpips import pairwise_lpips, seeded_lpips
from de_i2i_gan_torch.utils import profiling


class Evaluator:
    """FID / IS / LPIPS over generated and real images. ``inception`` and
    ``lpips`` are nets with loaded weights; without them each is drawn from
    ``seed``."""

    def __init__(self, dims: int = 2048, device="cuda", seed: int = 0,
                 inception=None, lpips=None):
        self.dims = dims
        self.block = BLOCK_INDEX_BY_DIM[dims]
        self.device = torch.device(device)
        self.inception = (inception or seeded_inception(
            (self.block,), seed, self.device)).to(self.device).eval()
        self.lpips = (lpips or seeded_lpips(seed, self.device)
                      ).to(self.device).eval()

    @torch.no_grad()
    def features(self, imgs) -> torch.Tensor:
        """NHWC images in [-1, 1] -> (N, dims) float32 features on the
        device (a map tap averaged over space), in the profiler range
        ``evaluator.inception``."""
        with profiling.span("evaluator.inception"):
            feats = self.inception(torch.as_tensor(imgs, device=self.device)
                                   )[self.block]
            return feats.mean(dim=(1, 2)) if feats.dim() == 4 else feats

    @torch.no_grad()
    def pairwise_lpips(self, images) -> float:
        return float(pairwise_lpips(self.lpips, torch.as_tensor(
            images, device=self.device)))

    def _host_features(self, imgs) -> np.ndarray:
        return self.features(imgs).cpu().numpy().astype(np.float64)

    # ------------------------------------------------------------- pipeline
    @torch.no_grad()
    def evaluate_generator(self, generate_fn: Callable, bg_iter: Iterable,
                           df_loader: Iterable, num_imgs: int = 5000,
                           npz_path: Optional[Path] = None,
                           metrics=("fid", "is", "lpips"),
                           num_lpips_images: int = 10) -> Dict[str, float]:
        """``generate_fn(bg_imgs, labels)`` -> generated NHWC images in
        [-1, 1], both arguments tensors on the evaluator's device."""
        stats = ActivationStats(self.dims)
        # no precomputed .npz: stream the real statistics from the defect
        # loader beside the fakes (fid_score.py:237-256)
        real_stats = ActivationStats(self.dims) \
            if ("fid" in metrics and npz_path is None) else None
        probs, lpips_vals, seen = [], [], 0
        bg_iter = iter(bg_iter)
        for df_imgs, df_labels, _ in df_loader:
            if seen >= num_imgs:
                break
            bg_imgs, _, _ = next(bg_iter)
            n = df_imgs.shape[0]
            fake = generate_fn(
                torch.as_tensor(bg_imgs[:n], device=self.device),
                torch.as_tensor(df_labels, device=self.device))
            feats = self.features(fake)
            stats.update(feats.cpu().numpy())
            if real_stats is not None:
                real_stats.update(self._host_features(df_imgs))
            seen += fake.shape[0]
            if "lpips" in metrics and len(lpips_vals) < num_lpips_images:
                lpips_vals.append(self.pairwise_lpips(fake))
            if "is" in metrics:
                # a softmax over the pooled features as the class posterior
                probs.append(torch.softmax(feats, dim=-1).cpu().numpy())

        out: Dict[str, float] = {}
        if "fid" in metrics and stats.n > 1:
            mu, sigma = stats.finalize()
            if npz_path is not None:
                out["fid"] = frechet_distance(mu, sigma,
                                              *load_stats_npz(npz_path))
            elif real_stats is not None and real_stats.n > 1:
                out["fid"] = frechet_distance(mu, sigma,
                                              *real_stats.finalize())
        if "is" in metrics and probs:
            out["is"], out["is_std"] = inception_score(
                np.concatenate(probs, axis=0).astype(np.float64))
        if "lpips" in metrics and lpips_vals:
            out["lpips"] = float(np.mean(lpips_vals))
        return out

    def dataset_statistics(self, loader: Iterable,
                           num_imgs: int = 50000) -> ActivationStats:
        """Real-data activation statistics (for the .npz files the FID
        comparisons read; fid_score.py:237-256)."""
        stats = ActivationStats(self.dims)
        seen = 0
        for imgs, _, _ in loader:
            if seen >= num_imgs:
                break
            stats.update(self._host_features(imgs))
            seen += imgs.shape[0]
        return stats


def defectgan_generator_fn(steps, cfg, generator: Optional[torch.Generator]
                           = None) -> Callable:
    """Translation closure over a ``DefectGanSteps``: background images +
    one-hot labels -> generated defects through the eval-mode forward, with
    SEAN's zero style embeddings (no reference embeds at eval time;
    defectgan_model.py:437-445 evaluates with the running SEAN stats the
    same way). The steps hold the weights, where the JAX closure takes a
    train state. Shared by ``cli/test_defectgan.py`` and the in-training
    ``--val_metrics`` of ``cli/train_defectgan.py``."""
    def fn(bg_imgs, labels):
        feat = None
        if cfg.style_norm_block_type == "sean":
            feat = torch.zeros((bg_imgs.shape[0], cfg.num_embeds,
                                cfg.embed_nc), device=steps.device)
        with torch.no_grad():
            out, _ = steps.generate(bg_imgs, labels, feat, generator=generator)
        return out
    return fn
