"""FID / Inception Score / mFID math, a copy of the JAX package's
``metrics/fid.py`` (numpy and scipy, no JAX).

Mirrors the reference's defectGAN/metrics/fid_score.py and
metrics/defectgan_metrics.py:
  * streaming activation statistics (mean + covariance) — the reference
    stacks every activation in memory (fid_score.py:110-157); here a
    single-pass float64 sum/outer-product accumulator on the host
  * Frechet distance with scipy.linalg.sqrtm on host (fid_score.py:159-210,
    including the eps-retry and imaginary-component check)
  * .npz statistics files with mu/sigma keys (compute_statistics_of_path,
    fid_score.py:237-256) — format-compatible with the reference
  * Inception Score via split KL on logits-free softmax features
    (defectgan_metrics.py:73-100)
  * mFID: per-class FID averaged over classes (defectgan_metrics.py:104-123),
    class activations stored as .npy files per label combination
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class ActivationStats:
    """Streaming mean/covariance accumulator over feature batches."""

    dim: int
    n: float = 0.0
    sum: Optional[np.ndarray] = None
    outer: Optional[np.ndarray] = None

    def __post_init__(self):
        if self.sum is None:
            self.sum = np.zeros(self.dim, np.float64)
        if self.outer is None:
            self.outer = np.zeros((self.dim, self.dim), np.float64)

    def update(self, feats) -> None:
        f = np.asarray(feats, np.float64)
        self.n += f.shape[0]
        self.sum += f.sum(axis=0)
        self.outer += f.T @ f

    def finalize(self) -> Tuple[np.ndarray, np.ndarray]:
        assert self.n > 1, "need at least 2 samples for covariance"
        mu = self.sum / self.n
        # unbiased covariance, matching np.cov(rowvar=False)
        sigma = (self.outer - self.n * np.outer(mu, mu)) / (self.n - 1)
        return mu, sigma


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """||mu1-mu2||^2 + Tr(s1 + s2 - 2 sqrt(s1 s2)) (fid_score.py:159-210)."""
    from scipy import linalg
    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    diff = mu1 - mu2
    covmean = linalg.sqrtm(sigma1.dot(sigma2))  # no disp: gone in scipy 1.18
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            m = np.max(np.abs(covmean.imag))
            raise ValueError(f"Imaginary component {m}")
        covmean = covmean.real
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2)
                 - 2 * np.trace(covmean))


def save_stats_npz(path: Path, mu: np.ndarray, sigma: np.ndarray) -> None:
    np.savez(path, mu=mu, sigma=sigma)


def load_stats_npz(path: Path) -> Tuple[np.ndarray, np.ndarray]:
    with np.load(path) as f:
        return f["mu"][:], f["sigma"][:]


def inception_score(probs: np.ndarray, splits: int = 10) -> Tuple[float, float]:
    """exp(E KL(p(y|x) || p(y))) over splits (defectgan_metrics.py:73-100).
    probs: (N, classes) softmax outputs."""
    n = probs.shape[0]
    scores = []
    for i in range(splits):
        part = probs[i * n // splits:(i + 1) * n // splits]
        if part.shape[0] == 0:
            continue
        py = part.mean(axis=0, keepdims=True)
        kl = (part * (np.log(part + 1e-12) - np.log(py + 1e-12))).sum(axis=1)
        scores.append(np.exp(kl.mean()))
    return float(np.mean(scores)), float(np.std(scores))


def mfid_from_class_stats(real_stats: Dict[str, Tuple[np.ndarray, np.ndarray]],
                          fake_acts: Dict[str, np.ndarray]) -> Dict[str, float]:
    """Per-class FID + mean (defectgan_metrics.py:104-123). real_stats maps
    class-key -> (mu, sigma); fake_acts maps class-key -> (N, D) features."""
    out = {}
    for key, acts in fake_acts.items():
        if key not in real_stats or acts.shape[0] < 2:
            continue
        st = ActivationStats(acts.shape[1])
        st.update(acts)
        mu, sigma = st.finalize()
        out[key] = frechet_distance(mu, sigma, *real_stats[key])
    if out:
        out["mean"] = float(np.mean(list(out.values())))
    return out
