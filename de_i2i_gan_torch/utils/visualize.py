"""Result visualization, counterpart of ``de_i2i_gan_tpu/utils/visualize.py``:
``make_grid`` (the reference's torchvision ``make_grid``) and the embedding
scatter (defectGAN/utils/util.py:122-156).

``reduce_embeddings`` reduces an embedding bank to 2-D: PCA by SVD (numpy
alone), or t-SNE (sklearn). ``visualize_embeddings`` then plots it with
matplotlib; without matplotlib, or without sklearn for t-SNE, it prints and
skips the plot, as the JAX module does. ``draw_ablation`` draws a sweep's
FIDs against its values (``cli/sweep.py``).
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np


def _plt():
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        return plt
    except Exception:
        print("[visualize] matplotlib unavailable; skipping plot")
        return None


def draw_ablation(results: Dict, title: str, xlabel: str,
                  out_path: Path) -> None:
    """Line figure of an ablation sweep (visualize.py draw_mask_*): FID
    against each value, the best (lowest) point marked."""
    plt = _plt()
    if plt is None:
        return
    keys = list(results.keys())
    vals = [results[k] for k in keys]
    fig, ax = plt.subplots(figsize=(6, 4))
    xs = range(len(keys))
    ax.plot(xs, vals, marker="o")
    best = int(np.argmin(vals))
    ax.scatter([best], [vals[best]], color="red", zorder=3)
    ax.set_xticks(list(xs))
    ax.set_xticklabels([str(k) for k in keys])
    ax.set_xlabel(xlabel)
    ax.set_ylabel("FID")
    ax.set_title(title)
    fig.tight_layout()
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out_path)
    plt.close(fig)


def reduce_embeddings(embeddings: Dict, reduction: str = "pca"
                      ) -> Optional[Tuple[np.ndarray, List]]:
    """{label: [vectors]} -> ((n, 2) points, the label of each), or None
    when t-SNE is asked for and sklearn is missing. PCA: the centred
    vectors on their first two right singular vectors."""
    vecs = np.concatenate([np.stack(v) for v in embeddings.values()], axis=0)
    labels = [k for k, v in embeddings.items() for _ in v]
    if reduction == "pca":
        c = vecs - vecs.mean(0)
        _, _, vt = np.linalg.svd(c, full_matrices=False)
        return c @ vt[:2].T, labels
    try:
        from sklearn.manifold import TSNE
    except ImportError:
        print("[visualize] sklearn unavailable; skipping t-SNE")
        return None
    return TSNE(n_components=2, random_state=0).fit_transform(vecs), labels


def visualize_embeddings(embeddings: Dict, out_path: Path,
                         reduction: str = "pca") -> Optional[np.ndarray]:
    """Per-label scatter of the reduced embeddings (util.py:122-156) written
    to ``out_path``; returns the 2-D points (None where skipped)."""
    reduced = reduce_embeddings(embeddings, reduction)
    plt = _plt()
    if reduced is None or plt is None:
        return None if reduced is None else reduced[0]
    red, labels = reduced
    fig, ax = plt.subplots(figsize=(8, 8))
    for u in sorted(set(labels)):
        mask = np.asarray([lbl == u for lbl in labels])
        name = "-".join(str(j) for j, b in enumerate(u) if b == 1) \
            if isinstance(u, tuple) else str(u)
        ax.scatter(red[mask, 0], red[mask, 1], s=6, label=name)
    ax.legend(fontsize=6)
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out_path)
    plt.close(fig)
    return red


def make_grid(images: np.ndarray, nrow: int, pad: int = 2) -> np.ndarray:
    """(N, H, W, C) in [-1,1] -> single (H', W', C) grid image in [0,1]
    (torchvision make_grid equivalent)."""
    n, h, w, c = images.shape
    ncol = nrow
    nrow_ = (n + ncol - 1) // ncol
    grid = np.ones((nrow_ * (h + pad) + pad, ncol * (w + pad) + pad, c),
                   np.float32)
    for i in range(n):
        r, col = divmod(i, ncol)
        y0 = pad + r * (h + pad)
        x0 = pad + col * (w + pad)
        grid[y0:y0 + h, x0:x0 + w] = (images[i] + 1.0) / 2.0
    return np.clip(grid, 0, 1)
