"""StarGAN v2 sample grids and videos, counterpart of
``de_i2i_gan_tpu/utils/translate.py``.

Mirrors the reference's stargan-v2/core/utils.py:
  translate_and_reconstruct (:110-133)   src -> trg -> back panels
  translate_using_latent    (:136-156)   rows of latent-guided translations
  translate_using_reference (:159-174)   per-reference rows with src header
  translate_with_alpha_control (:177-199) two reference styles mixed by
                                         SEAN's mix_alpha
  translate_with_layer_split (:200-222)  style A on some decoder layers,
                                         style B on the rest
  debug_image               (:254-334)   periodic sample dumps
  video_ref, video_latent_walk (:342-466) interpolation videos

Every grid comes from the solver's EMA nets (``StarGANv2Solver.style`` and
``generate`` with ``use_ema``), as numpy in [0, 1]; ``debug_image`` writes
it as a PNG with ``utils/png.py``. The videos write their frames as PNGs
beside the asked path and encode them with the ``ffmpeg`` binary when there
is one (``shutil.which``); without it they return the frame directory.
"""
from __future__ import annotations

import shutil
import subprocess
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np
import torch

from de_i2i_gan_torch.utils.png import write_png
from de_i2i_gan_torch.utils.visualize import make_grid


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def translate_and_reconstruct(solver, x_src, y_src, x_ref, y_ref, s_ref=None):
    """[src | ref | fake | reconstruction] panels (utils.py:110-133)."""
    if solver.cfg.norm_type == "adain":
        s = solver.style({"x_ref": x_ref}, y_ref, latent=False, use_ema=True)
        s_back = solver.style({"x_ref": x_src}, y_src, latent=False,
                              use_ema=True)
    else:
        s = s_back = s_ref
    fake = solver.generate(x_src, s, y_ref)
    rec = solver.generate(fake, s_back, y_src)
    panels = np.concatenate([_np(torch.as_tensor(x_src)),
                             _np(torch.as_tensor(x_ref)), _np(fake), _np(rec)])
    return make_grid(panels, nrow=x_src.shape[0])


def translate_using_latent(solver, x_src, y_trg_list: Sequence[int], z_list):
    """Rows of latent-guided translations (utils.py:136-156); AdaIN only."""
    n = x_src.shape[0]
    rows = [_np(torch.as_tensor(x_src))]
    for y in y_trg_list:
        y_trg = torch.full((n,), int(y), dtype=torch.int64)
        for z in z_list:
            z = torch.as_tensor(z).expand(n, -1)
            s = solver.style({"z_ref": z}, y_trg, latent=True, use_ema=True)
            rows.append(_np(solver.generate(x_src, s, y_trg)))
    return make_grid(np.concatenate(rows, axis=0), nrow=n)


def translate_using_reference(solver, x_src, x_ref, y_ref, s_ref=None):
    """Grid: header row of sources, one row per reference (utils.py:159-174)."""
    n = x_src.shape[0]
    rows = [_np(torch.as_tensor(x_src))]
    for i in range(x_ref.shape[0]):
        y = torch.full((n,), int(y_ref[i]), dtype=torch.int64)
        if solver.cfg.norm_type == "adain":
            s = solver.style({"x_ref": x_ref[i:i + 1]}, y_ref[i:i + 1],
                             latent=False, use_ema=True)
        else:
            s = torch.as_tensor(s_ref[i:i + 1])
        s = s.expand(n, *s.shape[1:])
        rows.append(_np(solver.generate(x_src, s, y)))
    return make_grid(np.concatenate(rows, axis=0), nrow=n)


def debug_image(solver, inputs, step: int, sample_dir: Path) -> Path:
    """Periodic sample dump (utils.py:254-334): ``<step:06d>_cycle.png``."""
    sample_dir = Path(sample_dir)
    sample_dir.mkdir(parents=True, exist_ok=True)
    grid = translate_and_reconstruct(
        solver, inputs["x_src"], inputs["y_src"], inputs["x_ref"],
        inputs["y_ref"], s_ref=inputs.get("s_ref"))
    path = sample_dir / f"{step:06d}_cycle.png"
    write_png(path, np.clip(grid * 255, 0, 255).astype(np.uint8))
    return path


def translate_with_alpha_control(solver, x_src, y_trg, s_refs,
                                 steps: int = 5):
    """Interpolate between two reference styles through SEAN's mix_alpha
    (utils.py:177-199): ``s_refs`` (N, 2, E, embed), the pair weighted
    (1 - t, t) per embedding for ``steps`` values of t in [0, 1]; a header
    row of sources, then a row per t."""
    if solver.cfg.norm_type != "sean":
        raise ValueError("translate_with_alpha_control needs norm_type sean")
    s_refs = torch.as_tensor(s_refs)
    n, e = s_refs.shape[0], s_refs.shape[2]
    flat = s_refs.reshape(n, -1, s_refs.shape[-1])  # the pair as embeddings
    rows = [_np(torch.as_tensor(x_src))]
    for t in np.linspace(0.0, 1.0, steps):
        alpha = torch.tensor([1.0 - t, t], dtype=torch.float32)
        mix = alpha.repeat_interleave(e)[None].expand(n, -1)
        rows.append(_np(solver.generate(x_src, flat, y_trg,
                                        mix_alpha=solver._as(mix))))
    return make_grid(np.concatenate(rows, axis=0), nrow=n)


def translate_with_layer_split(solver, x_src, y_trg, s_pair,
                               split_index: Sequence[int]):
    """Style B (``s_pair[:, 1]``) on the decoder layers in ``split_index``,
    style A (``s_pair[:, 0]``) on the rest (utils.py:200-222, Generator
    ``layer_split_index``); one row."""
    out = solver.generate(x_src, s_pair, y_trg,
                          layer_split_index=tuple(split_index))
    return make_grid(_np(out), nrow=x_src.shape[0])


def _get_alphas(start: float = -5, end: float = 5, step: float = 0.5,
                len_tail: int = 10) -> List[float]:
    """Sigmoid-eased interpolation schedule and a hold (utils.py:342-351)."""
    ease = [float(1.0 / (1.0 + np.exp(-x)))
            for x in np.arange(start, end, step)]
    return [0.0] + ease + [1.0] * len_tail


def _slide(x_prev: np.ndarray, x_next: np.ndarray, alphas,
           margin: int = 32) -> np.ndarray:
    """Sliding reference window (utils.py:369-390): the next reference
    scrolls up over the previous one as alpha goes 0 -> 1. HWC in [-1,1]."""
    h, w, c = x_prev.shape
    merged = np.concatenate([x_prev, x_next], axis=0)  # (2H, W, C)
    canvas = -np.ones((len(alphas), 2 * h, w + margin, c), np.float32)
    for t, alpha in enumerate(alphas):
        top = int(h * (1 - alpha))
        canvas[t, top:2 * h, :w] = merged[:2 * h - top]
    return canvas


def _frames_dir(out_path: Path) -> Path:
    """``<out stem>_frames/`` beside ``out_path``, emptied."""
    d = Path(out_path).with_name(f"{Path(out_path).stem}_frames")
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    return d


def _assemble_video(frames_dir: Path, pattern: str, out_path: Path,
                    fps: int, tag: str) -> Path:
    """Encode the frames to mp4 when the ffmpeg binary exists (removing the
    frames on success); otherwise leave them and return their directory."""
    if shutil.which("ffmpeg"):
        out_path = Path(out_path)
        subprocess.run(
            ["ffmpeg", "-y", "-framerate", str(fps), "-i",
             str(frames_dir / pattern), "-pix_fmt", "yuv420p",
             str(out_path)], check=True, capture_output=True)
        shutil.rmtree(frames_dir, ignore_errors=True)
        return out_path
    print(f"[{tag}] ffmpeg not found; frames at {frames_dir}")
    return frames_dir


def video_ref(solver, x_src, x_ref, y_ref, out_path: Path, s_ref=None,
              fps: int = 30) -> Optional[Path]:
    """Reference-guided interpolation video (utils.py:394-419): walk the
    consecutive same-domain references, blending their styles with the
    eased alphas of ``_get_alphas`` (utils.py:354-366); every frame is
    [sliding reference panel | sources over fakes], and the last frame is
    held 10 more times. AdaIN lerps the EMA style encoder's codes; SEAN
    takes ``s_ref`` (N_ref, E, embed) stacks and weights the pair with
    ``mix_alpha``. Returns the mp4, the frame directory without ffmpeg, or
    None when no two consecutive references share a domain."""
    alphas = _get_alphas()
    n = x_src.shape[0]
    x_src_np = _np(torch.as_tensor(x_src))
    x_ref_np = _np(torch.as_tensor(x_ref))
    y_ref = [int(v) for v in np.asarray(y_ref)]
    if solver.cfg.norm_type == "adain":
        styles = solver.style({"x_ref": x_ref}, torch.as_tensor(y_ref),
                              latent=False, use_ema=True)
    else:
        if s_ref is None:
            raise ValueError("sean video_ref needs s_ref embed stacks")
        styles = solver._as(s_ref)
    frames_dir = _frames_dir(out_path)
    count = 0

    def write(frame: np.ndarray):
        nonlocal count
        write_png(frames_dir / f"{count:05d}.png",
                  np.clip((frame + 1) * 127.5, 0, 255).astype(np.uint8))
        count += 1

    last, prev = None, None
    for i in range(x_ref_np.shape[0]):
        # transitions only between consecutive same-domain references
        # (utils.py:402-407)
        if prev is None or y_ref[i] != y_ref[prev]:
            prev = i
            continue
        slided = _slide(x_ref_np[prev], x_ref_np[i], alphas)
        y = torch.full((n,), y_ref[i], dtype=torch.int64)
        for t, a in enumerate(alphas):
            if solver.cfg.norm_type == "adain":
                s = ((1.0 - a) * styles[prev] + a * styles[i])[None]
                fake = solver.generate(x_src, s.expand(n, -1), y)
            else:
                pair = torch.cat([styles[prev], styles[i]])[None]
                mix = torch.tensor([1.0 - a, a], dtype=torch.float32
                                   ).repeat_interleave(styles.shape[1])
                fake = solver.generate(
                    x_src, pair.expand(n, -1, -1), y,
                    mix_alpha=solver._as(mix[None].expand(n, -1)))
            # each sample's source over its fake, side by side
            entries = np.concatenate([x_src_np, _np(fake)], axis=1)
            last = np.concatenate([slided[t], np.concatenate(list(entries),
                                                             axis=1)], axis=1)
            write(last)
        prev = i
    if last is None:
        print("[video_ref] no same-domain consecutive reference pair; "
              "nothing to render")
        shutil.rmtree(frames_dir, ignore_errors=True)
        return None
    for _ in range(10):  # hold the last frame (utils.py:414-415)
        write(last)
    return _assemble_video(frames_dir, "%05d.png", out_path, fps, "video_ref")


def video_latent_walk(solver, x_src, y_trg: int, latent_dim: int,
                      out_path: Path, num_frames: int = 60, fps: int = 15,
                      seed: int = 0) -> Path:
    """Latent interpolation video (utils.py:342-466): z walks linearly
    between two draws of ``seed`` through the EMA mapping network, a grid
    row a frame. Returns the mp4, or the frame directory without ffmpeg."""
    rng = np.random.default_rng(seed)
    z0, z1 = rng.standard_normal((2, latent_dim)).astype(np.float32)
    frames_dir = _frames_dir(out_path)
    n = x_src.shape[0]
    y = torch.full((n,), int(y_trg), dtype=torch.int64)
    for f in range(num_frames):
        t = f / max(num_frames - 1, 1)
        z = torch.from_numpy((1 - t) * z0 + t * z1)[None].expand(n, -1)
        s = solver.style({"z_ref": z}, y, latent=True, use_ema=True)
        grid = make_grid(_np(solver.generate(x_src, s, y)), nrow=n)
        write_png(frames_dir / f"{f:04d}.png",
                  np.clip(grid * 255, 0, 255).astype(np.uint8))
    return _assemble_video(frames_dir, "%04d.png", out_path, fps, "video")
