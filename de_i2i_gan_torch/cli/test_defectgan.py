"""DefectGAN test / inference entry point, counterpart of
``de_i2i_gan_tpu/cli/test_defectgan.py`` (reference:
defectGAN/test_defectgan.py:119-268).

Loads ``<ckpt_dir>/<name>/<which_epoch>_state.pt`` (a filtered load, as the
JAX CLI does) and runs the reference's test modes:
  --save_img_grid          per-background label-grid panels with spatial-
                           probability heat maps
  --save_img               plain translated images
  --save_diverse_images    Multiple_<combo>/Single_<class> grids
  --cal_clf                discriminator classifier accuracy on real data
  --vis_style_embeds T     PCA scatters of the style MLPs' activations per
                           label (test_defectgan.py:69-79): T = hidden
                           (mlp_shared / mlp_latent, after the ReLU), mean
                           (mlp_beta) or std (mlp_gamma), one PNG a layer
                           under ``pca/``; no ViT is needed
  --metrics fid is lpips   FID (against ``--npz_path``, or the defect
                           images' own statistics), IS and LPIPS diversity
                           (``metrics/evaluator.py``), JSON to
                           ``--metrics_out``
  --save_stats             each class's Inception activations of the
                           defect set -> ``stats_<classes>.npy``
  --cal_mfid               per-class FID and their mean against
                           ``--npy_path`` (a directory of ``stats_*.npy``
                           or the reference's pickled dict)
PNGs and ``.npy`` files go to ``<results_dir>/<name>/``. ``--gpu_ids -1``
runs on the CPU. The metric nets are drawn from a seed (no pretrained
weights are in the repository): their numbers mean nothing.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from de_i2i_gan_torch.utils.png import write_png


def _save_image(arr, path: Path):
    arr = np.clip((np.asarray(arr) + 1.0) * 127.5, 0, 255).astype(np.uint8)
    write_png(path, arr)


def heatmap(prob: np.ndarray) -> np.ndarray:
    """JET-style colormap of a (H, W) probability map -> (H, W, 3) in [-1,1]
    (the reference uses cv2.applyColorMap(COLORMAP_JET),
    defectgan_model.py:336-338)."""
    p = np.clip(prob, 0, 1)
    r = np.clip(1.5 - np.abs(4 * p - 3), 0, 1)
    g = np.clip(1.5 - np.abs(4 * p - 2), 0, 1)
    b = np.clip(1.5 - np.abs(4 * p - 1), 0, 1)
    return np.stack([r, g, b], axis=-1) * 2.0 - 1.0


def _host(t: torch.Tensor) -> np.ndarray:
    return t.float().cpu().numpy()


def main(argv=None):
    """Run the asked test modes; returns the written PNGs and, with
    --cal_clf, the classifier accuracy."""
    from de_i2i_gan_torch.cli.train_defectgan import build_datasets
    from de_i2i_gan_torch.config.options import (
        Options, device_of, to_defectgan_config, to_train_config)
    from de_i2i_gan_torch.data.pipeline import DataLoader, InfiniteLoader
    from de_i2i_gan_torch.data.transforms import EvalTransform
    from de_i2i_gan_torch.metrics.evaluator import defectgan_generator_fn
    from de_i2i_gan_torch.train.checkpoint import load_checkpoint
    from de_i2i_gan_torch.train.jax_import import init_weights
    from de_i2i_gan_torch.train.steps import DefectGanSteps

    opt = Options("defectgan_test").parse(argv)
    cfg = to_defectgan_config(opt)
    datasets, clf_loss_type = build_datasets(
        opt, "test", EvalTransform(opt.image_size))
    tcfg = to_train_config(opt, clf_loss_type)

    steps = DefectGanSteps(cfg, tcfg, device=device_of(opt))
    steps.init_training()  # D, for --cal_clf
    init_weights(steps, opt.seed)
    name = opt.load_model_name or opt.name
    load_checkpoint(opt.ckpt_dir, name, opt.which_epoch, steps, strict=False)

    df_loader = DataLoader(datasets["defects"], opt.batch_size, seed=opt.seed)
    bg_loader = InfiniteLoader(DataLoader(datasets["background"],
                                          opt.batch_size, seed=opt.seed + 1))
    results_dir = Path(opt.results_dir) / name
    results_dir.mkdir(parents=True, exist_ok=True)
    device = steps.device
    gen = torch.Generator(device).manual_seed(opt.seed)
    generate = defectgan_generator_fn(steps, cfg, gen)
    result = {"pngs": []}
    evaluator = None
    if opt.metrics or opt.cal_mfid or opt.save_stats:
        from de_i2i_gan_torch.metrics.evaluator import Evaluator
        evaluator = Evaluator(dims=opt.dims, device=device)

    if opt.metrics:
        out = evaluator.evaluate_generator(
            generate, bg_loader, df_loader, num_imgs=opt.num_imgs,
            npz_path=Path(opt.npz_path) if opt.npz_path else None,
            metrics=tuple(opt.metrics),
            num_lpips_images=opt.num_lpips_images)
        print({k: round(v, 4) for k, v in out.items()})
        result["metrics"] = out
        if opt.metrics_out:
            Path(opt.metrics_out).parent.mkdir(parents=True, exist_ok=True)
            Path(opt.metrics_out).write_text(json.dumps(out))

    if opt.save_img_grid or opt.save_img:
        labels = torch.eye(cfg.label_nc, device=device)[1:]
        bg_imgs, _, _ = next(iter(bg_loader))
        bg_imgs = torch.as_tensor(bg_imgs[:opt.num_display_images],
                                  device=device)
        feat = None
        if cfg.style_norm_block_type == "sean":
            n = bg_imgs.shape[0] * labels.shape[0]
            feat = torch.zeros((n, cfg.num_embeds, cfg.embed_nc), device=device)
        rep = torch.repeat_interleave(bg_imgs, labels.shape[0], dim=0)
        rep_l = labels.repeat(bg_imgs.shape[0], 1)
        out, prob = steps.generate(rep, rep_l, feat, generator=gen)
        out = _host(out).reshape(bg_imgs.shape[0], labels.shape[0],
                                 *out.shape[1:])
        prob = _host(prob).reshape(bg_imgs.shape[0], labels.shape[0],
                                   *prob.shape[1:])
        for i in range(out.shape[0]):
            panels = [_host(bg_imgs[i])]
            for j in range(out.shape[1]):
                panels.append(out[i, j])
                if opt.save_img_grid:
                    panels.append(heatmap(prob[i, j, :, :, 0]))
            path = results_dir / f"grid_{i}.png"
            _save_image(np.concatenate(panels, axis=1), path)
            result["pngs"].append(path)
        print(f"wrote {out.shape[0]} grids to {results_dir}")

    if opt.cal_clf:
        correct = total = 0
        with torch.no_grad():
            for imgs, labels, _ in df_loader:
                _, cls = steps.D(torch.as_tensor(imgs, device=device))
                cls, labels = _host(cls), np.asarray(labels)
                if clf_loss_type == "bce":
                    correct += ((cls > 0) == (labels > 0.5)).all(1).sum()
                else:
                    correct += (cls.argmax(1) == labels.argmax(1)).sum()
                total += imgs.shape[0]
        result["classifier_accuracy"] = float(correct / max(total, 1))
        print(f"classifier accuracy: {result['classifier_accuracy']:.4f}")

    if opt.cal_mfid:
        result["mfid"] = cal_mfid(opt, cfg, evaluator, generate, bg_loader)

    if opt.save_diverse_images:
        # Multiple_<combo>/Single_<class> grids over one background batch
        # (test_defectgan.py:269-297): every multi-label combo seen in the
        # defect set, plus each single defect class.
        out_dir = results_dir / "images"
        out_dir.mkdir(parents=True, exist_ok=True)
        bg_imgs, _, _ = next(iter(bg_loader))
        bg_imgs = torch.as_tensor(bg_imgs[:opt.num_display_images],
                                  device=device)

        def grid_for(label_row, path):
            lbl = torch.as_tensor(label_row, dtype=torch.float32,
                                  device=device)[None].repeat(
                                      bg_imgs.shape[0], 1)
            out = _host(generate(bg_imgs, lbl))
            _save_image(np.concatenate(list(out), axis=1), path)
            result["pngs"].append(path)

        _, df_labels, _ = next(iter(df_loader))
        df_labels = np.asarray(df_labels)
        multi = np.unique(df_labels[df_labels.sum(axis=1) > 1], axis=0)
        for row in multi:
            grid_for(row, out_dir /
                     f"Multiple_{tuple(int(v) for v in row)}.png")
        for class_idx in range(1, cfg.label_nc):
            row = np.zeros(cfg.label_nc, np.float32)
            row[class_idx] = 1.0
            grid_for(row, out_dir / f"Single_{class_idx}.png")
        print(f"wrote {len(multi)} multi-label + {cfg.label_nc - 1} "
              f"single-label grids to {out_dir}")

    if opt.vis_style_embeds:
        result["style_embeds"] = style_embeds(opt, cfg, steps, df_loader,
                                              results_dir)

    if opt.save_stats:
        result["stats"] = save_stats(evaluator, df_loader, results_dir)
    return result


def _to_stats(v):
    """Raw (N, D) activations -> (mu, sigma), None for a single row (no
    covariance); a (mu, sigma) pair as is."""
    from de_i2i_gan_torch.metrics.fid import ActivationStats
    if isinstance(v, np.ndarray) and v.ndim == 2 and v.dtype != object:
        if v.shape[0] < 2:
            return None
        st = ActivationStats(v.shape[1])
        st.update(v.astype(np.float32))
        return st.finalize()
    return tuple(np.asarray(a, np.float64) for a in v)


def cal_mfid(opt, cfg, evaluator, generate, bg_loader) -> dict:
    """--cal_mfid (defectgan_metrics.py:104-123): for each single defect
    class with real statistics in ``--npy_path``, ``--num_imgs`` fakes of
    that class from the background stream, their FID, and the mean over
    classes (``mean``); JSON to ``--metrics_out``."""
    from de_i2i_gan_torch.metrics.fid import mfid_from_class_stats
    if not opt.npy_path:
        raise SystemExit("--cal_mfid requires --npy_path")
    p = Path(opt.npy_path)
    if p.is_dir():
        items = {f.stem[len("stats_"):]: np.load(f)
                 for f in sorted(p.glob("stats_*.npy"))}
    else:
        items = {("-".join(str(i) for i, x in enumerate(k) if x == 1)
                  if isinstance(k, tuple) else str(k)): v
                 for k, v in np.load(p, allow_pickle=True).item().items()}
    real_stats = {k: st for k, st in ((k, _to_stats(v))
                                      for k, v in items.items())
                  if st is not None}
    device = evaluator.device
    fake_acts, bg_it = {}, iter(bg_loader)
    for class_idx in range(1, cfg.label_nc):
        key = str(class_idx)
        if key not in real_stats:
            continue
        acts, seen = [], 0
        while seen < opt.num_imgs:
            bg_imgs, _, _ = next(bg_it)
            lbl = torch.zeros((bg_imgs.shape[0], cfg.label_nc), device=device)
            lbl[:, class_idx] = 1.0
            fake = generate(torch.as_tensor(bg_imgs, device=device), lbl)
            acts.append(evaluator.features(fake).cpu().numpy())
            seen += fake.shape[0]
        fake_acts[key] = np.concatenate(acts)
    res = mfid_from_class_stats(real_stats, fake_acts)
    per_class = {k: round(v, 4) for k, v in res.items() if k != "mean"}
    print(f"FID for each class: {per_class}")
    print(f"mFID: {res.get('mean', float('nan')):.4f}")
    if opt.metrics_out:
        Path(opt.metrics_out).parent.mkdir(parents=True, exist_ok=True)
        Path(opt.metrics_out).write_text(json.dumps(
            {"mfid": res.get("mean"), **per_class}))
    return res


def save_stats(evaluator, df_loader, results_dir: Path) -> list:
    """--save_stats: the defect set's Inception activations grouped by
    label combination, ``stats_<classes>.npy`` each (the mFID's real
    side). Returns the written paths."""
    acts: dict = {}
    for imgs, labels, _ in df_loader:
        feats = evaluator.features(imgs).cpu().numpy()
        for f, lbl in zip(feats, np.asarray(labels)):
            key = "-".join(str(i) for i, v in enumerate(lbl) if v == 1)
            acts.setdefault(key, []).append(f)
    paths = []
    for key, feats in acts.items():
        paths.append(results_dir / f"stats_{key}.npy")
        np.save(paths[-1], np.stack(feats))
    print(f"wrote per-class stats for {len(acts)} classes")
    return paths


STYLE_LAYERS = {"hidden": ("mlp_shared", "mlp_latent"), "mean": ("mlp_beta",),
                "std": ("mlp_gamma",)}


def style_embeds(opt, cfg, steps, df_loader, results_dir: Path) -> dict:
    """--vis_style_embeds: each style-MLP layer's first activation of every
    generate call over the defect set (a forward hook on G's modules of
    that name), averaged over the embedding axis of a 3-D output and the
    spatial axes of a 4-D one (test_defectgan.py:49-51), after a ReLU for
    ``hidden``; grouped by label and drawn as a PCA scatter a layer
    (``pca/<layer>.png``). SEAN takes the --embed_path bank's draws, or
    zero embeddings without one. Returns {layer: {label: [vectors]}}."""
    from de_i2i_gan_torch.data.embeddings import EmbeddingBank
    from de_i2i_gan_torch.utils.visualize import visualize_embeddings

    etype = opt.vis_style_embeds
    if etype not in STYLE_LAYERS:
        raise ValueError(f"--vis_style_embeds must be one of "
                         f"{list(STYLE_LAYERS)}")
    bank = None
    if cfg.style_norm_block_type == "sean" and opt.embed_path:
        p = str(opt.embed_path)
        bank = (EmbeddingBank.load(opt.embed_path) if p.endswith(".npz")
                else EmbeddingBank.from_torch_file(opt.embed_path, cfg.label_nc))
    captured = {}

    def hook(name):
        def keep(_mod, _inp, out):
            if name in captured:  # the first call, as flax's capture keeps
                return
            v = out.detach().float()
            v = v.mean(dim=1) if v.dim() == 3 else (
                v.mean(dim=(2, 3)) if v.dim() == 4 else v)
            captured[name] = F.relu(v) if etype == "hidden" else v
        return keep

    handles = [m.register_forward_hook(hook(n))
               for n, m in steps.G.named_modules()
               if n.rsplit(".", 1)[-1] in STYLE_LAYERS[etype]]
    device = steps.device
    gen = torch.Generator(device).manual_seed(opt.seed)
    layer_embeds: dict = {}
    try:
        with torch.no_grad():
            for imgs, labels, _ in df_loader:
                labels_t = torch.as_tensor(labels, device=device)
                feat = None
                if cfg.style_norm_block_type == "sean":
                    feat = (bank.sample(labels_t, cfg.num_embeds, gen) if bank
                            else torch.zeros((labels_t.shape[0], cfg.num_embeds,
                                              cfg.embed_nc), device=device))
                captured.clear()
                steps.generate(imgs, labels_t, feat, generator=gen)
                for lname, v in captured.items():
                    d = layer_embeds.setdefault(lname, {})
                    for e, lbl in zip(_host(v), np.asarray(labels)):
                        d.setdefault(tuple(int(x) for x in lbl), []).append(e)
    finally:
        for h in handles:
            h.remove()
    for lname, embeds in layer_embeds.items():
        visualize_embeddings(embeds, results_dir / "pca" / f"{lname}.png",
                             reduction="pca")
    print(f"wrote {len(layer_embeds)} style-embed PCA scatters ({etype}) to "
          f"{results_dir / 'pca'}")
    return layer_embeds


if __name__ == "__main__":
    main(sys.argv[1:])
