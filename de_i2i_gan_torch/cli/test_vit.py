"""ViT classifier evaluation and the per-label CLS-embedding dump,
counterpart of ``de_i2i_gan_tpu/cli/test_vit.py`` (reference:
defectGAN/test_vit.py).

Modes (composable, as in the reference):
  --calc_classifier_acc    exact-match accuracy and loss of the linear head
                           (test_vit.py:24-37)
  --visualize_tsne         t-SNE scatter of the per-label CLS embeddings
                           (test_vit.py:104-109; skipped, with a message,
                           without matplotlib or sklearn)
  --save_embeddings        the per-label embedding bank ->
                           ``<results_dir>/<name>/<which_epoch>_<phase>_
                           <data_type>_embeddings.npz``, the --embed_path
                           file DefectGAN's SEAN reads (test_vit.py:53-66)

The reference evaluates under the *augmented* transform (flips and colour
jitter, test_vit.py:86-94) so that the bank covers appearance variation;
so does this CLI. The head comes from ``<ckpt_dir>/<name>/<which_epoch>``
(a filtered load). The backbone is ``--vit_path``'s, or the one
``cli.train_vit`` drew from the same ``--seed``; the JAX CLI reads no
``--vit_path`` here, so its bank would come from a random backbone even
when the head was trained on a real one. ``--gpu_ids -1`` runs on the CPU.
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np


def main(argv=None):
    """Run the asked modes; returns {"accuracy", "loss", "bank",
    "embeddings_path"} for what ran."""
    import torch

    from de_i2i_gan_torch.cli.train_vit import build_backbone
    from de_i2i_gan_torch.config.options import (
        Options, device_of, to_train_config)
    from de_i2i_gan_torch.data.datasets import find_dataset_using_name
    from de_i2i_gan_torch.data.pipeline import DataLoader
    from de_i2i_gan_torch.data.transforms import TrainTransform
    from de_i2i_gan_torch.losses.common import cal_loss
    from de_i2i_gan_torch.train.checkpoint import load_checkpoint
    from de_i2i_gan_torch.train.vit_steps import ViTSteps, dump_embeddings

    opt = Options("vit_test").parse(argv)
    opt.label_nc = getattr(opt, "label_nc", 6)
    cls = find_dataset_using_name(opt.dataset_name)
    if opt.dataset_name == "synthetic":
        dataset = cls(image_size=opt.image_size, label_nc=opt.label_nc,
                      length=64, data_type=opt.data_type, seed=opt.seed)
    else:
        dataset = cls(opt.data_dir, opt.dataset_name, opt.phase,
                      opt.data_type, transform=TrainTransform(opt.image_size),
                      seed=opt.seed)
    clf_loss_type = cls.clf_loss_type
    print(f"{len(dataset)} images in {opt.phase} {opt.data_type} set")

    tcfg = to_train_config(opt, clf_loss_type)
    device = device_of(opt)
    loader = DataLoader(dataset, opt.batch_size, seed=opt.seed)
    steps = ViTSteps(opt.label_nc, tcfg, opt.model_size,
                     iters_per_epoch=len(loader), num_epochs=1,
                     backbone=build_backbone(opt, device), seed=opt.seed,
                     device=device)
    name = opt.load_model_name or opt.name
    load_checkpoint(opt.ckpt_dir, name, opt.which_epoch, steps, strict=False)
    results_dir = Path(opt.results_dir) / name
    results_dir.mkdir(parents=True, exist_ok=True)
    stem = f"{opt.which_epoch}_{opt.phase}_{opt.data_type}"
    result = {}

    if opt.calc_classifier_acc:
        correct, total, losses = 0, 0, []
        with torch.no_grad():
            for imgs, labels, _ in loader:
                logits = steps.head(steps.embed(imgs))
                labels_t = torch.as_tensor(labels, device=steps.device)
                losses.append(float(cal_loss(logits, labels_t, clf_loss_type)))
                logits, labels = logits.float().cpu().numpy(), np.asarray(labels)
                if clf_loss_type == "bce":
                    # sigmoid(x) >= 0.5 <=> x >= 0; an exact multi-label
                    # match (test_vit.py:31-33)
                    correct += ((logits >= 0) == (labels > 0.5)).all(1).sum()
                else:
                    correct += (logits.argmax(1) == labels.argmax(1)).sum()
                total += imgs.shape[0]
        result["accuracy"] = float(correct / max(total, 1))
        result["loss"] = float(np.mean(losses))
        print(f"Acc: {result['accuracy']:.3f} ({correct}/{total}), "
              f"Loss: {result['loss']:.3f}")

    if opt.visualize_tsne or opt.save_embeddings:
        bank_dict: dict = {}
        for _ in range(max(opt.num_embeddings_epochs, 1)):
            part = dump_embeddings(steps, iter(loader), opt.label_nc)
            for k, v in part.items():
                bank_dict.setdefault(k, []).extend(v)
        n = sum(len(v) for v in bank_dict.values())
        print(f"collected {n} embeddings over {len(bank_dict)} label combos")
        result["bank"] = bank_dict

        if opt.visualize_tsne:
            from de_i2i_gan_torch.utils.visualize import visualize_embeddings
            out = results_dir / f"{stem}_tsne_test.png"
            visualize_embeddings(bank_dict, out, reduction="tsne")
            print(f"t-SNE scatter -> {out}")

        if opt.save_embeddings:
            from de_i2i_gan_torch.data.embeddings import EmbeddingBank
            bank = EmbeddingBank.from_dict(bank_dict, opt.label_nc)
            out = results_dir / f"{stem}_embeddings.npz"
            bank.save(out)
            result["embeddings_path"] = out
            print(f"Embeddings saved to {out}")
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
