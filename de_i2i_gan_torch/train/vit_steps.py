"""The ViT classifier and style-embedding workload; counterpart of
``de_i2i_gan_tpu/train/vit_steps.py``.

Mirrors defectGAN/models/vit_model.py:9-59 and trainers/vit_trainer.py: a
frozen ViT backbone with a trainable linear head (``ViTClassifier``), in the
modes train, inference and get_embedding (the CLS token of the last hidden
state). The backbone never enters a graph: it is frozen
(``requires_grad_(False)``) and embeds under ``torch.no_grad``. Only the
head trains, through ``train/optim.py`` with ``tcfg.clf_loss_type``
(``cce`` from the CLI). The reference's AMP GradScaler has no counterpart,
as in the JAX package.

``ViTSteps`` holds the head, its optimizer ``tx_head`` and ``step``, the
count of updates, so ``train/checkpoint.py`` saves and restores it.
``dump_embeddings`` makes the per-label CLS embedding bank that DefectGAN's
SEAN reads (``--embed_path``).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from de_i2i_gan_torch.config import TrainConfig
from de_i2i_gan_torch.losses.common import cal_loss
from de_i2i_gan_torch.models.discriminator import ViTClassifier
from de_i2i_gan_torch.models.vit import ViTEncoder
from de_i2i_gan_torch.train.optim import make_optimizer


class ViTSteps:
    STATE_NETS = ("head",)
    STATE_OPTIMIZERS = ("head",)

    def __init__(self, label_nc: int, tcfg: TrainConfig,
                 model_size: str = "base", iters_per_epoch: int = 100,
                 num_epochs: int = 20, backbone: Optional[ViTEncoder] = None,
                 seed: int = 0, device: str | torch.device = "cuda"):
        """``backbone``: the frozen encoder (moved to ``device``), else one
        drawn from ``seed``; the head's kernel is drawn from ``seed`` too,
        normal(0, 0.02) as the JAX package's Dense init."""
        self.label_nc, self.tcfg = label_nc, tcfg
        self.device = torch.device(device)
        gen = torch.Generator(self.device).manual_seed(seed)
        if backbone is None:
            backbone = ViTEncoder(model_size, device=self.device, generator=gen)
        self.backbone = backbone.to(self.device).eval().requires_grad_(False)
        self.head = ViTClassifier(backbone.hidden, label_nc).to(self.device)
        with torch.no_grad():
            w = self.head.clf.weight
            w.copy_(torch.randn(w.shape, generator=gen, device=self.device)
                    * 0.02)
        self.tx_head = make_optimizer(tcfg, self.head.parameters(),
                                      tcfg.lr[0], iters_per_epoch, num_epochs)
        self.step = 0

    @torch.no_grad()
    def embed(self, imgs) -> torch.Tensor:
        """The frozen backbone's CLS embedding of NHWC images
        (vit_model.py:50-58), the same as the SEAN embedding dump's."""
        return self.backbone.cls_embedding(torch.as_tensor(imgs,
                                                           device=self.device))

    def loss_fn(self, embeds: torch.Tensor, labels: torch.Tensor):
        """(loss, accuracy): ``cal_loss`` of the head's logits, and argmax
        accuracy against one-hot (or integer) labels."""
        logits = self.head(embeds)
        loss = cal_loss(logits, labels, self.tcfg.clf_loss_type)
        target = labels.argmax(dim=-1) if labels.dim() == 2 else labels
        acc = (logits.argmax(dim=-1) == target).float().mean()
        return loss, acc

    def train_step(self, imgs, labels) -> Dict[str, torch.Tensor]:
        """One head update on a batch; {loss, acc} as 0-d tensors."""
        labels = torch.as_tensor(labels, device=self.device)
        loss, acc = self.loss_fn(self.embed(imgs), labels)
        self.tx_head.step(torch.autograd.grad(loss, self.tx_head.params))
        self.step += 1
        return {"loss": loss.detach(), "acc": acc}

    @torch.no_grad()
    def eval_step(self, imgs, labels) -> Dict[str, torch.Tensor]:
        loss, acc = self.loss_fn(self.embed(imgs),
                                 torch.as_tensor(labels, device=self.device))
        return {"loss": loss, "acc": acc}


def dump_embeddings(steps: ViTSteps, loader, label_nc: int) -> Dict:
    """The offline per-label CLS embedding bank SEAN reads (--embed_path;
    defectgan_model.py:43-45): {label tuple: [embedding, ...]} over the
    loader's (images, labels, names) batches."""
    bank: Dict = {}
    for imgs, labels, _ in loader:
        embeds = steps.embed(imgs).float().cpu().numpy()
        for e, l in zip(embeds, np.asarray(labels)):
            bank.setdefault(tuple(int(v) for v in l), []).append(e)
    return bank
