"""LPIPS perceptual distance, counterpart of
``de_i2i_gan_tpu/metrics/lpips.py``.

Mirrors the reference's two LPIPS uses: DefectGAN's intra-condition
diversity (torchmetrics, AlexNet backbone; defectGAN/metrics/
defectgan_metrics.py:20-41) and StarGAN v2's hand-rolled LPIPS, AlexNet
features and learned 1x1 weights (stargan-v2/metrics/lpips.py:49-98).

Structure: torchvision's ``alexnet.features`` stack (the same module
indices, so its state dict loads key for key), the features after each
ReLU unit-normalized over channels, their squared differences weighted by
the learned per-channel ``lin<i>`` (ones until loaded), averaged over
space and summed over layers. No weight file is in the repository:
``seeded_lpips`` draws the AlexNet from a seed, and its distances mean
nothing.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from de_i2i_gan_torch.metrics.inception import init_from_seed

# the standard LPIPS input normalization of [-1, 1] inputs
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)
CONV_IDS = (0, 3, 6, 8, 10)  # torchvision alexnet.features' convolutions


class AlexNetFeatures(nn.Module):
    """torchvision ``alexnet.features``; ``forward`` returns the NCHW map
    after each of its five ReLUs."""

    def __init__(self):
        super().__init__()
        self.features = nn.Sequential(
            nn.Conv2d(3, 64, 11, 4, 2), nn.ReLU(), nn.MaxPool2d(3, 2),
            nn.Conv2d(64, 192, 5, padding=2), nn.ReLU(), nn.MaxPool2d(3, 2),
            nn.Conv2d(192, 384, 3, padding=1), nn.ReLU(),
            nn.Conv2d(384, 256, 3, padding=1), nn.ReLU(),
            nn.Conv2d(256, 256, 3, padding=1), nn.ReLU())

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        taps = []
        for layer in self.features:
            x = layer(x)
            if isinstance(layer, nn.ReLU):
                taps.append(x)
        return taps


def _unit_normalize(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """x * rsqrt(sum over channels of x^2 + eps) (lpips.py:16-17)."""
    return x * torch.rsqrt(x.square().sum(dim=1, keepdim=True) + eps)


class LPIPS(nn.Module):
    """d(x, y): NHWC images in [-1, 1] -> (N,) perceptual distances, in
    float32."""

    def __init__(self):
        super().__init__()
        self.alex = AlexNetFeatures()
        for i, c in enumerate((64, 192, 384, 256, 256)):
            setattr(self, f"lin{i}", nn.Parameter(torch.ones(c)))
        self.register_buffer("shift", torch.tensor(_SHIFT)[:, None, None])
        self.register_buffer("scale", torch.tensor(_SCALE)[:, None, None])

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        def feats(img):
            img = img.permute(0, 3, 1, 2).float()
            return self.alex((img - self.shift) / self.scale)

        total = 0.0
        for i, (a, b) in enumerate(zip(feats(x), feats(y))):
            d = (_unit_normalize(a) - _unit_normalize(b)).square()
            w = getattr(self, f"lin{i}").abs()[:, None, None]
            total = total + (d * w).mean(dim=(2, 3)).sum(dim=1)
        return total


def seeded_lpips(seed: int = 0, device="cuda") -> LPIPS:
    """An eval-mode LPIPS on ``device`` whose AlexNet is drawn from
    ``seed`` (the ``lin`` weights stay ones)."""
    net = LPIPS().to(device)
    return init_from_seed(net, seed).eval().requires_grad_(False)


def load_torch_lpips_weights(alexnet_path, lin_path, net: LPIPS) -> LPIPS:
    """torchvision's alexnet state dict (``features.<i>.*``) into the
    AlexNet, and the LPIPS linear heads into ``lin<i>``: ``lin_path`` may be
    the official lpips ``alex.pth`` (``lin<i>.model.1.weight``), a
    ``lins.<i>...`` dict, or stargan-v2's ``lpips_weights.ckpt``
    (``lpips_weights.<i>.main.1.weight``)."""
    sd = torch.load(alexnet_path, map_location="cpu")
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    with torch.no_grad():
        for cid in CONV_IDS:
            conv = net.alex.features[cid]
            conv.weight.copy_(sd[f"features.{cid}.weight"])
            conv.bias.copy_(sd[f"features.{cid}.bias"])
        lin = torch.load(lin_path, map_location="cpu")
        if hasattr(lin, "state_dict"):
            lin = lin.state_dict()
        for i in range(len(CONV_IDS)):
            for key in (f"lin{i}.model.1.weight", f"lins.{i}.model.1.weight",
                        f"lpips_weights.{i}.main.1.weight", str(i)):
                if key in lin:
                    getattr(net, f"lin{i}").copy_(lin[key].reshape(-1))
                    break
    return net


def pairwise_lpips(lpips, images: torch.Tensor) -> torch.Tensor:
    """Mean LPIPS over all unordered pairs of a batch, the reference's
    intra-condition diversity (defectgan_metrics.py:20-41)."""
    idx_a, idx_b = np.triu_indices(images.shape[0], k=1)
    dev = images.device
    return lpips(images[torch.as_tensor(idx_a, device=dev)],
                 images[torch.as_tensor(idx_b, device=dev)]).mean()
