"""InceptionV3 feature extractor for FID and IS, counterpart of
``de_i2i_gan_tpu/metrics/inception.py``.

The pytorch-fid network (the reference's defectGAN/metrics/inception.py):
torchvision's InceptionV3 topology with the FID tweaks — the average-pool
branches leave the padding out of their count (``count_include_pad=False``)
and the last InceptionE block (Mixed_7c) pools with a max. Modules and
parameter names are torchvision's (``Mixed_5b.branch1x1.conv.weight``,
``....bn.running_mean``), so ``load_torch_inception_weights`` loads a
pytorch-fid / torchvision state dict key for key (its classifier ``fc`` is
not needed for features).

Feature taps as ``BLOCK_INDEX_BY_DIM`` (inception.py:24-29): 64 -> after
maxpool1, 192 -> after maxpool2, 768 -> after Mixed_6e, 2048 -> the global
average pool of Mixed_7c.

Input: NHWC float in [-1, 1] (the reference normalizes with mean and std
0.5), resized to 299x299 bilinearly when ``resize_input`` (as
``jax.image.resize``: antialiased when it shrinks). The taps come back NHWC
(maps) or (N, 2048). The network runs in float32.

No weight file is in the repository: ``seeded_inception`` draws the weights
from a seed, so the features are input-dependent but mean nothing.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from de_i2i_gan_torch.models.vit import resize_bilinear

BLOCK_INDEX_BY_DIM = {64: 0, 192: 1, 768: 2, 2048: 3}


class BasicConv2d(nn.Module):
    """conv (no bias) + BatchNorm (eps 1e-3, running statistics) + relu."""

    def __init__(self, in_features: int, features: int, kernel=1, stride=1,
                 padding=0):
        super().__init__()
        self.conv = nn.Conv2d(in_features, features, kernel, stride, padding,
                              bias=False)
        self.bn = nn.BatchNorm2d(features, eps=1e-3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


def _avg_pool_nopad(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 average pool, zero padding left out of the count."""
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)


def _max_pool(x: torch.Tensor, stride: int = 2, padding: int = 0):
    return F.max_pool2d(x, 3, stride, padding)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64)
        self.branch5x5_1 = BasicConv2d(cin, 48)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(cin, pool_features)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), b5, b3,
                          self.branch_pool(_avg_pool_nopad(x))], dim=1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, _max_pool(x)], dim=1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 192)
        self.branch7x7_1 = BasicConv2d(cin, c7)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(cin, 192)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        return torch.cat([self.branch1x1(x), b7, bd,
                          self.branch_pool(_avg_pool_nopad(x))], dim=1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, _max_pool(x)], dim=1)


class InceptionE(nn.Module):
    """Mixed_7b pools with the no-pad average, Mixed_7c with a max (the FID
    tweak)."""

    def __init__(self, cin: int, pool_type: str = "avg"):
        super().__init__()
        self.pool_type = pool_type
        self.branch1x1 = BasicConv2d(cin, 320)
        self.branch3x3_1 = BasicConv2d(cin, 384)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], dim=1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)],
                       dim=1)
        pooled = (_avg_pool_nopad(x) if self.pool_type == "avg"
                  else _max_pool(x, 1, 1))
        return torch.cat([self.branch1x1(x), b3, bd,
                          self.branch_pool(pooled)], dim=1)


class InceptionV3(nn.Module):
    """``forward(x)`` returns {block: feature} for the ``output_blocks``."""

    def __init__(self, output_blocks: Sequence[int] = (3,),
                 resize_input: bool = True):
        super().__init__()
        self.output_blocks = tuple(output_blocks)
        self.resize_input = resize_input
        self.last = max(self.output_blocks)
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        if self.last >= 1:
            self.Conv2d_3b_1x1 = BasicConv2d(64, 80)
            self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        if self.last >= 2:
            self.Mixed_5b = InceptionA(192, 32)
            self.Mixed_5c = InceptionA(256, 64)
            self.Mixed_5d = InceptionA(288, 64)
            self.Mixed_6a = InceptionB(288)
            self.Mixed_6b = InceptionC(768, 128)
            self.Mixed_6c = InceptionC(768, 160)
            self.Mixed_6d = InceptionC(768, 160)
            self.Mixed_6e = InceptionC(768, 192)
        if self.last >= 3:
            self.Mixed_7a = InceptionD(768)
            self.Mixed_7b = InceptionE(1280, "avg")
            self.Mixed_7c = InceptionE(2048, "max")

    def forward(self, x: torch.Tensor) -> Dict[int, torch.Tensor]:
        x = x.permute(0, 3, 1, 2).float()
        if self.resize_input:
            x = resize_bilinear(x, 299)
        out = {}

        def tap(i, h):
            if i in self.output_blocks:
                out[i] = h.permute(0, 2, 3, 1) if i < 3 else h.mean(dim=(2, 3))
            return i == self.last

        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        if tap(0, x := _max_pool(x)):
            return out
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        if tap(1, x := _max_pool(x)):
            return out
        for name in ("5b", "5c", "5d", "6a", "6b", "6c", "6d", "6e"):
            x = getattr(self, f"Mixed_{name}")(x)
        if tap(2, x):
            return out
        for name in ("7a", "7b", "7c"):
            x = getattr(self, f"Mixed_{name}")(x)
        tap(3, x)
        return out


def init_from_seed(net: nn.Module, seed: int = 0) -> nn.Module:
    """Draw ``net``'s conv and linear weights from ``seed`` (He normal, so
    the activations neither vanish nor blow up through a deep ReLU stack;
    biases zero), on the CPU and then copied to the net's device, so every
    device gets the same weights. BatchNorm stays the identity."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                fan_in = m.weight[0].numel()
                w = torch.randn(m.weight.shape, generator=gen)
                m.weight.copy_(w * (2.0 / fan_in) ** 0.5)
                if m.bias is not None:
                    m.bias.zero_()
    return net


def seeded_inception(output_blocks: Sequence[int] = (3,), seed: int = 0,
                     device="cuda") -> InceptionV3:
    """An eval-mode InceptionV3 on ``device`` with weights drawn from
    ``seed`` (no pretrained file is in the repository)."""
    net = InceptionV3(output_blocks).to(device)
    return init_from_seed(net, seed).eval().requires_grad_(False)


def load_torch_inception_weights(path, net: InceptionV3) -> InceptionV3:
    """Load a pytorch-fid / torchvision InceptionV3 ``.pth`` state dict into
    ``net``: the same keys, the classifier and BatchNorm's
    ``num_batches_tracked`` left out. Keys of the blocks ``net`` keeps must
    all be there."""
    sd = torch.load(path, map_location="cpu")
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    own = net.state_dict()
    want = {k for k in own if not k.endswith("num_batches_tracked")}
    missing = sorted(want - set(sd))
    if missing:
        raise KeyError(f"{path}: no weights for {missing[:5]} "
                       f"({len(missing)} keys)")
    net.load_state_dict({k: sd[k] for k in want}, strict=False)
    return net
