"""Primitive layers: conv / dense, padding, resampling.

Counterpart of ``de_i2i_gan_tpu/nn/layers.py``, in NCHW:
  * parameters live in float32; activations are cast to the compute dtype at
    every conv and dense, and the float32 bias add is rounded back to it, so
    bfloat16 rounds in the same places as the JAX package
  * weights use torch's layouts (conv OIHW, dense (out, in));
    ``train/jax_import.py`` maps the flax HWIO / (in, out) kernels onto them
  * spectral normalization keeps its power-iteration vectors as the buffers
    ``weight_u`` (out,) and ``weight_v`` (in*kh*kw,), the flax ``spectral``
    collection's ``kernel_u``/``kernel_v``: one power iteration per
    train-mode forward (``module.training``), the stored vectors in eval
    mode. The matrix is the weight's (out, in*kh*kw) view, so ``weight_v``
    runs over (in, kh, kw) where the flax ``kernel_v`` runs over (kh, kw, in)
  * a ``Conv2d`` with a height shard attached (``parallel/spatial.py``)
    runs on a band of rows: H is padded with the neighbouring bands' rows,
    and as before at the image's top and bottom edges
"""
from __future__ import annotations

from typing import Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

PaddingLike = Union[int, str, Tuple[int, int]]
Pads = Tuple[Tuple[int, int], Tuple[int, int]]


def _pair(v) -> Tuple[int, int]:
    if isinstance(v, (tuple, list)):
        return (int(v[0]), int(v[1]))
    return (int(v), int(v))


def _resolve_padding(padding: PaddingLike, kernel_size: Tuple[int, int],
                     strides: Tuple[int, int]) -> Pads:
    """torch-compatible padding resolution.

    'same'  -> total = k-1 split (left = total//2, right = total-left); torch
               only allows this for stride 1 and so do we.
    int/pair-> symmetric.
    'valid' -> zero padding.
    """
    kh, kw = kernel_size
    if padding == "same":
        if strides != (1, 1):
            raise ValueError("'same' padding requires stride 1 (torch semantics)")
        th, tw = kh - 1, kw - 1
        return ((th // 2, th - th // 2), (tw // 2, tw - tw // 2))
    if padding == "valid":
        return ((0, 0), (0, 0))
    ph, pw = _pair(padding)
    return ((ph, ph), (pw, pw))


def _reflect_index(n: int, lo: int, hi: int, device) -> torch.Tensor:
    """Source rows of a reflect pad of (lo, hi) on an axis of length n, with
    numpy's repeated-reflection semantics when the pad is >= the axis (the
    case where ``F.pad(mode="reflect")`` raises)."""
    idx = torch.arange(-lo, n + hi, device=device)
    if n == 1:
        return torch.zeros_like(idx)
    period = 2 * (n - 1)
    idx = torch.remainder(idx, period)
    return torch.where(idx >= n, period - idx, idx)


def pad_image(x: torch.Tensor, pads: Pads, mode: str) -> torch.Tensor:
    """Pad an NCHW image on H and W. mode: 'zeros' | 'reflect' | 'replicate'."""
    (pt, pb), (pl, pr) = pads
    if pt == pb == pl == pr == 0:
        return x
    if mode == "zeros":
        return F.pad(x, (pl, pr, pt, pb))
    if mode == "replicate":
        return F.pad(x, (pl, pr, pt, pb), mode="replicate")
    if mode != "reflect":
        raise ValueError(f"unknown padding mode {mode}")
    h, w = x.shape[-2:]
    if max(pt, pb) < h and max(pl, pr) < w:
        return F.pad(x, (pl, pr, pt, pb), mode="reflect")
    # pad wider than the axis (tiny feature maps): repeated reflection
    x = x.index_select(-2, _reflect_index(h, pt, pb, x.device))
    return x.index_select(-1, _reflect_index(w, pl, pr, x.device))


def _unit(n: int, eps: float = 1e-12) -> torch.Tensor:
    v = torch.randn(n)
    return v / (torch.linalg.vector_norm(v) + eps)


def spectral_normalize(weight: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                       update: bool, eps: float = 1e-12) -> torch.Tensor:
    """``weight / sigma`` with sigma = u . (W v), W the (out, -1) view of
    ``weight`` (JAX ``nn/layers.py::spectral_normalize``).

    With ``update``, one power iteration on the detached float32 W first
    writes new u and v into the buffers. sigma takes u and v as constants, so
    the gradient reaches the weight through W alone.
    """
    mat = weight.reshape(weight.shape[0], -1).float()
    if update:
        with torch.no_grad():
            v_new = mat.T @ u
            v_new = v_new / (torch.linalg.vector_norm(v_new) + eps)
            u_new = mat @ v_new
            u.copy_(u_new / (torch.linalg.vector_norm(u_new) + eps))
            v.copy_(v_new)
    # clones: a later forward updates the buffers in place while this
    # forward's graph still holds them
    sigma = u.clone() @ (mat @ v.clone())
    return weight / sigma.to(weight.dtype)


class _SpectralWeight(nn.Module):
    """A float32 ``weight`` parameter, spectrally normalized when asked."""

    def _init_weight(self, shape, use_spectral: bool) -> None:
        self.use_spectral = use_spectral
        self.weight = nn.Parameter(torch.empty(shape).normal_(0, 0.02))
        if use_spectral:
            d = self.weight[0].numel()
            self.register_buffer("weight_u", _unit(shape[0]))
            self.register_buffer("weight_v", _unit(d))

    def _weight(self) -> torch.Tensor:
        if not self.use_spectral:
            return self.weight
        return spectral_normalize(self.weight, self.weight_u, self.weight_v,
                                  update=self.training)


class Conv2d(_SpectralWeight):
    """2-D convolution with torch-compatible padding (flax ``Conv2d``)."""

    shard = None  # a parallel.spatial.HeightShard: x is a band of rows

    def __init__(self, in_features: int, features: int,
                 kernel_size: PaddingLike = (3, 3), strides=(1, 1),
                 padding: PaddingLike = 0, padding_mode: str = "zeros",
                 use_bias: bool = False, use_spectral: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.kernel_size = _pair(kernel_size)
        self.strides = _pair(strides)
        self.pads = _resolve_padding(padding, self.kernel_size, self.strides)
        self.padding_mode = padding_mode
        self.dtype = dtype
        self._init_weight((features, in_features, *self.kernel_size),
                          use_spectral)
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.run(x, self.shard)

    def run(self, x: torch.Tensor, shard=None) -> torch.Tensor:
        """The conv of x, a band of rows of ``shard`` (None: whole
        images)."""
        if shard is None:
            x = pad_image(x, self.pads, self.padding_mode)
        else:
            x = shard.pad(x, self.pads, self.padding_mode)
        y = F.conv2d(x.to(self.dtype), self._weight().to(self.dtype),
                     stride=self.strides)
        if self.bias is not None:
            y = y + self.bias[:, None, None]
        return y.to(self.dtype)


class Dense(_SpectralWeight):
    """Linear layer (flax ``Dense``); weight is torch's (out, in)."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 use_spectral: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self._init_weight((features, in_features), use_spectral)
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.linear(x.to(self.dtype), self._weight().to(self.dtype))
        if self.bias is not None:
            y = y + self.bias
        return y.to(self.dtype)


def randn(shape, generator=None, dtype: torch.dtype = torch.float32,
          device=None) -> torch.Tensor:
    """Standard-normal draws of ``shape`` from ``generator``: a
    ``torch.Generator`` (None: torch's default one of the device), or a
    source with a ``normal(shape, dtype, device)`` method, such as
    ``serving.SeededNoise``, which keys its draws on a seed tensor inside an
    exported graph."""
    if generator is None or isinstance(generator, torch.Generator):
        return torch.randn(shape, generator=generator, dtype=dtype,
                           device=device)
    return generator.normal(shape, dtype, device)


def upsample_nearest(x: torch.Tensor, scale: int = 2) -> torch.Tensor:
    """Nearest-neighbour upsample of NCHW (torch nn.Upsample(scale_factor=2))."""
    return F.interpolate(x, scale_factor=scale, mode="nearest")


def avg_pool(x: torch.Tensor, window: int = 2, stride: int = 2) -> torch.Tensor:
    """NCHW average pooling (torch nn.AvgPool2d)."""
    return F.avg_pool2d(x, window, stride)


def max_pool(x: torch.Tensor, window: int = 3, stride: int = 2,
             padding: int = 1) -> torch.Tensor:
    """NCHW max pooling (torch nn.MaxPool2d): the padding is -inf, as the
    JAX package pads."""
    return F.max_pool2d(x, window, stride, padding)


def adaptive_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """Global average pool of NCHW to (N, C) (torch nn.AdaptiveAvgPool2d(1))."""
    return x.mean(dim=(2, 3))
