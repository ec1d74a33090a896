"""What the references share: the arithmetic of a layer written out in
plain torch, the losses, and Adam.

Every convolution and dense layer goes through an ``Ops`` object. In the
reference it computes in float32 (TF32 is switched off by the caller). The
control computes the same graph in float8, the precision below the
configurations' bfloat16: every conv and dense input, weight and output
rounded to e4m3 with one scale a tensor, gradients to e5m2 on the way back.
An ``Ops`` may also record the shape of each modulated instance norm it
runs, which is how the benchmark counts the norm kernels' bytes; and
everything runs on the ``meta`` device, which is how it counts FLOPs.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def _round_to(t: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    """``t`` rounded to ``dtype`` with one scale for the tensor (its largest
    magnitude maps to ``top``), returned in t's dtype."""
    amax = t.detach().abs().amax().float().clamp_min(1e-30)
    scale = top / amax
    return ((t.float() * scale).to(dtype).float() / scale).to(t.dtype)


class _Float8(torch.autograd.Function):
    """Forward: round to e4m3. Backward: the gradient rounded to e5m2."""

    @staticmethod
    def forward(ctx, t):
        return _round_to(t, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return _round_to(g, torch.float8_e5m2, E5M2_MAX)


class Ops:
    """The layers' arithmetic. ``precision``: "float32" (the reference),
    "float8" (the control) or "bfloat16" (a witness). Below float32 every
    convolution and dense layer takes its input and weight in that
    precision and rounds its output, the bias added, back to it, as the
    program does with its compute dtype (float8: e4m3 with one scale a
    tensor, gradients rounded to e5m2). ``norm_calls``: a list that
    receives (shape, with_backward) for each modulated instance norm, or
    None."""

    def __init__(self, precision: str = "float32",
                 norm_calls: Optional[List[Tuple[tuple, bool]]] = None):
        if precision not in ("float32", "float8", "bfloat16"):
            raise ValueError(f"unknown precision {precision!r}")
        self.precision = precision
        self.norm_calls = norm_calls

    def q(self, t: torch.Tensor) -> torch.Tensor:
        if self.precision == "float8":
            return _Float8.apply(t)
        if self.precision == "bfloat16":
            return t.to(torch.bfloat16).float()
        return t

    def conv2d(self, x, w, b=None, stride=1, padding=0):
        y = F.conv2d(self.q(x), self.q(w), None, stride, padding)
        return self.q(y if b is None else y + b[None, :, None, None])

    def linear(self, x, w, b=None):
        y = self.q(x) @ self.q(w).t()
        return self.q(y if b is None else y + b)

    def modulated_norm(self, x, gamma, beta, eps: float = 1e-5):
        """instance_norm(x) * (1 + gamma) + beta, gamma/beta (N, C), with
        two-pass statistics."""
        if self.norm_calls is not None:
            grad = torch.is_grad_enabled() and any(
                t.requires_grad for t in (x, gamma, beta))
            self.norm_calls.append((tuple(x.shape), grad))
        return (instance_norm(x, eps) * (1.0 + gamma[:, :, None, None])
                + beta[:, :, None, None])


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    mean = x.mean(dim=(2, 3), keepdim=True)
    xc = x - mean
    return xc * torch.rsqrt(xc.square().mean(dim=(2, 3), keepdim=True) + eps)


def leaky(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, x, 0.2 * x)


def reflect_pad(x: torch.Tensor, p: Tuple[int, int, int, int]) -> torch.Tensor:
    """Reflect padding (left, right, top, bottom) of NCHW x by gathering
    rows and columns (no pad wider than the axis occurs at these sizes)."""
    left, right, top, bottom = p
    h, w = x.shape[-2:]

    def index(n, lo, hi):
        i = torch.arange(-lo, n + hi, device=x.device).abs()
        return torch.where(i >= n, 2 * (n - 1) - i, i)

    if top or bottom:
        x = x.index_select(2, index(h, top, bottom))
    if left or right:
        x = x.index_select(3, index(w, left, right))
    return x


def same_pads(k: int) -> Tuple[int, int, int, int]:
    lo = (k - 1) // 2
    return (lo, k - 1 - lo, lo, k - 1 - lo)


def upsample2(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, scale_factor=2, mode="nearest")


def bce_logits(logits: torch.Tensor, target: float | torch.Tensor) -> torch.Tensor:
    t = torch.as_tensor(target, dtype=logits.dtype, device=logits.device)
    return (logits.clamp_min(0) - logits * t
            + torch.log1p(torch.exp(-logits.abs()))).mean()


def l1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a - b).abs().mean()


class Adam:
    """Adam as ``torch.optim.Adam`` computes it (bias corrections, eps added
    after the corrected root). Holds the parameters of one network by
    name."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float,
                 betas: Tuple[float, float], eps: float = 1e-8):
        self.params = params
        self.lr, self.betas, self.eps = lr, betas, eps
        self.exp_avg = {k: torch.zeros_like(v) for k, v in params.items()}
        self.exp_avg_sq = {k: torch.zeros_like(v) for k, v in params.items()}
        self.count = 0
        self.first = None  # the first moments right after the first update

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        self.count += 1
        b1, b2 = self.betas
        bc1 = 1 - b1 ** self.count
        bc2 = 1 - b2 ** self.count
        for k, p in self.params.items():
            g = grads[k]
            m, v = self.exp_avg[k], self.exp_avg_sq[k]
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = v.sqrt() / math.sqrt(bc2) + self.eps
            p.sub_(self.lr / bc1 * m / denom)
        if self.count == 1:
            self.first = {k: m.clone() for k, m in self.exp_avg.items()}


def grads_of(loss: torch.Tensor, params: Dict[str, torch.Tensor]
             ) -> Dict[str, torch.Tensor]:
    """d loss / d params by name; zeros for a parameter the loss does not
    reach."""
    names = list(params)
    gs = torch.autograd.grad(loss, [params[k] for k in names],
                             allow_unused=True)
    return {k: torch.zeros_like(params[k]) if g is None else g
            for k, g in zip(names, gs)}
