"""ViT encoder, the frozen feature backbone; counterpart of
``de_i2i_gan_tpu/models/vit.py``.

The reference uses HuggingFace ViTForImageClassification as (a) a frozen
style-embedding extractor (the CLS token of the last hidden state,
defectGAN/models/vit_model.py:19-21,50-58 and stargan-v2/core/model.py:535-572)
and (b) the backbone of a trainable linear classifier.

A standard ViT-B/16 (or L/16) encoder: a patch conv, a CLS token and learned
position embeddings, pre-LN transformer blocks (LayerNorm eps 1e-12, exact
GELU), returning the last hidden state *before* the final LayerNorm, CLS
first (HF's ``hidden_states[-1]``). It takes NHWC images in [-1, 1] and
resizes them to ``image_size`` with the bilinear filter that
``jax.image.resize`` uses: antialiased when it shrinks (256 -> 224).

Parameters live in float32; activations are cast to the compute ``dtype`` at
every matmul, and LayerNorm runs in float32. The attention is
``F.scaled_dot_product_attention`` (no Pallas kernel stands behind the
JAX package's). Weights come from a seed (``torch.Generator``): the flax
init's scales (lecun-normal kernels, untruncated; zero CLS token;
normal(0.02) position embeddings), from a local HF checkpoint
(``load_hf_vit_weights``) or from the JAX tree
(``train/jax_import.py::load_jax_vit``, the unrolled or the scanned layout).
"""
from __future__ import annotations

import copy
import math
from pathlib import Path
from typing import Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

SIZES = {
    "base": dict(hidden=768, layers=12, heads=12, mlp=3072),
    "large": dict(hidden=1024, layers=24, heads=16, mlp=4096),
    # test scale: the whole attention / CLS / position flow at a few
    # thousand parameters
    "tiny": dict(hidden=16, layers=1, heads=2, mlp=32),
}

Device = Union[str, torch.device]


def resize_bilinear(x: torch.Tensor, size: int) -> torch.Tensor:
    """NCHW x to (size, size), as ``jax.image.resize(..., "bilinear")``:
    half-pixel centres, antialiased when it shrinks (the same filter when it
    grows)."""
    if x.shape[-2:] == (size, size):
        return x
    return F.interpolate(x, size=(size, size), mode="bilinear",
                         align_corners=False, antialias=True)


class Linear(nn.Module):
    """``y = x W^T + b`` with float32 parameters, computed in ``dtype``."""

    def __init__(self, in_features: int, features: int, dtype: torch.dtype,
                 device: Device):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(features, in_features,
                                               device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype),
                        self.bias.to(self.dtype))


class LayerNorm(nn.LayerNorm):
    """LayerNorm (eps 1e-12) in float32, rounded to ``dtype``."""

    def __init__(self, features: int, dtype: torch.dtype, device: Device):
        super().__init__(features, eps=1e-12, device=device)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps).to(self.dtype)


class ViTBlock(nn.Module):
    """Pre-LN block (JAX :38): x + attn(ln1(x)), then x + fc2(gelu(fc1(ln2(x))));
    query/key/value/out are the flax ``DenseGeneral`` kernels
    (hidden, heads, head_dim) and (heads, head_dim, hidden) as (hidden, hidden)
    matrices."""

    def __init__(self, hidden: int, heads: int, mlp: int,
                 dtype: torch.dtype = torch.float32, device: Device = "cpu"):
        super().__init__()
        self.heads = heads
        self.ln1 = LayerNorm(hidden, dtype, device)
        self.query = Linear(hidden, hidden, dtype, device)
        self.key = Linear(hidden, hidden, dtype, device)
        self.value = Linear(hidden, hidden, dtype, device)
        self.out = Linear(hidden, hidden, dtype, device)
        self.ln2 = LayerNorm(hidden, dtype, device)
        self.fc1 = Linear(hidden, mlp, dtype, device)
        self.fc2 = Linear(mlp, hidden, dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, t, c = x.shape
        h = self.ln1(x)

        def split(y):  # (N, T, C) -> (N, heads, T, C / heads)
            return y.reshape(n, t, self.heads, c // self.heads).transpose(1, 2)

        a = F.scaled_dot_product_attention(split(self.query(h)),
                                           split(self.key(h)),
                                           split(self.value(h)))
        x = x + self.out(a.transpose(1, 2).reshape(n, t, c))
        h = self.fc2(F.gelu(self.fc1(self.ln2(x))))
        return x + h


class ViTEncoder(nn.Module):
    """JAX :58. ``forward(x)``: NHWC images in [-1, 1] -> the last hidden
    state (N, 1 + tokens, hidden), CLS first, before any final LayerNorm.
    Weights are drawn from ``generator`` (on ``device``), or from a
    generator seeded 0 there."""

    def __init__(self, model_size: str = "base", patch: int = 16,
                 image_size: int = 224, dtype: torch.dtype = torch.float32,
                 device: Device = "cpu",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        cfg = SIZES[model_size]
        self.model_size, self.patch, self.image_size = model_size, patch, image_size
        self.dtype = dtype
        hidden = self.hidden = cfg["hidden"]
        tokens = (image_size // patch) ** 2
        self.patch_embed = nn.utils.skip_init(nn.Conv2d, 3, hidden, patch, patch,
                                              device=device)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, hidden, device=device))
        self.pos_embed = nn.Parameter(torch.empty(1, 1 + tokens, hidden,
                                                  device=device))
        self.blocks = nn.ModuleList(
            ViTBlock(hidden, cfg["heads"], cfg["mlp"], dtype, device)
            for _ in range(cfg["layers"]))
        init_vit_weights(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = x.shape[0]
        x = resize_bilinear(x.permute(0, 3, 1, 2).float(), self.image_size)
        w = self.patch_embed
        h = F.conv2d(x.to(self.dtype), w.weight.to(self.dtype),
                     w.bias.to(self.dtype), stride=self.patch)
        h = h.flatten(2).transpose(1, 2)  # (N, tokens, hidden), row-major
        h = torch.cat([self.cls_token.to(h.dtype).expand(n, -1, -1), h], dim=1)
        h = h + self.pos_embed.to(h.dtype)
        for block in self.blocks:
            h = block(h)
        return h

    def cls_embedding(self, x: torch.Tensor) -> torch.Tensor:
        """(N, hidden): the CLS token of ``forward``."""
        return self(x)[:, 0, :]

    def frozen_copy(self, dtype: torch.dtype) -> "ViTEncoder":
        """A copy without gradients that computes in ``dtype``, its patch
        embedding, CLS token, position embeddings and Linear parameters
        stored in ``dtype`` (each forward rounds the float32 ones to it, so
        the numbers are the same, without the casts); LayerNorm keeps
        float32."""
        net = copy.deepcopy(self).requires_grad_(False)
        for m in net.modules():
            if hasattr(m, "dtype"):
                m.dtype = dtype
            if not isinstance(m, LayerNorm):
                for p in m.parameters(recurse=False):
                    p.data = p.data.to(dtype)
        return net


@torch.no_grad()
def init_vit_weights(net: ViTEncoder,
                     generator: Optional[torch.Generator] = None) -> None:
    """The flax init's scales from ``generator``: kernels normal with std
    1/sqrt(fan_in) (lecun), biases zero, LayerNorm ones and zeros, the CLS
    token zero, position embeddings normal(0.02)."""
    device = net.pos_embed.device
    if generator is None:
        generator = torch.Generator(device).manual_seed(0)

    def draw(t, std):
        t.copy_(torch.randn(t.shape, generator=generator, device=device) * std)

    draw(net.patch_embed.weight, 1.0 / math.sqrt(3 * net.patch ** 2))
    net.patch_embed.bias.zero_()
    net.cls_token.zero_()
    draw(net.pos_embed, 0.02)
    for block in net.blocks:
        for lin in (block.query, block.key, block.value, block.out,
                    block.fc1, block.fc2):
            draw(lin.weight, 1.0 / math.sqrt(lin.weight.shape[1]))
            lin.bias.zero_()
        for ln in (block.ln1, block.ln2):
            ln.weight.fill_(1.0)
            ln.bias.zero_()


class FeatureExtractor:
    """The frozen-ViT style embedding extractor (JAX :172,
    stargan-v2 core/model.py:535-572).

    ``extract(x_ref, num_embeds, generator)``: x_ref (N, E, H, W, C) or
    (N, H, W, C) -> (N, k, hidden) CLS embeddings, k uniform in
    [1, num_embeds] (drawn from ``generator``) when num_embeds > 0
    (model.py:552-555), else exactly -num_embeds; a 4-D x_ref gives k = 1.
    Runs without gradients on the encoder's device."""

    def __init__(self, net: ViTEncoder):
        self.net = net.requires_grad_(False)
        self.device = net.pos_embed.device

    @torch.no_grad()
    def extract(self, x_ref, num_embeds: int,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x_ref = torch.as_tensor(x_ref, device=self.device)
        if x_ref.dim() == 4:
            return self.net.cls_embedding(x_ref)[:, None, :]
        n = x_ref.shape[0]
        if num_embeds > 0:
            if generator is None:
                raise ValueError("drawing k needs a generator")
            k = int(torch.randint(1, num_embeds + 1, (1,), generator=generator,
                                  device=generator.device))
        else:
            k = -num_embeds
        flat = x_ref[:, :k].reshape(-1, *x_ref.shape[2:])
        return self.net.cls_embedding(flat).reshape(n, k, -1)


def _read_state_dict(path_or_name) -> dict:
    p = Path(path_or_name)
    if p.is_dir():
        cand = sorted(p.glob("*.bin")) + sorted(p.glob("*.safetensors"))
        if not cand:
            raise FileNotFoundError(f"no weights found under {p}")
        p = cand[0]
    if p.suffix == ".safetensors":
        from safetensors.torch import load_file  # only for this format
        return load_file(str(p))
    return torch.load(str(p), map_location="cpu", weights_only=True)


_HF_BLOCK = {"ln1": "layernorm_before", "ln2": "layernorm_after",
             "query": "attention.attention.query",
             "key": "attention.attention.key",
             "value": "attention.attention.value",
             "out": "attention.output.dense", "fc1": "intermediate.dense",
             "fc2": "output.dense"}


def hf_names(net: ViTEncoder) -> dict:
    """Each tensor of ``net`` -> its HF ViTModel key."""
    names = {"cls_token": "embeddings.cls_token",
             "pos_embed": "embeddings.position_embeddings",
             "patch_embed.weight": "embeddings.patch_embeddings.projection.weight",
             "patch_embed.bias": "embeddings.patch_embeddings.projection.bias"}
    for i in range(len(net.blocks)):
        for mine, theirs in _HF_BLOCK.items():
            for leaf in ("weight", "bias"):
                names[f"blocks.{i}.{mine}.{leaf}"] = \
                    f"encoder.layer.{i}.{theirs}.{leaf}"
    return names


@torch.no_grad()
def load_hf_vit_weights(path_or_name, net: ViTEncoder) -> ViTEncoder:
    """Fill ``net`` from an HF ViTModel / ViTForImageClassification state
    dict in a local directory, ``.bin`` or ``.safetensors`` file (JAX :202).
    HF keeps torch's layouts, so the tensors copy as they are; every tensor
    of ``net`` must be found. The final LayerNorm, pooler and classifier
    are not part of the encoder and are left out, as the JAX loader does."""
    sd = {k[len("vit."):] if k.startswith("vit.") else k: v
          for k, v in _read_state_dict(path_or_name).items()}
    names, own = hf_names(net), net.state_dict()
    missing = sorted(v for v in names.values() if v not in sd)
    if missing:
        raise KeyError(f"HF ViT state dict: missing {missing[:8]}")
    for mine, theirs in names.items():
        src = sd[theirs]
        if tuple(src.shape) != tuple(own[mine].shape):
            raise ValueError(f"{theirs}: shape {tuple(src.shape)} does not "
                             f"fit {mine} {tuple(own[mine].shape)}")
        own[mine].copy_(src.to(own[mine].dtype))
    return net


def hf_state_dict(net: ViTEncoder) -> dict:
    """``net``'s weights under the HF ViTModel key names (the inverse of
    ``load_hf_vit_weights``), on the CPU."""
    own = net.state_dict()
    return {theirs: own[mine].detach().cpu().clone()
            for mine, theirs in hf_names(net).items()}
