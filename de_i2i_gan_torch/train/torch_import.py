"""Reference PyTorch checkpoint import, counterpart of
``de_i2i_gan_tpu/train/torch_import.py``.

Loads the reference defectGAN's network state dicts (``{epoch}_net_G.pth``
and ``{epoch}_net_D.pth``, raw ``state_dict``s) into the port's generator
and discriminator, so that reference-trained weights can be evaluated or
fine-tuned here. Both sides are PyTorch layouts (conv OIHW, linear (out,
in)), so tensors are copied as they are; only the names change, as the JAX
module's docstring maps them:

  stem.conv_block.0 / .1                -> stem.conv / stem.norm
  enc_blk.{i}.conv_block.0 / .1         -> enc_{i}.conv / enc_{i}.norm
  enc_res_blk.{i}.res_block.{j}.conv_block.0 / .1
                                        -> enc_res_{i}.conv_{j}.conv / .norm
  dec_res_blk.{i}.norm_{j}.mlp_*        -> dec_res_{i}.norm_{j}.{spade|sean|adain}.mlp_*
  dec_res_blk.{i}.conv_{j}, .noise_{j}  -> dec_res_{i}.conv_{j}, .noise_{j}
  dec_blk.{i}.norm.mlp_*                -> dec_{i}.norm.{spade|sean|adain}.mlp_*
  dec_blk.{i}.conv, .noise              -> dec_{i}.conv, .noise
  foreground_head.de_conv_block.0       -> foreground_head.conv
  distribution_head.de_conv_block.0     -> distribution_head.conv
  (D) enc_blk.0.conv_block.0            -> stem.conv
  (D) enc_blk.{i>0}.conv_block.0        -> enc_{i-1}.conv
  (D) cls_clf.conv_block.0, src_clf.conv_block.0 -> cls_clf.conv, src_clf.conv

SPADE's shared conv and SEAN's shared and latent linears sit at index 0 of
a ``Sequential`` (``mlp_shared.0``, ``mlp_latent.0``). BatchNorm brings its
running statistics; the noise weights are reshaped to the port's (1,). A
spectrally normalized conv stores ``weight_orig`` (with its u and v): the
original weight is taken, and the target keeps its own u and v, as do
SEAN's running statistics, which the reference keeps elsewhere (the JAX
converter keeps the target's ``spectral`` and ``sean_stats`` collections).
A key the mapping needs and the file lacks raises ``KeyError``; keys it does
not read (``num_batches_tracked``, the reference's u and v) are ignored.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import torch
from torch import nn

from de_i2i_gan_torch.nn.blocks import BatchNorm

StateDict = Mapping[str, Any]


def _get(sd: StateDict, *keys: str) -> torch.Tensor:
    """The first of ``keys`` the state dict holds."""
    for key in keys:
        if key in sd:
            return torch.as_tensor(sd[key])
    raise KeyError(f"the checkpoint has no {' or '.join(keys)}")


def _conv(sd, out, dst: str, src: str, bias: bool = False) -> None:
    out[dst + ".weight"] = _get(sd, src + ".weight_orig", src + ".weight")
    if bias:
        out[dst + ".bias"] = _get(sd, src + ".bias")


def _linear(sd, out, dst: str, src: str) -> None:
    out[dst + ".weight"] = _get(sd, src + ".weight")
    out[dst + ".bias"] = _get(sd, src + ".bias")


def _bn(sd, out, dst: str, src: str) -> None:
    for name in ("weight", "bias", "running_mean", "running_var"):
        out[f"{dst}.{name}"] = _get(sd, f"{src}.{name}")


def _style_norm(sd, out, dst: str, src: str, style: str) -> None:
    """SPADE, SEAN or AdaIN under a reference norm module ``src``."""
    dst = f"{dst}.{style}"
    if style == "spade":
        _conv(sd, out, dst + ".mlp_shared", src + ".mlp_shared.0", bias=True)
        _conv(sd, out, dst + ".mlp_gamma", src + ".mlp_gamma", bias=True)
        _conv(sd, out, dst + ".mlp_beta", src + ".mlp_beta", bias=True)
        return
    if style == "sean":
        _linear(sd, out, dst + ".mlp_shared", src + ".mlp_shared.0")
        _linear(sd, out, dst + ".mlp_latent", src + ".mlp_latent.0")
    _linear(sd, out, dst + ".mlp_gamma", src + ".mlp_gamma")
    _linear(sd, out, dst + ".mlp_beta", src + ".mlp_beta")


def _noise(sd, out, dst: str, src: str) -> None:
    out[dst + ".weight"] = _get(sd, src + ".weight").reshape(-1)


def convert_defectgan_generator(sd: StateDict, cfg) -> Dict[str, torch.Tensor]:
    """A reference generator state dict -> the port's ``DefectGanGenerator``
    state-dict entries (parameters and BatchNorm statistics)."""
    style = cfg.style_norm_block_type
    out: Dict[str, torch.Tensor] = {}
    _conv(sd, out, "stem.conv", "stem.conv_block.0")
    _bn(sd, out, "stem.norm", "stem.conv_block.1")
    for i in range(cfg.num_scales):
        _conv(sd, out, f"enc_{i}.conv", f"enc_blk.{i}.conv_block.0")
        _bn(sd, out, f"enc_{i}.norm", f"enc_blk.{i}.conv_block.1")
    for i in range(cfg.num_res // 2):
        for j in range(2):
            src = f"enc_res_blk.{i}.res_block.{j}.conv_block"
            _conv(sd, out, f"enc_res_{i}.conv_{j}.conv", src + ".0")
            _bn(sd, out, f"enc_res_{i}.conv_{j}.norm", src + ".1")
    for i in range(cfg.num_res // 2):
        src, dst = f"dec_res_blk.{i}", f"dec_res_{i}"
        for j in range(2):
            _conv(sd, out, f"{dst}.conv_{j}", f"{src}.conv_{j}")
            _style_norm(sd, out, f"{dst}.norm_{j}", f"{src}.norm_{j}", style)
            if cfg.add_noise:
                _noise(sd, out, f"{dst}.noise_{j}", f"{src}.noise_{j}")
    for i in range(cfg.num_scales):
        src, dst = f"dec_blk.{i}", f"dec_{i}"
        _conv(sd, out, dst + ".conv", src + ".conv")
        _style_norm(sd, out, dst + ".norm", src + ".norm", style)
        if cfg.add_noise:
            _noise(sd, out, dst + ".noise", src + ".noise")
    _conv(sd, out, "foreground_head.conv", "foreground_head.de_conv_block.0")
    _conv(sd, out, "distribution_head.conv", "distribution_head.de_conv_block.0")
    return out


def convert_defectgan_discriminator(sd: StateDict, cfg
                                   ) -> Dict[str, torch.Tensor]:
    """A reference discriminator state dict -> the port's
    ``DefectGanDiscriminator`` parameters (it has no BatchNorm)."""
    out: Dict[str, torch.Tensor] = {}
    _conv(sd, out, "stem.conv", "enc_blk.0.conv_block.0")
    for i in range(cfg.num_layers):
        _conv(sd, out, f"enc_{i}.conv", f"enc_blk.{i + 1}.conv_block.0")
    _conv(sd, out, "cls_clf.conv", "cls_clf.conv_block.0")
    _conv(sd, out, "src_clf.conv", "src_clf.conv_block.0")
    return out


@torch.no_grad()
def load_converted(module: nn.Module, tensors: Mapping[str, torch.Tensor]
                   ) -> None:
    """Copy converted entries into ``module``: every parameter and every
    BatchNorm statistic, each of its shape; spectral u/v and SEAN's running
    statistics stay the module's own."""
    state = module.state_dict(keep_vars=True)
    want = {k for k, _ in module.named_parameters()}
    for name, m in module.named_modules():
        if isinstance(m, BatchNorm):
            want |= {f"{name}.running_mean", f"{name}.running_var"}
    missing, extra = sorted(want - set(tensors)), sorted(set(tensors) - want)
    if missing or extra:
        raise KeyError(f"converted entries do not fit {type(module).__name__}:"
                       f" missing {missing}, unexpected {extra}")
    for key, value in tensors.items():
        if tuple(value.shape) != tuple(state[key].shape):
            raise ValueError(f"{key}: the checkpoint's {tuple(value.shape)} "
                             f"does not fit {tuple(state[key].shape)}")
        state[key].copy_(value)


def import_torch_checkpoint(g_path, d_path, cfg, steps):
    """Load the reference's ``{epoch}_net_G.pth`` and ``_net_D.pth`` into a
    ``DefectGanSteps`` (its G, and its D, built first if training has not
    built it), on the steps' device. Returns ``steps``."""
    g_sd = torch.load(g_path, map_location="cpu", weights_only=True)
    d_sd = torch.load(d_path, map_location="cpu", weights_only=True)
    g = convert_defectgan_generator(g_sd, cfg)
    d = convert_defectgan_discriminator(d_sd, cfg)
    if steps.D is None:
        steps.init_training()
    load_converted(steps.G, g)
    load_converted(steps.D, d)
    return steps
