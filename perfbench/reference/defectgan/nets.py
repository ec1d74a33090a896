"""DefectGAN's networks written out as functions of a dict of tensors keyed
by the program's parameter names: the generator with the AdaIN decoder, the
style extractor that encodes an image, and the discriminator
(jason2714/de-i2i-gan, defectGAN's generator, extractor and
discriminator). NCHW inside, NHWC at the edges, as the program.

Departures from the program, none of which changes the mathematics: every
activation is float32 (the program rounds to bfloat16 at each conv and
dense); reflect padding is a gather; BatchNorm is written out.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from perfbench.reference.common import (
    Ops, instance_norm, leaky, reflect_pad, same_pads, upsample2)

Params = Dict[str, torch.Tensor]
BN_EPS = 1e-5
BN_MOMENTUM = 0.1
MAX_STYLE_DIM = 256


def _pow2_blocks(size: int) -> int:
    return size.bit_length() - 1 - 3


def generator_shapes(m: dict) -> Dict[str, tuple]:
    """Parameter shapes of the AdaIN generator of model config ``m``."""
    s: Dict[str, tuple] = {}
    ngf, hid = m["ngf"], m["hidden_nc"]

    def bn(name, c):
        s[f"{name}.weight"] = (c,)
        s[f"{name}.bias"] = (c,)

    def adain(name, c):
        for head in ("mlp_gamma", "mlp_beta"):
            s[f"{name}.adain.{head}.weight"] = (c, hid)
            s[f"{name}.adain.{head}.bias"] = (c,)

    s["stem.conv.weight"] = (ngf, m["input_nc"], 7, 7)
    bn("stem.norm", ngf)
    c = ngf
    for i in range(m["num_scales"]):
        s[f"enc_{i}.conv.weight"] = (2 * c, c, 4, 4)
        bn(f"enc_{i}.norm", 2 * c)
        c *= 2
    for i in range(m["num_res"] // 2):
        for j in (0, 1):
            s[f"enc_res_{i}.conv_{j}.conv.weight"] = (c, c, 3, 3)
            bn(f"enc_res_{i}.conv_{j}.norm", c)
    for i in range(m["num_res"] // 2):
        adain(f"dec_res_{i}.norm_0", c)
        s[f"dec_res_{i}.conv_0.weight"] = (c, c, 3, 3)
        adain(f"dec_res_{i}.norm_1", c)
        s[f"dec_res_{i}.conv_1.weight"] = (c, c, 3, 3)
    for i in range(m["num_scales"]):
        adain(f"dec_{i}.norm", c)
        s[f"dec_{i}.conv.weight"] = (c // 2, c, 3, 3)
        c //= 2
    s["foreground_head.conv.weight"] = (m["output_nc"], c, 3, 3)
    s["distribution_head.conv.weight"] = (1, c, 3, 3)
    return s


def generator_buffers(m: dict, device) -> Params:
    """BatchNorm running statistics at their initial values."""
    out = {}
    for name, shape in generator_shapes(m).items():
        if name.endswith(".norm.weight"):
            base = name[:-len(".weight")]
            out[f"{base}.running_mean"] = torch.zeros(shape, device=device)
            out[f"{base}.running_var"] = torch.ones(shape, device=device)
    return out


def extractor_shapes(m: dict) -> Dict[str, tuple]:
    s = {"stem.conv.weight": (m["ndf"], m["input_nc"], 7, 7)}
    c = m["ndf"]
    for i in range(_pow2_blocks(m["image_size"])):
        nxt = min(2 * c, MAX_STYLE_DIM)
        s[f"res_{i}.conv_0.conv.weight"] = (c, c, 3, 3)
        s[f"res_{i}.conv_1.conv.weight"] = (nxt, c, 3, 3)
        s[f"res_{i}.conv_s.conv.weight"] = (nxt, c, 1, 1)
        c = nxt
    s["head.conv.weight"] = (m["hidden_nc"], c, 4, 4)
    return s


def discriminator_shapes(m: dict) -> Dict[str, tuple]:
    s = {"stem.conv.weight": (m["ndf"], m["input_nc"], 4, 4)}
    c = m["ndf"]
    for i in range(m["num_layers"]):
        s[f"enc_{i}.conv.weight"] = (2 * c, c, 4, 4)
        c *= 2
    ks = m["image_size"] // 2 ** (m["num_layers"] + 1)
    s["cls_clf.conv.weight"] = (m["label_nc"], c, ks, ks)
    s["src_clf.conv.weight"] = (1, c, 3, 3)
    return s


def _conv(ops: Ops, P: Params, name: str, x, stride=1, pads=None,
          reflect=True):
    if pads is not None and any(pads):
        x = reflect_pad(x, pads) if reflect else torch.nn.functional.pad(x, pads)
    return ops.conv2d(x, P[name], P.get(name.replace("weight", "bias")),
                      stride)


def _batch_norm(P: Params, B: Params, name: str, x, train: bool,
                groups: int):
    w, b = P[f"{name}.weight"], P[f"{name}.bias"]
    rm, rv = B[f"{name}.running_mean"], B[f"{name}.running_var"]
    if not train:
        return ((x - rm[:, None, None]) * torch.rsqrt(rv + BN_EPS)[:, None, None]
                * w[:, None, None] + b[:, None, None])
    parts = []
    for part in x.chunk(groups, dim=0):
        mean = part.mean(dim=(0, 2, 3))
        var = (part - mean[:, None, None]).square().mean(dim=(0, 2, 3))
        parts.append((part - mean[:, None, None])
                     * torch.rsqrt(var + BN_EPS)[:, None, None]
                     * w[:, None, None] + b[:, None, None])
        with torch.no_grad():
            rm.lerp_(mean.detach(), BN_MOMENTUM)
            rv.lerp_(var.detach(), BN_MOMENTUM)
    return torch.cat(parts, dim=0)


def _adain(ops: Ops, P: Params, name: str, x, style):
    gamma = ops.linear(style, P[f"{name}.adain.mlp_gamma.weight"],
                       P[f"{name}.adain.mlp_gamma.bias"])
    beta = ops.linear(style, P[f"{name}.adain.mlp_beta.weight"],
                      P[f"{name}.adain.mlp_beta.bias"])
    return ops.modulated_norm(x, gamma, beta)


def generator(ops: Ops, m: dict, P: Params, B: Params, x, style,
              train: bool = False, groups: int = 1):
    """x: NHWC images in [-1, 1]; style: (N, hidden_nc). Returns NHWC
    (out, prob). ``train``: BatchNorm on the batch statistics of each of
    ``groups`` contiguous groups, which moves the running statistics in
    ``B``."""
    x = x.permute(0, 3, 1, 2)

    def conv_bn(name, h, k, stride=1, pad=None):
        h = _conv(ops, P, f"{name}.conv.weight", h, stride,
                  same_pads(k) if pad is None else (pad,) * 4)
        return _batch_norm(P, B, f"{name}.norm", h, train, groups)

    h = leaky(conv_bn("stem", x, 7))
    for i in range(m["num_scales"]):
        h = leaky(conv_bn(f"enc_{i}", h, 4, 2, 1))
    for i in range(m["num_res"] // 2):
        y = leaky(conv_bn(f"enc_res_{i}.conv_0", h, 3))
        h = conv_bn(f"enc_res_{i}.conv_1", y, 3) + h
    p3 = same_pads(3)
    for i in range(m["num_res"] // 2):
        n = f"dec_res_{i}"
        y = _conv(ops, P, f"{n}.conv_0.weight",
                  torch.relu(_adain(ops, P, f"{n}.norm_0", h, style)), pads=p3)
        y = _conv(ops, P, f"{n}.conv_1.weight",
                  torch.relu(_adain(ops, P, f"{n}.norm_1", y, style)), pads=p3)
        h = y + h
    for i in range(m["num_scales"]):
        h = upsample2(h)
        h = _conv(ops, P, f"dec_{i}.conv.weight",
                  torch.relu(_adain(ops, P, f"dec_{i}.norm", h, style)),
                  pads=p3)
    h = torch.nan_to_num(h)
    fg = torch.tanh(_conv(ops, P, "foreground_head.conv.weight", h, pads=p3))
    prob = torch.sigmoid(_conv(ops, P, "distribution_head.conv.weight", h,
                               pads=p3))
    out = x * (1.0 - prob) + fg * prob
    return out.permute(0, 2, 3, 1), prob.permute(0, 2, 3, 1)


def extractor(ops: Ops, m: dict, P: Params, x):
    """NHWC images -> (N, hidden_nc) style codes."""
    h = leaky(_conv(ops, P, "stem.conv.weight", x.permute(0, 3, 1, 2), 2,
                    (3, 3, 3, 3)))
    p3 = same_pads(3)
    for i in range(_pow2_blocks(m["image_size"])):
        n = f"res_{i}"
        y = leaky(instance_norm(_conv(ops, P, f"{n}.conv_0.conv.weight", h,
                                      pads=p3)))
        y = torch.nn.functional.avg_pool2d(y, 2, 2)
        y = instance_norm(_conv(ops, P, f"{n}.conv_1.conv.weight", y, pads=p3))
        s = instance_norm(_conv(ops, P, f"{n}.conv_s.conv.weight", h))
        h = y + torch.nn.functional.avg_pool2d(s, 2, 2)
    h = _conv(ops, P, "head.conv.weight", h)
    return h.reshape(h.shape[0], m["hidden_nc"])


def discriminator(ops: Ops, m: dict, P: Params, x):
    """NHWC images -> (src logits (N, h, w, 1), cls logits (N, label_nc))."""
    h = leaky(_conv(ops, P, "stem.conv.weight", x.permute(0, 3, 1, 2), 2,
                    (1, 1, 1, 1)))
    for i in range(m["num_layers"]):
        h = leaky(_conv(ops, P, f"enc_{i}.conv.weight", h, 2, (1, 1, 1, 1)))
    cls = _conv(ops, P, "cls_clf.conv.weight", h)
    src = _conv(ops, P, "src_clf.conv.weight", h, pads=same_pads(3))
    return src.permute(0, 2, 3, 1), cls.reshape(x.shape[0], m["label_nc"])


def normal_labels(like: torch.Tensor) -> torch.Tensor:
    nm = torch.zeros_like(like)
    nm[:, 0] = 1.0
    return nm


def cat(*ts: Optional[torch.Tensor]) -> torch.Tensor:
    return torch.cat(ts, dim=0)
