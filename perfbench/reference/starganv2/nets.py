"""StarGAN v2's networks with AdaIN (clovaai/stargan-v2, ``core/model.py``)
written out as functions of a dict of tensors keyed by the program's
parameter names: the generator, the mapping network, the style encoder and
the multi-domain discriminator. NCHW inside, NHWC at the edges, as the
program.

Widths follow ``core/model.py``: the first convolution is ``2**14 //
img_size`` wide, each down block doubles it up to ``max_conv_dim``; the
generator has ``log2(img_size) - 4`` down and up blocks and 2 + 2
bottleneck blocks; the mapping network has 4 shared layers of 512 and, a
domain, 3 layers of 512 and one to ``style_dim``; the style encoder and the
discriminator have ``log2(img_size) - 2`` down blocks, a 4x4 convolution and
a head a domain (the discriminator's heads are one 1x1 convolution).

Departures from the source, none of which changes the mathematics: every
activation is float32 (the program rounds to bfloat16 at each conv and
dense); the AdaIN norm is ``Ops.modulated_norm``, ``instance_norm(x) * (1 +
gamma) + beta`` with two-pass statistics; ``w_hpf`` is 0, so neither the
FAN's masks nor the high-pass filter is written out.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from perfbench.reference.common import Ops, instance_norm, leaky, upsample2

Params = Dict[str, torch.Tensor]
MAPPING_HIDDEN = 512  # core/model.py:446
SQRT2 = math.sqrt(2.0)


def _dim_in(img_size: int) -> int:
    return 2 ** 14 // img_size


def _dims(m: dict, fewer: int) -> List[Tuple[int, int]]:
    """(in, out) of ``log2(img_size) - fewer`` down blocks, each doubling
    the width up to ``max_conv_dim``."""
    dims, d = [], _dim_in(m["img_size"])
    for _ in range(int(math.log2(m["img_size"])) - fewer):
        dims.append((d, min(d * 2, m["max_conv_dim"])))
        d = dims[-1][1]
    return dims


def encoder_dims(m: dict) -> List[Tuple[int, int]]:
    """(in, out) of the generator's down blocks."""
    return _dims(m, 4)


def _down_dims(m: dict) -> List[Tuple[int, int]]:
    """(in, out) of the style encoder's and the discriminator's blocks."""
    return _dims(m, 2)


def _conv(s: dict, name: str, cout: int, cin: int, k: int, bias=True):
    s[f"{name}.weight"] = (cout, cin, k, k)
    if bias:
        s[f"{name}.bias"] = (cout,)


def _dense(s: dict, name: str, cout: int, cin: int):
    s[f"{name}.weight"] = (cout, cin)
    s[f"{name}.bias"] = (cout,)


def _resblk_shapes(s: dict, name: str, cin: int, cout: int, normalize: bool):
    if cin != cout:
        _conv(s, f"{name}.conv1x1", cout, cin, 1, bias=False)
    if normalize:
        for n in ("norm1", "norm2"):
            s[f"{name}.{n}.scale"] = (cin,)
            s[f"{name}.{n}.bias"] = (cin,)
    _conv(s, f"{name}.conv1", cin, cin, 3)
    _conv(s, f"{name}.conv2", cout, cin, 3)


def _styled_shapes(s: dict, name: str, cin: int, cout: int, style_dim: int):
    _dense(s, f"{name}.norm1.fc", 2 * cin, style_dim)
    _conv(s, f"{name}.conv1", cout, cin, 3)
    _dense(s, f"{name}.norm2.fc", 2 * cout, style_dim)
    _conv(s, f"{name}.conv2", cout, cout, 3)
    if cin != cout:
        _conv(s, f"{name}.conv1x1", cout, cin, 1, bias=False)


def generator_shapes(m: dict) -> Dict[str, tuple]:
    s: Dict[str, tuple] = {}
    dim_in, dims = _dim_in(m["img_size"]), encoder_dims(m)
    d = dims[-1][1]
    _conv(s, "from_rgb", dim_in, 3, 3)
    for i, (ci, co) in enumerate(dims):
        _resblk_shapes(s, f"encode_{i}", ci, co, True)
    for i in range(2):
        _resblk_shapes(s, f"encode_bottleneck_{i}", d, d, True)
    for i in range(2):
        _styled_shapes(s, f"decode_bottleneck_{i}", d, d, m["style_dim"])
    for i, (ci, co) in enumerate(reversed(dims)):
        _styled_shapes(s, f"decode_{i}", co, ci, m["style_dim"])
    s["to_rgb_norm.scale"] = (dim_in,)
    s["to_rgb_norm.bias"] = (dim_in,)
    _conv(s, "to_rgb", 3, dim_in, 1)
    return s


def mapping_shapes(m: dict) -> Dict[str, tuple]:
    s: Dict[str, tuple] = {}
    for i in range(4):
        _dense(s, f"shared_{i}", MAPPING_HIDDEN,
               m["latent_dim"] if i == 0 else MAPPING_HIDDEN)
    for d in range(m["num_domains"]):
        for j in range(3):
            _dense(s, f"unshared_{d}_{j}", MAPPING_HIDDEN, MAPPING_HIDDEN)
        _dense(s, f"unshared_{d}_out", m["style_dim"], MAPPING_HIDDEN)
    return s


def _down_shapes(m: dict) -> Dict[str, tuple]:
    s: Dict[str, tuple] = {}
    dims = _down_dims(m)
    _conv(s, "from_rgb", _dim_in(m["img_size"]), 3, 3)
    for i, (ci, co) in enumerate(dims):
        _resblk_shapes(s, f"block_{i}", ci, co, False)
    d = dims[-1][1]
    _conv(s, "conv4", d, d, 4)
    return s


def style_encoder_shapes(m: dict) -> Dict[str, tuple]:
    s = _down_shapes(m)
    d = _down_dims(m)[-1][1]
    for i in range(m["num_domains"]):
        _dense(s, f"unshared_{i}", m["style_dim"], d)
    return s


def discriminator_shapes(m: dict) -> Dict[str, tuple]:
    s = _down_shapes(m)
    _conv(s, "head", m["num_domains"], _down_dims(m)[-1][1], 1)
    return s


# ---------------------------------------------------------------- forwards

def _conv2d(ops: Ops, p: Params, name: str, x, padding: int = 0):
    return ops.conv2d(x, p[f"{name}.weight"], p.get(f"{name}.bias"),
                      padding=padding)


def _affine_norm(p: Params, name: str, x):
    """InstanceNorm2d(affine=True): not the modulated norm's kernel."""
    return (instance_norm(x) * p[f"{name}.scale"][:, None, None]
            + p[f"{name}.bias"][:, None, None])


def resblk(ops: Ops, p: Params, name: str, x, normalize: bool):
    """ResBlk (model.py:26-67), always downsampling here: the shortcut
    (1x1 where the width changes, then a 2x2 average pool) plus the
    pre-activation residual, over sqrt(2)."""
    s = x
    if f"{name}.conv1x1.weight" in p:
        s = _conv2d(ops, p, f"{name}.conv1x1", s)
    h = _affine_norm(p, f"{name}.norm1", x) if normalize else x
    h = _conv2d(ops, p, f"{name}.conv1", leaky(h), 1)
    h = F.avg_pool2d(h, 2)
    if normalize:
        h = _affine_norm(p, f"{name}.norm2", h)
    h = _conv2d(ops, p, f"{name}.conv2", leaky(h), 1)
    return (F.avg_pool2d(s, 2) + h) / SQRT2


def _bottleneck(ops: Ops, p: Params, name: str, x):
    """ResBlk(normalize=True) that keeps the size."""
    h = leaky(_affine_norm(p, f"{name}.norm1", x))
    h = _conv2d(ops, p, f"{name}.conv1", h, 1)
    h = leaky(_affine_norm(p, f"{name}.norm2", h))
    return (x + _conv2d(ops, p, f"{name}.conv2", h, 1)) / SQRT2


def _adain(ops: Ops, p: Params, name: str, x, s):
    """AdaIN (model.py:70-80): fc(s) split into gamma and beta."""
    gamma, beta = ops.linear(s, p[f"{name}.fc.weight"],
                             p[f"{name}.fc.bias"]).chunk(2, dim=-1)
    return ops.modulated_norm(x, gamma, beta)


def styled_resblk(ops: Ops, p: Params, name: str, x, s, upsample: bool):
    """AdainResBlk (model.py:83-123) with w_hpf 0: the residual plus the
    (upsampled, 1x1 where the width changes) shortcut, over sqrt(2)."""
    h = leaky(_adain(ops, p, f"{name}.norm1", x, s))
    if upsample:
        h = upsample2(h)
    h = _conv2d(ops, p, f"{name}.conv1", h, 1)
    h = _conv2d(ops, p, f"{name}.conv2",
                leaky(_adain(ops, p, f"{name}.norm2", h, s)), 1)
    sc = upsample2(x) if upsample else x
    if f"{name}.conv1x1.weight" in p:
        sc = _conv2d(ops, p, f"{name}.conv1x1", sc)
    return (h + sc) / SQRT2


def generator(ops: Ops, m: dict, p: Params, x, s):
    """Generator (model.py:321-393) of NHWC images x with styles s (N,
    style_dim); NHWC out."""
    h = _conv2d(ops, p, "from_rgb", x.permute(0, 3, 1, 2), 1)
    n = len(encoder_dims(m))
    for i in range(n):
        h = resblk(ops, p, f"encode_{i}", h, True)
    for i in range(2):
        h = _bottleneck(ops, p, f"encode_bottleneck_{i}", h)
    for i in range(2):
        h = styled_resblk(ops, p, f"decode_bottleneck_{i}", h, s, False)
    for i in range(n):
        h = styled_resblk(ops, p, f"decode_{i}", h, s, True)
    h = _conv2d(ops, p, "to_rgb", leaky(_affine_norm(p, "to_rgb_norm", h)))
    return h.permute(0, 2, 3, 1)


def _pick(out, y):
    """(N, domains, ...) -> each row's domain."""
    return out[torch.arange(y.shape[0], device=y.device), y]


def mapping(ops: Ops, m: dict, p: Params, z, y):
    """MappingNetwork (model.py:442-471): latent z, domains y -> styles."""
    h = z
    for i in range(4):
        h = torch.relu(ops.linear(h, p[f"shared_{i}.weight"], p[f"shared_{i}.bias"]))
    outs = []
    for d in range(m["num_domains"]):
        u = h
        for j in range(3):
            u = torch.relu(ops.linear(u, p[f"unshared_{d}_{j}.weight"],
                                      p[f"unshared_{d}_{j}.bias"]))
        outs.append(ops.linear(u, p[f"unshared_{d}_out.weight"],
                               p[f"unshared_{d}_out.bias"]))
    return _pick(torch.stack(outs, dim=1), y)


def _down(ops: Ops, m: dict, p: Params, x):
    """The trunk the style encoder and the discriminator share."""
    h = _conv2d(ops, p, "from_rgb", x.permute(0, 3, 1, 2), 1)
    for i in range(len(_down_dims(m))):
        h = resblk(ops, p, f"block_{i}", h, False)
    return leaky(_conv2d(ops, p, "conv4", leaky(h)))


def style_encoder(ops: Ops, m: dict, p: Params, x, y):
    """StyleEncoder (model.py:474-505): NHWC images x, domains y ->
    styles."""
    h = _down(ops, m, p, x).flatten(1)
    outs = [ops.linear(h, p[f"unshared_{i}.weight"], p[f"unshared_{i}.bias"])
            for i in range(m["num_domains"])]
    return _pick(torch.stack(outs, dim=1), y)


def discriminator(ops: Ops, m: dict, p: Params, x, y):
    """Discriminator (model.py:508-532): each row's logit for its domain."""
    return _pick(_conv2d(ops, p, "head", _down(ops, m, p, x)).flatten(1), y)
