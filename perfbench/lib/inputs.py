"""The one generator of inputs and weights, made on the device from the
seed in a few large calls.

Inputs: a configuration file lists, for each kind of traffic (``train``,
``serve``), the arrays one step or request takes and how each is drawn; a
traffic file says how many distinct ones to make (``pool``) and the sizes
that the configuration's shapes name (``batch``). ``pool(...)`` draws each
array for the whole pool in one call; step or request ``i`` takes entry
``i % pool``.

Weights: ``weights(...)`` draws every parameter of the named networks in
one call, scaled by the configuration's ``init`` rule.
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch

# distinct streams of one --seed
WEIGHTS, TRAFFIC, SAMPLE = 1, 2, 3


def stream(seed: int, which: int) -> int:
    """A 63-bit seed for stream ``which`` of ``seed`` (any whole number)."""
    return (int(seed) * 1_000_003 + which * 7_919) % (2 ** 63)


def generator(seed: int, which: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(stream(seed, which))


def _shape(spec: list, sizes: Dict[str, int]) -> List[int]:
    return [sizes[d] if isinstance(d, str) else int(d) for d in spec]


def pool(schema: Dict[str, dict], sizes: Dict[str, int], n: int, seed: int,
         device) -> List[Dict[str, torch.Tensor]]:
    """``n`` inputs of ``schema``: {name: {"draw": uniform | one_hot,
    "shape": [...], "low"/"high" (uniform), "classes" (one_hot)}}; shape
    entries that are strings are looked up in ``sizes``. On the ``meta``
    device the arrays have shapes and no values."""
    if str(device) == "meta":
        return [{name: torch.empty(
            _shape(s["shape"], sizes) + ([s["classes"]] if s["draw"] == "one_hot"
                                         else []),
            device="meta") for name, s in schema.items()} for _ in range(n)]
    gen = generator(seed, TRAFFIC, device)
    drawn = {}
    for name in sorted(schema):
        s = schema[name]
        shape = [n, *_shape(s["shape"], sizes)]
        kind = s["draw"]
        if kind == "uniform":
            t = torch.rand(shape, generator=gen, device=device)
            t = t * (s["high"] - s["low"]) + s["low"]
        elif kind == "one_hot":
            t = torch.randint(0, s["classes"], shape, generator=gen,
                              device=device)
            t = torch.nn.functional.one_hot(t, s["classes"]).float()
        else:
            raise ValueError(f"unknown draw {kind!r} for {name}")
        drawn[name] = t
    return [{k: v[i] for k, v in drawn.items()} for i in range(n)]


def weights(shapes: Dict[str, Dict[str, tuple]], init: dict, seed: int,
            device) -> Dict[str, Dict[str, torch.Tensor]]:
    """Float32 parameters of the networks in ``shapes`` ({net: {name:
    shape}}), drawn in one call: a weight of two or more dimensions is
    normal with ``init["std"]``; a bias is 0; a one-dimensional weight or
    scale (a norm's) is 1."""
    if str(device) == "meta":
        return {net: {name: torch.empty(shape, device="meta")
                      for name, shape in s.items()} for net, s in shapes.items()}
    leaves = [(net, name, tuple(shape)) for net in sorted(shapes)
              for name, shape in shapes[net].items()]
    total = sum(math.prod(s) for _, _, s in leaves)
    flat = torch.randn(total, generator=generator(seed, WEIGHTS, device),
                       device=device)
    out: Dict[str, Dict[str, torch.Tensor]] = {net: {} for net in shapes}
    start = 0
    for net, name, shape in leaves:
        n = math.prod(shape)
        if name.endswith("bias"):
            t = torch.zeros(shape, device=device)
        elif len(shape) == 1:
            t = torch.ones(shape, device=device)
        else:
            t = flat[start:start + n].view(shape) * init["std"]
        out[net][name] = t
        start += n
    return out
