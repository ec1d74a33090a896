"""Weights carried across from the JAX package, and the JAX init's
distribution for weights made from a seed.

The inverse of ``de_i2i_gan_tpu/train/torch_import.py``'s layout mapping:
flax trees arrive as nested dicts of numpy arrays (``{"stem": {"conv":
{"kernel": ...}}}``) and fill the port's modules, whose attribute paths
follow the flax module names (``stem.conv.weight`` <- ``stem/conv/kernel``):

    Conv2d     kernel HWIO -> weight OIHW,  bias -> bias; with spectral
               norm, spectral kernel_u -> weight_u, and kernel_v, which
               runs over (kh, kw, in), -> weight_v over (in, kh, kw)
    Dense      kernel (in, out) -> weight (out, in),  bias -> bias;
               spectral kernel_u/kernel_v -> weight_u/weight_v
    BatchNorm  params scale/bias -> weight/bias,
               batch_stats mean/var -> running_mean/running_var
    SEAN, SEANv2  sean_stats mean/std/sum/sumsq/count -> the buffers of
               the same names
    NoiseInjection  weight -> weight
    MaskToken  mask_token -> mask_token (NHWC in both)
    AffineInstanceNorm  params scale/bias -> scale/bias
    Embed      embedding (num, features) -> nn.Embedding weight, as is

A network's state arrives as the dict of its flax collections besides
``params`` (``state.G.state``: ``batch_stats``, ``spectral``,
``sean_stats``); an optimizer's as its optax state (Adam/AdamW ``mu``,
``nu`` and ``count`` -> torch's ``exp_avg``, ``exp_avg_sq`` and ``step``;
RMSprop ``nu``; the schedule's ``count`` -> ``Optimizer.count``). Loading
is strict: a key missing on either side, or a shape that differs, raises.
Whole train states load per trainer: DefectGAN's (``load_jax_train_state``),
MAE's, pix2pix's and WGAN's, StarGAN v2's solver.

``init_weights`` draws weights from a seed with the JAX init's
distribution, and ``reinit_module`` redraws them per ``--init_type``, as
the JAX package's ``nn/layers.py::reinit_params`` does.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from de_i2i_gan_torch.models.starganv2 import AffineInstanceNorm, SEANv2
from de_i2i_gan_torch.nn.blocks import BatchNorm, MaskToken, NoiseInjection
from de_i2i_gan_torch.nn.layers import Conv2d, Dense
from de_i2i_gan_torch.nn.normalization import SEAN

Tree = Mapping[str, Any]
_Target = Tuple[str, torch.Tensor, str, str, Callable[[np.ndarray], np.ndarray]]
COLLECTIONS = ("params", "batch_stats", "spectral", "sean_stats")


def _same(a: np.ndarray) -> np.ndarray:
    return a


def _flatten(tree: Optional[Tree], prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for k, v in (tree or {}).items():
        path = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(_flatten(v, path + "/"))
        else:
            out[path] = np.asarray(v)
    return out


def _targets(module: nn.Module) -> Iterator[_Target]:
    """(port key, port tensor, collection, flax path, flax -> port transform)
    for every parameter and buffer of ``module``."""
    for name, mod in module.named_modules():
        key = f"{name}." if name else ""
        path = key.replace(".", "/")
        if isinstance(mod, (Conv2d, Dense)):
            conv = isinstance(mod, Conv2d)
            to_port = ((lambda a: a.transpose(3, 2, 0, 1)) if conv
                       else (lambda a: a.T))
            yield key + "weight", mod.weight, "params", path + "kernel", to_port
            if mod.bias is not None:
                yield key + "bias", mod.bias, "params", path + "bias", _same
            if mod.use_spectral:
                # (bound now: the targets are listed before they are used)
                v_to_port = ((lambda a, s=(*mod.kernel_size, mod.weight.shape[1]):
                              a.reshape(s).transpose(2, 0, 1).reshape(-1))
                             if conv else _same)
                yield (key + "weight_u", mod.weight_u, "spectral",
                       path + "kernel_u", _same)
                yield (key + "weight_v", mod.weight_v, "spectral",
                       path + "kernel_v", v_to_port)
        elif isinstance(mod, BatchNorm):
            yield key + "weight", mod.weight, "params", path + "scale", _same
            yield key + "bias", mod.bias, "params", path + "bias", _same
            yield (key + "running_mean", mod.running_mean, "batch_stats",
                   path + "mean", _same)
            yield (key + "running_var", mod.running_var, "batch_stats",
                   path + "var", _same)
        elif isinstance(mod, (SEAN, SEANv2)):
            for name in ("mean", "std", "sum", "sumsq", "count"):
                yield (key + name, getattr(mod, name), "sean_stats",
                       path + name, _same)
        elif isinstance(mod, NoiseInjection):
            yield key + "weight", mod.weight, "params", path + "weight", _same
        elif isinstance(mod, AffineInstanceNorm):
            yield key + "scale", mod.scale, "params", path + "scale", _same
            yield key + "bias", mod.bias, "params", path + "bias", _same
        elif isinstance(mod, MaskToken) and hasattr(mod, "mask_token"):
            yield (key + "mask_token", mod.mask_token, "params",
                   path + "mask_token", _same)
        elif isinstance(mod, nn.Embedding):
            yield (key + "weight", mod.weight, "params", path + "embedding",
                   _same)


def _checked_targets(module: nn.Module):
    targets = list(_targets(module))
    unmapped = set(module.state_dict()) - {t[0] for t in targets}
    if unmapped:
        raise TypeError(f"no flax mapping for {sorted(unmapped)}")
    return targets


def load_jax_module(module: nn.Module, params: Tree,
                    state: Optional[Mapping[str, Tree]] = None) -> None:
    """Fill ``module`` from a flax ``params`` tree and its ``state``, the
    dict of its other collections (``batch_stats``, ``spectral``,
    ``sean_stats``), where the module holds such state."""
    state = state or {}
    unknown = sorted(set(state) - set(COLLECTIONS))
    if unknown:
        raise KeyError(f"unknown collections {unknown}")
    trees = {coll: _flatten(params if coll == "params" else state.get(coll))
             for coll in COLLECTIONS}
    targets = _checked_targets(module)
    for coll, flat in trees.items():
        want = {t[3] for t in targets if t[2] == coll}
        missing, extra = sorted(want - set(flat)), sorted(set(flat) - want)
        if missing or extra:
            raise KeyError(f"{coll}: missing {missing}, unexpected {extra}")
    with torch.no_grad():
        for key, tensor, coll, path, to_port in targets:
            arr = np.array(to_port(trees[coll][path]), np.float32)  # a writable copy
            if arr.shape != tuple(tensor.shape):
                raise ValueError(f"{path}: shape {arr.shape} does not fit "
                                 f"{key} {tuple(tensor.shape)}")
            tensor.copy_(torch.from_numpy(arr))


def load_jax_generator(steps, g_params: Tree, g_state: Mapping[str, Tree],
                       e_params: Optional[Tree],
                       ema_params: Optional[Tree] = None) -> None:
    """Fill a ``DefectGanSteps`` from the JAX train state's trees:
    ``state.G.params``, ``state.G.state`` (its collections),
    ``state.E.params`` and ``state.ema_G``."""
    if (steps.E is None) != (e_params is None):
        raise ValueError("e_params must be given exactly when the steps "
                         "hold a style extractor")
    if (steps.ema_G is None) != (ema_params is None):
        raise ValueError("ema_params must be given exactly when the steps "
                         "hold an EMA generator")
    load_jax_module(steps.G, g_params, g_state)
    if steps.E is not None:
        load_jax_module(steps.E, e_params)
    if steps.ema_G is not None:
        load_jax_module(steps.ema_G, ema_params, g_state)


def _optax_fields(opt_state) -> Iterator[Dict[str, Any]]:
    """The fields of each state of an optax chain: its named tuples, or the
    dicts that flax's state-dict form makes of them (keyed '0', '1', ...)."""
    parts = ([opt_state[k] for k in sorted(opt_state, key=int)]
             if isinstance(opt_state, Mapping) else opt_state)
    for part in parts:
        if hasattr(part, "_asdict"):
            yield part._asdict()
        elif isinstance(part, Mapping):
            yield dict(part)


def load_jax_opt_state(tx, module: nn.Module, opt_state) -> None:
    """Fill the port's ``Optimizer`` ``tx`` over ``module``'s parameters from
    the optax state of the same optimizer: the update count (the schedule's,
    or Adam's in a chain without one), and Adam/AdamW's ``mu``, ``nu`` and ``count`` or RMSprop's ``nu`` (trees of
    numpy arrays in flax's layout), so the next update is the one JAX would
    make."""
    moments: Dict[str, Tree] = {}
    adam_count = schedule_count = None
    for fields in _optax_fields(opt_state):
        if "mu" in fields:  # scale_by_adam
            moments = {"exp_avg": fields["mu"], "exp_avg_sq": fields["nu"]}
            adam_count = int(np.asarray(fields["count"]))
        elif "nu" in fields:  # scale_by_rms
            moments = {"nu": fields["nu"]}
        elif "count" in fields:  # scale_by_schedule
            schedule_count = int(np.asarray(fields["count"]))
    targets = [t for t in _checked_targets(module) if t[2] == "params"]
    held = set(tx.opt.state[targets[0][1]]) - {"step"} if targets else set()
    if set(moments) != held:
        raise ValueError(f"the optax state holds {sorted(moments)}, the "
                         f"port's optimizer {sorted(held)}")
    with torch.no_grad():
        for name, tree in moments.items():
            flat = _flatten(tree)
            want = {t[3] for t in targets}
            if set(flat) != want:
                raise KeyError(f"{name}: missing {sorted(want - set(flat))}, "
                               f"unexpected {sorted(set(flat) - want)}")
            for _, tensor, _, path, to_port in targets:
                arr = np.array(to_port(flat[path]), np.float32)
                tx.opt.state[tensor][name].copy_(torch.from_numpy(arr))
        if adam_count is not None:
            for _, tensor, _, _, _ in targets:
                tx.opt.state[tensor]["step"].fill_(adam_count)
    # a chain without a schedule (the StarGAN v2 solver's constant lr)
    # counts its updates in scale_by_adam alone
    count = schedule_count if schedule_count is not None else adam_count
    if count is not None:
        tx.count = count


def load_jax_train_state(steps, g_params: Tree, g_state: Mapping[str, Tree],
                         d_params: Tree, d_state: Mapping[str, Tree],
                         e_params: Optional[Tree], step: int = 0,
                         ema_params: Optional[Tree] = None,
                         g_opt_state=None, d_opt_state=None,
                         e_opt_state=None) -> None:
    """Fill a ``DefectGanSteps`` for training from the trees of a JAX
    ``GANTrainState``: ``state.G.params``, ``state.G.state``,
    ``state.D.params``, ``state.D.state``, ``state.E.params``,
    ``int(state.step)`` and ``state.ema_G``, given as numpy arrays (the
    states as dicts of collections), and, where given, the optimizer states
    ``state.G.opt_state``, ``state.D.opt_state`` and ``state.E.opt_state``
    (``load_jax_opt_state``). Builds D and the optimizers first
    (``init_training``); an optimizer whose state is not given starts
    fresh, as ``init_state`` makes it."""
    steps.init_training()
    load_jax_generator(steps, g_params, g_state, e_params, ema_params)
    load_jax_module(steps.D, d_params, d_state)
    for tx, module, opt_state in ((steps.tx_G, steps.G, g_opt_state),
                                  (steps.tx_D, steps.D, d_opt_state),
                                  (steps.tx_E, steps.E, e_opt_state)):
        if opt_state is not None:
            load_jax_opt_state(tx, module, opt_state)
    steps.step = int(step)


def load_jax_mae_state(steps, state) -> None:
    """Fill an ``MAESteps`` for training from a JAX ``GANTrainState`` of the
    JAX ``MAESteps`` (its leaves JAX or numpy arrays): G from
    ``state.G.params["net"]`` and ``state.G.state``, the mask token from
    ``state.G.params["token"]``, E and D from their params and state, the
    three optimizers' moments and counts from their optax states (G's over
    the ``{"net", "token"}`` tree: the token's moments go to the token's
    parameter), and ``step``. Builds D and the optimizers first. Strict: a
    key missing on either side raises."""
    steps.init_training()
    g_params = state.G.params
    load_jax_module(steps.G, g_params["net"], dict(state.G.state or {}))
    load_jax_module(steps.token, g_params["token"])
    if (steps.E is None) != (state.E is None):
        raise ValueError("E is in only one of the steps and the JAX state")
    if steps.E is not None:
        load_jax_module(steps.E, state.E.params, dict(state.E.state or {}))
    load_jax_module(steps.D, state.D.params, dict(state.D.state or {}))
    load_jax_opt_state(steps.tx_G, _Joined(steps.G, steps.token),
                       state.G.opt_state)
    load_jax_opt_state(steps.tx_D, steps.D, state.D.opt_state)
    if steps.E is not None:
        load_jax_opt_state(steps.tx_E, steps.E, state.E.opt_state)
    steps.step = int(np.asarray(state.step))


class _Joined(nn.Module):
    """G and its mask token as one module whose flax paths are the JAX MAE
    tree's: ``net/...`` and ``token/...`` (the order of ``tx_G``'s
    parameters)."""

    def __init__(self, net: nn.Module, token: nn.Module):
        super().__init__()
        self.net, self.token = net, token


def _init_module(module: nn.Module, gen: torch.Generator, std: float) -> None:
    with torch.no_grad():
        for key, tensor, coll, path, _ in _checked_targets(module):
            if path.endswith("kernel"):
                draw = torch.empty(tensor.shape).normal_(0.0, std, generator=gen)
                tensor.copy_(draw)
            elif coll == "spectral":  # u, v: unit vectors
                draw = torch.randn(tensor.shape, generator=gen)
                tensor.copy_(draw / (torch.linalg.vector_norm(draw) + 1e-12))
            elif path.endswith(("scale", "var")):
                tensor.fill_(1.0)
            else:  # biases, running means
                tensor.zero_()


def _flax_shape(mod: nn.Module, tensor: torch.Tensor) -> Tuple[int, ...]:
    """The flax layout's shape of a port weight: HWIO or (in, out)."""
    if isinstance(mod, Conv2d):
        o, i, kh, kw = tensor.shape
        return (kh, kw, i, o)
    return tuple(tensor.shape[::-1])


def _orthogonal(rows: int, cols: int, gain: float,
                gen: torch.Generator) -> torch.Tensor:
    """A (rows, cols) matrix with orthonormal columns (rows when there are
    fewer), times ``gain``: flax's ``orthogonal`` initializer's
    distribution (QR of a normal draw, signs fixed by R's diagonal)."""
    flip = rows < cols
    a = torch.randn((cols, rows) if flip else (rows, cols), generator=gen,
                    dtype=torch.float64)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))
    return (q.T if flip else q).float() * gain


def reinit_module(module: nn.Module, gen: torch.Generator, init_type: str,
                  gain: float) -> None:
    """The JAX package's ``reinit_params`` (the reference's
    ``BaseNetwork.init_weights``) over a port module: every conv and dense
    kernel redrawn per ``init_type`` [normal|xavier|kaiming|orthogonal],
    with fan-in and fan-out of the flax layout (fan-in = kh*kw*in); norm
    scales (BatchNorm's weight) drawn from N(1, gain); biases 0; the rest
    (running statistics, spectral u/v, noise weights, embeddings, tokens)
    left alone."""
    if init_type not in ("normal", "xavier", "kaiming", "orthogonal"):
        raise ValueError(f"unknown init_type {init_type}")
    mods = dict(module.named_modules())
    with torch.no_grad():
        for key, tensor, coll, path, to_port in _checked_targets(module):
            if coll != "params":
                continue
            name = path.rsplit("/", 1)[-1]
            if name == "kernel" and tensor.dim() >= 2:
                owner = key.rsplit(".", 1)[0] if "." in key else ""
                flax_shape = _flax_shape(mods[owner], tensor)
                fan_in = int(np.prod(flax_shape[:-1]))
                fan_out = int(flax_shape[-1])
                if init_type == "orthogonal":
                    flat = _orthogonal(fan_in, fan_out, gain, gen)
                    tensor.copy_(torch.from_numpy(np.ascontiguousarray(
                        to_port(flat.numpy().reshape(flax_shape)))))
                    continue
                std = {"normal": gain,
                       "xavier": gain * float(np.sqrt(2.0 / (fan_in + fan_out))),
                       "kaiming": float(np.sqrt(2.0 / fan_in))}[init_type]
                tensor.copy_(torch.empty(tensor.shape).normal_(0.0, std,
                                                               generator=gen))
            elif name == "scale" and tensor.dim() == 1:
                tensor.copy_(1.0 + gain * torch.randn(tensor.shape,
                                                      generator=gen))
            elif name == "bias":
                tensor.zero_()


def init_weights(steps, seed: int) -> None:
    """Weights from ``seed`` with the JAX init's distribution: normal(0.02)
    conv and dense kernels, zero biases, BatchNorm scale 1 / bias 0 and
    running statistics 0 / 1, normalized normal spectral u/v, zero SEAN
    statistics and zero noise weights. Not the JAX init's numbers. Drawn on the CPU,
    so a seed gives the same weights on every device. G, then E, then D
    (when training has built it) draw in that order, so G's and E's weights
    do not depend on whether D exists.

    A configuration with another ``init_type`` or ``init_variance`` then
    redraws the nets that ``steps.REINIT_NETS`` names (DefectGAN's G and
    D, as the JAX ``DefectGanSteps.init_state`` does) with
    ``reinit_module``; the EMA generator starts as a copy of G."""
    cfg = steps.cfg
    init_type = getattr(cfg, "init_type", "normal")
    gain = getattr(cfg, "init_variance", 0.02)
    gen = torch.Generator().manual_seed(seed)
    for net in (steps.G, steps.E, steps.D):
        if net is not None:
            _init_module(net, gen, 0.02)
    if init_type != "normal" or gain != 0.02:
        for name in getattr(steps, "REINIT_NETS", ()):
            net = getattr(steps, name)
            if net is not None:
                reinit_module(net, gen, init_type, gain)
    if steps.ema_G is not None:
        steps.ema_G.load_state_dict(steps.G.state_dict())


def load_jax_pix2pix_state(steps, state) -> None:
    """Fill a ``Pix2PixSteps`` from a JAX ``GANTrainState`` of the JAX
    ``Pix2PixSteps`` (its leaves JAX or numpy arrays): G from
    ``state.G.params`` and ``state.G.state``, ``ema_G`` from ``state.ema_G``
    with G's state, D from ``state.D.params``, both optimizers' moments and
    counts, and ``step``. Strict: a key missing on either side raises, and
    so does an EMA generator in only one of the two."""
    g_state = dict(state.G.state or {})
    load_jax_module(steps.G, state.G.params, g_state)
    load_jax_module(steps.D, state.D.params, dict(state.D.state or {}))
    if (steps.ema_G is None) != (state.ema_G is None):
        raise ValueError("ema_G is in only one of the steps and the JAX state")
    if steps.ema_G is not None:
        load_jax_module(steps.ema_G, state.ema_G, g_state)
    load_jax_opt_state(steps.tx_G, steps.G, state.G.opt_state)
    load_jax_opt_state(steps.tx_D, steps.D, state.D.opt_state)
    steps.step = int(np.asarray(state.step))


def load_jax_wgan_state(steps, state) -> None:
    """Fill a ``WGanSteps`` from a JAX ``GANTrainState`` of the JAX
    ``WGanSteps``: G and D from their params and BatchNorm statistics, both
    optimizers' moments (RMSprop's ``nu``) and counts, and ``step``.
    Strict: a key missing on either side raises."""
    load_jax_module(steps.G, state.G.params, dict(state.G.state or {}))
    load_jax_module(steps.D, state.D.params, dict(state.D.state or {}))
    load_jax_opt_state(steps.tx_G, steps.G, state.G.opt_state)
    load_jax_opt_state(steps.tx_D, steps.D, state.D.opt_state)
    steps.step = int(np.asarray(state.step))


def load_jax_starganv2(solver, state) -> None:
    """Fill a ``StarGANv2Solver`` from a JAX ``SolverState`` (its leaves JAX
    or numpy arrays): G from ``state.G.params`` and ``state.G.state`` (SEAN's
    ``sean_stats``), D, M and S from their params, ``ema_G`` from
    ``state.ema_G`` with ``state.ema_sean_stats``, ``ema_M`` and ``ema_S``
    from ``state.ema_M`` and ``state.ema_S``; each optimizer's moments and
    count from its ``opt_state`` (``load_jax_opt_state``), and ``step``. A
    solver in pretrain mode takes the JAX pretrain state
    (``init_pretrain_state``): G and ``ema_G`` from the ``net`` subtrees,
    the mask token from ``state.G.params["token"]``, G's optimizer over
    both. Builds D and the optimizers first (``init_training``). Strict: a
    net the solver holds and the state lacks, or the other way round,
    raises."""
    solver.init_training()
    g_state = dict(state.G.state or {})
    ema_state = dict(g_state)
    if state.ema_sean_stats is not None:
        ema_state["sean_stats"] = state.ema_sean_stats
    g_params, ema_params = state.G.params, state.ema_G
    if solver.token is not None:
        load_jax_module(solver.token, g_params["token"])
        g_params, ema_params = g_params["net"], ema_params["net"]
    trees = {"G": (g_params, g_state), "D": (state.D.params, None),
             "ema_G": (ema_params, ema_state),
             "M": (None if state.M is None else state.M.params, None),
             "S": (None if state.S is None else state.S.params, None),
             "ema_M": (state.ema_M, None), "ema_S": (state.ema_S, None)}
    for name, (params, net_state) in trees.items():
        net = getattr(solver, name)
        if (net is None) != (params is None):
            raise ValueError(f"{name} is in only one of the solver and the "
                             "JAX state")
        if net is not None:
            load_jax_module(net, params, net_state)
    for name in ("G", "D", "M", "S"):
        net_state = getattr(state, name)
        if net_state is not None:
            module = getattr(solver, name)
            if name == "G" and solver.token is not None:
                module = _Joined(module, solver.token)
            load_jax_opt_state(getattr(solver, f"tx_{name}"), module,
                               net_state.opt_state)
    solver.step = int(np.asarray(state.step))


def init_starganv2_weights(solver, seed: int) -> None:
    """StarGAN v2 weights from ``seed`` with the JAX init's distribution:
    he_init conv and dense kernels, normal(0, sqrt(2 / fan_in))
    (``nn/layers.py:29``); flax's Embed init, normal(0, sqrt(1 / features));
    zero biases, AffineInstanceNorm scale 1, zero SEANv2 statistics. Not the
    JAX init's numbers. Drawn on the CPU in the order G, M, S, then D when
    training has built it, so G's, M's and S's weights do not depend on
    whether D exists; each EMA net starts as a copy of its net."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name in ("G", "M", "S", "D"):
            net = getattr(solver, name)
            if net is None:
                continue
            for _, tensor, _, path, _ in _checked_targets(net):
                if path.endswith(("kernel", "embedding")):
                    fan_in = (tensor.shape[1] if path.endswith("embedding")
                              else tensor[0].numel())
                    gain = 1.0 if path.endswith("embedding") else 2.0
                    draw = torch.empty(tensor.shape).normal_(
                        0.0, (gain / fan_in) ** 0.5, generator=gen)
                    tensor.copy_(draw)
                elif path.endswith("scale"):
                    tensor.fill_(1.0)
                else:
                    tensor.zero_()
            ema = getattr(solver, f"ema_{name}", None)
            if ema is not None:
                ema.load_state_dict(net.state_dict())


def _unstack_blocks(params: Tree) -> Dict[str, Any]:
    """The scanned layout (``blocks_scan/block`` with a leading layer axis,
    JAX ``ViTEncoderScanned``) as the unrolled one (``block_<i>``)."""
    params = dict(params)
    scanned = params.pop("blocks_scan", None)
    if scanned is None:
        return params
    flat = _flatten(scanned["block"])
    layers = {a.shape[0] for a in flat.values()}
    if len(layers) != 1:
        raise ValueError(f"blocks_scan leaves disagree on the layer axis {layers}")
    for i in range(layers.pop()):
        block: Dict[str, Any] = {}
        for path, a in flat.items():
            *parents, leaf = path.split("/")
            node = block
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = a[i]
        params[f"block_{i}"] = block
    return params


def load_jax_vit(net, params: Tree) -> None:
    """Fill a ``models/vit.py::ViTEncoder`` from the JAX ViTEncoder's
    ``params`` tree, or ViTEncoderScanned's (``blocks_scan/block`` stacked on
    a layer axis, unstacked here): patch_embed HWIO -> OIHW; the attention's
    query/key/value kernels (hidden, heads, head_dim) and biases
    (heads, head_dim) -> (hidden, hidden) and (hidden,); out (heads,
    head_dim, hidden) -> (hidden, hidden); Dense kernels transposed;
    LayerNorm scale/bias -> weight/bias. Strict: every leaf fills one
    tensor and every tensor is filled."""
    flat = _flatten(_unstack_blocks(params))
    hidden = net.hidden
    maps = {"cls_token": ("cls_token", _same),
            "pos_embed": ("pos_embed", _same),
            "patch_embed.weight": ("patch_embed/kernel",
                                   lambda a: a.transpose(3, 2, 0, 1)),
            "patch_embed.bias": ("patch_embed/bias", _same)}
    for i in range(len(net.blocks)):
        src, dst = f"block_{i}/", f"blocks.{i}."
        for ln in ("ln1", "ln2"):
            maps[dst + ln + ".weight"] = (src + ln + "/scale", _same)
            maps[dst + ln + ".bias"] = (src + ln + "/bias", _same)
        for name in ("query", "key", "value", "out"):
            maps[dst + name + ".weight"] = (
                f"{src}attn/{name}/kernel",
                lambda a: a.reshape(hidden, hidden).T)
            maps[dst + name + ".bias"] = (f"{src}attn/{name}/bias",
                                          lambda a: a.reshape(hidden))
        for name in ("fc1", "fc2"):
            maps[dst + name + ".weight"] = (f"{src}{name}/kernel",
                                            lambda a: a.T)
            maps[dst + name + ".bias"] = (f"{src}{name}/bias", _same)
    own = net.state_dict()
    used = {path for path, _ in maps.values()}
    missing = sorted(used - set(flat))
    if set(maps) != set(own) or missing or set(flat) != used:
        raise KeyError(f"ViT: missing {missing}, unexpected "
                       f"{sorted(set(flat) - used)}, unmapped "
                       f"{sorted(set(own) ^ set(maps))}")
    with torch.no_grad():
        for key, (path, to_port) in maps.items():
            arr = np.array(to_port(flat[path]), np.float32)
            if arr.shape != tuple(own[key].shape):
                raise ValueError(f"{path}: shape {arr.shape} does not fit "
                                 f"{key} {tuple(own[key].shape)}")
            own[key].copy_(torch.from_numpy(arr))


def load_jax_fan(fan, variables: Mapping[str, Tree]) -> None:
    """Fill a ``models/wing.py::FAN`` from the JAX FAN's variables
    (``params`` and ``batch_stats``): its module paths are the flax tree's,
    so ``load_jax_module`` maps them. Strict, as it is."""
    load_jax_module(fan, variables["params"],
                    {"batch_stats": variables["batch_stats"]})
