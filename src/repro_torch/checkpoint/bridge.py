"""Carry the JAX package's weights into the port's modules, and back.

The source is the JAX parameter pytree as numpy arrays: from
``jax.device_get(init_model(...))`` or from a ``save_pytree`` ``.npz`` read
with ``checkpoint.io.load_pytree``.  It is

  {"embed": {"table"}, "final_norm": {"scale"}, ["lm_head": {"table"}],
   ["prefix": [[sub-layer], ...]],   (a MoE config's first_dense layers)
   "stack": [sub-layer, ...],        (one per kind of the repeated unit,
                                      every leaf with a leading reps axis)
   ["tail": [sub-layer, ...]],       (the layers past the last whole unit)
   ["encoder": {"layers": {...}, "final_norm": {"scale"}}]}
                                     (an encoder-decoder's encoder tower)

where a sub-layer is {"norm1": {"scale"}, "mixer": {...}, ["cross_norm":
{"scale"}, "cross": {...}], "norm2": {"scale"}, "ffn": {...}}: the
cross-attention of an encoder-decoder holds plain GQA weights; the
encoder's ``layers`` are {"norm1", "attn", "norm2", "mlp"} with every
leaf stacked over the encoder's layers (no ``prefix`` part), which are
``model.encoder.layers[j]`` here.  The mixer holds w_q, w_k, w_v, w_o (and b_q,
b_k, b_v with QKV bias) or MLA's w_dq, w_q, w_dkv, w_kr, w_ukv, w_o, or
the SSD block's in_proj, conv_w, conv_b, dt_bias, A_log, D, norm,
out_proj, or the RG-LRU block's in_x, in_y, conv_w, conv_b, w_a, w_i,
lambda, out; the ffn (none for an ssm sub-layer) an MLP's w_gate (not for
GELU), w_up, w_down, or MoE's router, 3-D w_gate/w_up/w_down and "shared"
(an MLP).  With ``u`` sub-layer kinds in a unit (1, or the length of an
RG-LRU pattern such as "rra") and ``reps`` units, layer ``i`` of the port
is ``prefix[i]``, then ``stack[k]`` at reps index ``r`` is layer
``n_prefix + r * u + k``, then ``tail[j]`` is layer ``n_prefix + reps * u
+ j``; a port weight's path in its layer is the JAX key path.  The port's own
``init_model`` draws from the same distributions with a
``torch.Generator`` but not the same values; only this bridge makes the
two packages compute the same function.

A quantized pytree (the JAX package's ``ModelBundle.quantize()``) holds
each projection as ``{"q8": int8, "scale": f32}``; it fills a model of
the same config with ``quant="int8"``, whose projections are
``QuantWeight``s, value for value (QKV biases stay fp32).

``to_jax_params`` is the reverse: the same pytree, as numpy arrays, from
a port model (what the trainer saves as ``{"params": ...}``).
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import QuantWeight
from repro_torch.models.transformer import Transformer


def _copy(dst: torch.Tensor, src, what: str) -> None:
    arr = np.asarray(src)
    if tuple(arr.shape) != tuple(dst.shape):
        raise ValueError(f"{what}: shape {arr.shape} != {tuple(dst.shape)}")
    if dst.dtype == torch.int8:
        if arr.dtype != np.int8:
            raise ValueError(f"{what}: int8 values expected, got {arr.dtype}")
        dst.copy_(torch.from_numpy(np.array(arr)))
    else:
        dst.copy_(torch.from_numpy(np.array(arr, np.float32)))


def _is_quant(x) -> bool:
    return isinstance(x, Mapping) and "q8" in x


def _layer_leaves(module, prefix=()):
    """(path, weight) of every weight of a layer, by the JAX key path:
    parameters, and ``QuantWeight``s whole (a ``{"q8", "scale"}`` leaf)."""
    for name, p in module.named_parameters(recurse=False):
        yield prefix + (name,), p
    for name, child in module.named_children():
        if isinstance(child, QuantWeight):
            yield prefix + (name,), child
        else:
            yield from _layer_leaves(child, prefix + (name,))


def _jax_paths(tree, prefix=()):
    """Key paths of a JAX sub-layer's leaves (a quantized dict is one)."""
    if isinstance(tree, Mapping) and not _is_quant(tree):
        for k, v in tree.items():
            yield from _jax_paths(v, prefix + (k,))
    else:
        yield prefix


def _unit_len(cfg: ModelConfig) -> int:
    """Sub-layer kinds in the reference's repeated unit."""
    if cfg.family != "ssm" and cfg.rglru is not None:
        return len(cfg.rglru.pattern)
    return 1


def _layout(cfg: ModelConfig):
    """(n_prefix, unit length, reps, tail length): the reference's
    ``layout``."""
    n_prefix = cfg.moe.first_dense if cfg.moe is not None else 0
    u = _unit_len(cfg)
    body = cfg.num_layers - n_prefix
    return n_prefix, u, body // u, body % u


def _layer_sources(cfg: ModelConfig, params: Mapping) -> list:
    """Per port layer, its JAX sub-layer dict and its index on the stacked
    axis (None for an unstacked ``prefix`` or ``tail`` layer), in the
    reference's order: ``prefix[i]``, then unit ``r``'s ``stack[k]`` at
    index ``r``, then ``tail[j]``."""
    n_prefix, u, reps, n_tail = _layout(cfg)
    out = []
    for i in range(n_prefix):
        (sub,) = params["prefix"][i]
        out.append((sub, None))
    out += [(params["stack"][k], r) for r in range(reps) for k in range(u)]
    out += [(params["tail"][j], None) for j in range(n_tail)]
    return out


def _fill(dst, src, j, what: str) -> None:
    """Copy a JAX leaf (layer ``j`` of it when stacked) into ``dst``, a
    parameter or a ``QuantWeight``."""
    quant = _is_quant(src)
    if quant != isinstance(dst, QuantWeight):
        raise ValueError(f"{what}: an {'int8' if quant else 'fp32'} leaf "
                         f"for an {'fp32' if quant else 'int8'} weight")
    pairs = (((dst.q8, src["q8"], ".q8"), (dst.scale, src["scale"],
                                            ".scale")) if quant
             else ((dst, src, ""),))
    for tensor, arr, suffix in pairs:
        _copy(tensor, np.asarray(arr) if j is None else np.asarray(arr)[j],
              what + suffix)


@torch.no_grad()
def load_jax_params(model: Transformer, params: Mapping) -> Transformer:
    """Fill ``model`` in place from a JAX parameter pytree of its config
    (fp32, or quantized for a ``quant="int8"`` model)."""
    cfg = model.cfg
    extra = set(params) - {"embed", "final_norm", "lm_head", "prefix",
                           "stack", "tail", "encoder"}
    if extra:
        raise ValueError(f"not a decoder pytree of the port's families: "
                         f"extra keys {extra}")
    if ("encoder" in params) != (model.encoder is not None):
        raise ValueError("encoder presence does not match the config")
    if ("lm_head" in params) == cfg.tie_embeddings:
        raise ValueError("lm_head presence does not match tie_embeddings")
    _copy(model.embed.table, params["embed"]["table"], "embed.table")
    _copy(model.final_norm.scale, params["final_norm"]["scale"],
          "final_norm.scale")
    if model.lm_head is not None:
        _copy(model.lm_head.table, params["lm_head"]["table"],
              "lm_head.table")
    n_prefix, u, reps, n_tail = _layout(cfg)
    stack, tail = params.get("stack", []), params.get("tail", [])
    n = (np.asarray(next(iter(_leaf_arrays(stack[0])))).shape[0]
         if stack else 0)
    if (len(params.get("prefix", [])), len(stack), n, len(tail)) != (
            n_prefix, u if reps else 0, reps, n_tail):
        raise ValueError(
            f"prefix {len(params.get('prefix', []))}, stack of "
            f"{len(stack)} kinds x {n} units and tail {len(tail)} do not "
            f"lay out {cfg.num_layers} layers as the config does "
            f"({n_prefix} + {reps} x {u} + {n_tail})")
    for i, (layer, (sub, j)) in enumerate(zip(model.layers,
                                              _layer_sources(cfg, params))):
        ours = dict(_layer_leaves(layer))
        theirs = set(_jax_paths(sub))
        if set(ours) != theirs:
            raise ValueError(
                f"layers[{i}]: JAX leaves {sorted(theirs - set(ours))} have "
                f"no port weight, port weights {sorted(set(ours) - theirs)} "
                "no JAX leaf")
        for path, dst in ours.items():
            src = sub
            for key in path:
                src = src[key]
            _fill(dst, src, j, f"layers[{i}].{'.'.join(path)}")
    if model.encoder is not None:
        _load_encoder(model.encoder, params["encoder"])
    return model


def _load_encoder(encoder, params: Mapping) -> None:
    """Fill the encoder tower from the reference's stacked
    ``{"layers", "final_norm"}``."""
    _copy(encoder.final_norm.scale, params["final_norm"]["scale"],
          "encoder.final_norm.scale")
    theirs = set(_jax_paths(params["layers"]))
    n = np.asarray(next(iter(_leaf_arrays(params["layers"])))).shape[0]
    if n != len(encoder.layers):
        raise ValueError(f"encoder has {n} layers, config "
                         f"{len(encoder.layers)}")
    for j, layer in enumerate(encoder.layers):
        ours = dict(_layer_leaves(layer))
        if set(ours) != theirs:
            raise ValueError(
                f"encoder.layers[{j}]: JAX leaves "
                f"{sorted(theirs - set(ours))} have no port weight, port "
                f"weights {sorted(set(ours) - theirs)} no JAX leaf")
        for path, dst in ours.items():
            src = params["layers"]
            for key in path:
                src = src[key]
            _fill(dst, src, j, f"encoder.layers[{j}].{'.'.join(path)}")


def _leaf_arrays(tree):
    """The arrays of a pytree (a quantized dict gives its q8)."""
    if _is_quant(tree):
        yield tree["q8"]
    elif isinstance(tree, Mapping):
        for v in tree.values():
            yield from _leaf_arrays(v)
    else:
        yield tree


def from_jax_params(cfg: ModelConfig, params: Mapping, *,
                    device: DeviceLike = None) -> Transformer:
    """A port model on ``device`` holding the JAX package's weights (give
    ``cfg.quant="int8"`` for a quantized pytree)."""
    return load_jax_params(Transformer(cfg, resolve_device(device)), params)


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _nest(pairs) -> dict:
    """A nested dict from (key path, value) pairs."""
    out: dict = {}
    for path, value in pairs:
        d = out
        for key in path[:-1]:
            d = d.setdefault(key, {})
        d[path[-1]] = value
    return out


@torch.no_grad()
def to_jax_params(model: Transformer) -> dict:
    """The JAX parameter pytree of an fp32 ``model`` as numpy arrays:
    ``prefix`` (a MoE config's dense ``first_dense`` layers, one
    ``[sub-layer]`` list each), ``stack`` (one sub-layer per kind of the
    unit, its leaves carrying a leading reps axis), ``tail`` (the layers
    past the last whole unit) when there is one, ``encoder`` (its layers
    stacked the same way) for an encoder-decoder, no ``lm_head`` when the
    embeddings are tied.  ``load_jax_params`` of the result gives the same
    model back, value for value."""
    cfg = model.cfg
    if cfg.quant:
        raise ValueError("to_jax_params takes an fp32 model (the trainer's); "
                         f"{cfg.name} is {cfg.quant}")
    out = {"embed": {"table": _numpy(model.embed.table)},
           "final_norm": {"scale": _numpy(model.final_norm.scale)}}
    if model.lm_head is not None:
        out["lm_head"] = {"table": _numpy(model.lm_head.table)}
    n_prefix, u, reps, n_tail = _layout(cfg)
    layers = list(model.layers)

    def one(layer):
        return _nest((path, _numpy(w)) for path, w in _layer_leaves(layer))
    if n_prefix:
        out["prefix"] = [[one(layer)] for layer in layers[:n_prefix]]
    if reps:
        out["stack"] = [_stacked(layers[n_prefix + k:n_prefix + reps * u:u])
                        for k in range(u)]
    if n_tail:
        out["tail"] = [one(layer) for layer in layers[n_prefix + reps * u:]]
    if model.encoder is not None:
        out["encoder"] = {
            "layers": _stacked(model.encoder.layers),
            "final_norm": {"scale": _numpy(model.encoder.final_norm.scale)}}
    return out


def _stacked(layers) -> dict:
    """The layers' leaves, each stacked along a leading layer axis."""
    per = [dict(_layer_leaves(layer)) for layer in layers]
    return _nest((path, np.stack([_numpy(p[path]) for p in per]))
                 for path in per[0])
