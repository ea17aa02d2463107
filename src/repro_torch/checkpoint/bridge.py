"""Carry the JAX package's weights into the port's modules, and back.

The source is the JAX parameter pytree as numpy arrays: from
``jax.device_get(init_model(...))`` or from a ``save_pytree`` ``.npz`` read
with ``checkpoint.io.load_pytree``.  For a dense model it is

  {"embed": {"table"}, "final_norm": {"scale"}, ["lm_head": {"table"}],
   "stack": [{"norm1": {"scale"}, "mixer": {"w_q", "w_k", "w_v", "w_o"},
              "norm2": {"scale"}, "ffn": {"w_gate", "w_up", "w_down"}}]}

where every leaf under "stack" carries a leading layer axis.  The port's
own ``init_model`` draws from the same distributions with a
``torch.Generator`` but not the same values; only this bridge makes the
two packages compute the same function.

A quantized pytree (the JAX package's ``ModelBundle.quantize()``) holds
each projection as ``{"q8": int8, "scale": f32}``, both with the leading
layer axis; it fills a model of the same config with ``quant="int8"``,
whose projections are ``QuantWeight``s, value for value.

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

_LAYER_KEYS = {"norm1": ("scale",), "mixer": ("w_q", "w_k", "w_v", "w_o"),
               "norm2": ("scale",), "ffn": ("w_gate", "w_up", "w_down")}


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


def _layer_leaf(dst, stacked, i: int, n_layers: int, what: str) -> None:
    """Copy layer ``i`` of a stacked leaf (an array, or a quantized
    ``{"q8", "scale"}`` dict) into ``dst`` (a parameter or a
    ``QuantWeight``)."""
    quant = isinstance(stacked, Mapping) and "q8" in stacked
    if quant != isinstance(dst, QuantWeight):
        raise ValueError(f"{what}: an {'int8' if quant else 'fp32'} leaf "
                         f"for an {'fp32' if quant else 'int8'} weight")
    pairs = (((dst.q8, stacked["q8"], ".q8"),
              (dst.scale, stacked["scale"], ".scale")) if quant
             else ((dst, stacked, ""),))
    for tensor, arr, suffix in pairs:
        arr = np.asarray(arr)
        if arr.shape[0] != n_layers:
            raise ValueError(f"stack has {arr.shape[0]} layers, config "
                             f"{n_layers}")
        _copy(tensor, arr[i], what + suffix)


@torch.no_grad()
def load_jax_params(model: Transformer, params: Mapping) -> Transformer:
    """Fill ``model`` in place from a JAX dense-model parameter pytree
    (fp32, or quantized for a ``quant="int8"`` model)."""
    cfg = model.cfg
    extra = set(params) - {"embed", "final_norm", "lm_head", "stack"}
    if extra:
        raise ValueError(f"not a dense-model pytree: extra keys {extra}")
    if ("lm_head" in params) == cfg.tie_embeddings:
        raise ValueError("lm_head presence does not match tie_embeddings")
    _copy(model.embed.table, params["embed"]["table"], "embed.table")
    _copy(model.final_norm.scale, params["final_norm"]["scale"],
          "final_norm.scale")
    if model.lm_head is not None:
        _copy(model.lm_head.table, params["lm_head"]["table"],
              "lm_head.table")
    (unit,) = params["stack"]   # one sub-layer kind per unit: attention
    for i, layer in enumerate(model.layers):
        for part, names in _LAYER_KEYS.items():
            mod = getattr(layer, part)
            for name in names:
                _layer_leaf(getattr(mod, name), unit[part][name], i,
                            cfg.num_layers, f"layers[{i}].{part}.{name}")
    return model


def from_jax_params(cfg: ModelConfig, params: Mapping, *,
                    device: DeviceLike = None) -> Transformer:
    """A port model on ``device`` holding the JAX package's weights (give
    ``cfg.quant="int8"`` for a quantized pytree)."""
    return load_jax_params(Transformer(cfg, resolve_device(device)), params)


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


@torch.no_grad()
def to_jax_params(model: Transformer) -> dict:
    """The JAX dense-model parameter pytree of an fp32 ``model`` as numpy
    arrays: ``stack`` a one-element list whose leaves carry a leading
    layer axis, no ``lm_head`` when the embeddings are tied.
    ``load_jax_params`` of the result gives the same model back, value for
    value."""
    if model.cfg.quant:
        raise ValueError("to_jax_params takes an fp32 model (the trainer's); "
                         f"{model.cfg.name} is {model.cfg.quant}")
    out = {"embed": {"table": _numpy(model.embed.table)},
           "final_norm": {"scale": _numpy(model.final_norm.scale)}}
    if model.lm_head is not None:
        out["lm_head"] = {"table": _numpy(model.lm_head.table)}
    unit = {part: {name: np.stack([_numpy(getattr(getattr(layer, part), name))
                                   for layer in model.layers])
                   for name in names}
            for part, names in _LAYER_KEYS.items()}
    out["stack"] = [unit]
    return out
