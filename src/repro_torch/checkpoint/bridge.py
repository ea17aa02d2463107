"""Carry the JAX package's weights into the port's modules.

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
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import Transformer

_LAYER_KEYS = {"norm1": ("scale",), "mixer": ("w_q", "w_k", "w_v", "w_o"),
               "norm2": ("scale",), "ffn": ("w_gate", "w_up", "w_down")}


def _copy(dst: torch.Tensor, src, what: str) -> None:
    arr = np.asarray(src)
    if tuple(arr.shape) != tuple(dst.shape):
        raise ValueError(f"{what}: shape {arr.shape} != {tuple(dst.shape)}")
    dst.copy_(torch.from_numpy(np.array(arr, np.float32)))


@torch.no_grad()
def load_jax_params(model: Transformer, params: Mapping) -> Transformer:
    """Fill ``model`` in place from a JAX dense-model parameter pytree."""
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
                stacked = np.asarray(unit[part][name])
                if stacked.shape[0] != cfg.num_layers:
                    raise ValueError(f"stack has {stacked.shape[0]} layers, "
                                     f"config {cfg.num_layers}")
                _copy(getattr(mod, name), stacked[i],
                      f"layers[{i}].{part}.{name}")
    return model


def from_jax_params(cfg: ModelConfig, params: Mapping, *,
                    device: DeviceLike = None) -> Transformer:
    """A port model on ``device`` holding the JAX package's weights."""
    return load_jax_params(Transformer(cfg, resolve_device(device)), params)
