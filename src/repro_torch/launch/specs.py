"""The benchmark's input shapes and the meta-device stand-ins of one step's
weights, caches and inputs: the port of the JAX package's
``repro/launch/specs.py``.

Nothing here allocates: the reference's ``jax.ShapeDtypeStruct``s are
tensors on PyTorch's ``meta`` device, which carry a shape and a dtype and
no storage, so a whole model at published width (``param_specs``) or a
524,288-row cache costs nothing, and a step run on them
(``launch.dryrun``) propagates shapes only.  Dtypes are the reference's:
weights and caches in bf16, except the leaves it keeps in fp32 (MoE
routers, the SSD block's ``A_log``/``dt_bias``/``D``, RG-LRU's ``lambda``
and recurrent state ``h``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

import torch

from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig

PARAM_DTYPE = torch.bfloat16
CACHE_DTYPE = torch.bfloat16
META = torch.device("meta")
# leaves the reference keeps in fp32 whatever the model's dtype
FP32_PARAMS = ("router", "A_log", "dt_bias", "D", "lambda")


@dataclasses.dataclass(frozen=True)
class InputShape:
    """One named benchmark shape: sequence length, global batch and
    kind (train | prefill | decode)."""
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


def window_override(cfg: ModelConfig, shape: InputShape) -> int:
    """long_500k needs sub-quadratic attention: the SSM and hybrid
    families are sub-quadratic by nature; the full-attention families run
    every attention layer with a 4096-key window (-1: no override)."""
    if shape.name == "long_500k" and cfg.family in ("dense", "moe", "vlm",
                                                    "audio"):
        return 4096
    return -1


def param_specs(cfg: ModelConfig, dtype: torch.dtype = PARAM_DTYPE
                ) -> tf.Transformer:
    """The model of ``cfg`` on the meta device with its weights in
    ``dtype`` (the reference's fp32 leaves stay fp32)."""
    model = tf.Transformer(cfg, META)
    for name, p in model.named_parameters():
        if name.rpartition(".")[2] not in FP32_PARAMS:
            p.data = p.data.to(dtype)
    return model


def cache_specs(cfg: ModelConfig, batch: int, max_len: int,
                dtype: torch.dtype = CACHE_DTYPE) -> List[dict]:
    """The model cache of ``cfg`` (``transformer.init_cache``) on the meta
    device, its floating leaves in ``dtype`` (RG-LRU's ``h`` and an int8
    cache's scales stay fp32, as in the reference)."""
    return tf.cast_cache(tf.init_cache(cfg, batch, max_len, device=META),
                         dtype)


def _tensor(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def input_specs(cfg: ModelConfig, shape: InputShape) -> Dict[str, Any]:
    """One step's model inputs on the meta device, with the reference's
    keys, shapes and dtypes (token ids int32): train {"tokens", "labels"},
    prefill {"tokens"} (the step builds its own cache), decode {"token",
    "cache" (a ``seq_len`` cache), "cache_len"}; plus "prefix_embeds" for
    a VLM and "frames" (train, prefill) or "enc_out" (decode) for an
    encoder-decoder."""
    b, s = shape.global_batch, shape.seq_len
    modal: Dict[str, Any] = {}
    if cfg.family == "vlm":
        modal["prefix_embeds"] = _tensor((b, cfg.prefix_tokens, cfg.d_model),
                                         PARAM_DTYPE)
    if cfg.is_encdec:
        modal["frames"] = _tensor((b, cfg.encoder.max_source_positions,
                                   cfg.d_model), PARAM_DTYPE)
    if shape.kind == "train":
        return {"tokens": _tensor((b, s), torch.int32),
                "labels": _tensor((b, s), torch.int32), **modal}
    if shape.kind == "prefill":
        return {"tokens": _tensor((b, s), torch.int32), **modal}
    out = {"token": _tensor((b,), torch.int32),
           "cache": cache_specs(cfg, b, s),
           "cache_len": _tensor((), torch.int32)}
    if cfg.is_encdec:
        out["enc_out"] = modal["frames"]
    return out
