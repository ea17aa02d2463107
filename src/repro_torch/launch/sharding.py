"""The reference's sharding rules for its production meshes, over the
port's weights and caches: the port of the JAX package's
``repro/launch/sharding.py``.

The rules are name-based, as the reference's are: a leaf's spec follows
from its key path in the reference's parameter pytree (the last key, and
whether the path holds ``stack``, ``mixer`` or ``shared``) and its shape.
The port keeps one tensor per layer where the reference stacks a
repeated unit's layers along a leading axis, so ``param_leaves`` and
``cache_leaves`` first lay the port's tensors out as the reference's
leaves, through the weight bridge's layout (``checkpoint.bridge``: a port
weight's path in its layer is the JAX key path, its shape the JAX leaf's,
so no spec is transposed).  ZeRO-1's extra ``data`` shard then lands on
the same axis as in the reference, the stacked one included.

A spec is a tuple with one entry per leading dimension it names: a mesh
axis, a tuple of axes, or None (replicated); ``()`` replicates the whole
leaf.  "model" carries tensor and expert parallelism; ("pod", "data") the
batch or, for ``long_500k``, the cache's sequence.  Every rule falls back
to replication where the dimension does not divide.  Nothing is placed:
``shard_shape`` and ``device_bytes`` count what one device of the
reference's deployment would hold (``launch.mesh``).
"""
from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Tuple

import torch

from repro_torch.checkpoint.bridge import _layer_leaves, _layout
from repro_torch.launch.mesh import Mesh, batch_sharding_spec
from repro_torch.models.config import ModelConfig

Spec = Tuple
Leaf = Tuple[tuple, Tuple[int, ...], torch.dtype]   # (path, shape, dtype)


def _div(n: int, m: int) -> bool:
    return n % m == 0


def _attn_spec(name: str, cfg: ModelConfig, ms: int) -> Spec:
    """Attention projections: heads over 'model' where they divide, else
    head_dim; MLA's LoRA factors replicated."""
    heads_ok = _div(cfg.num_heads, ms)
    kv_ok = _div(cfg.num_kv_heads, ms)
    hd_ok = _div(cfg.resolved_head_dim, ms)
    if cfg.mla is not None:
        if name in ("w_q", "w_ukv"):
            return (None, "model", None) if heads_ok else ()
        if name == "w_o":
            return ("model", None, None) if heads_ok else ()
        return ()
    if name == "w_q":
        if heads_ok:
            return (None, "model", None)
        return (None, None, "model") if hd_ok else ()
    if name in ("w_k", "w_v"):
        if kv_ok:
            return (None, "model", None)
        return (None, None, "model") if hd_ok else ()
    if name == "w_o":
        if heads_ok:
            return ("model", None, None)
        return (None, "model", None) if hd_ok else ()
    if name == "b_q":
        return ("model", None) if heads_ok else (
            (None, "model") if hd_ok else ())
    if name in ("b_k", "b_v"):
        return ("model", None) if kv_ok else (
            (None, "model") if hd_ok else ())
    return ()


def _moe_spec(name: str, cfg: ModelConfig, ms: int, ds: int) -> Spec:
    """Expert weights, 2-D: experts over 'model', the expert width over
    'data' where it divides."""
    e, f = cfg.moe.num_experts, cfg.moe.d_ff_expert
    e_ok, f_ok = _div(e, ms), _div(f, ms)
    f_data = "data" if _div(f, ds) else None
    if name in ("w_gate", "w_up"):
        if e_ok:
            return ("model", None, f_data)
        return (None, None, "model") if f_ok else ()
    if name == "w_down":
        if e_ok:
            return ("model", f_data, None)
        return (None, "model", None) if f_ok else ()
    return ()


def _mlp_spec(name: str, ms: int, ff: int) -> Spec:
    if not _div(ff, ms):
        return ()
    if name in ("w_gate", "w_up"):
        return (None, "model")
    if name == "w_down":
        return ("model", None)
    return ()


def _rglru_spec(name: str, cfg: ModelConfig, ms: int) -> Spec:
    if not _div(cfg.rglru.lru_width or cfg.d_model, ms):
        return ()
    if name in ("in_x", "in_y", "conv_w", "w_a", "w_i"):
        return (None, "model")
    if name in ("conv_b", "lambda"):
        return ("model",)
    if name == "out":
        return ("model", None)
    return ()


def _keys(path) -> List[str]:
    return [k for k in path if isinstance(k, str)]


def param_pspec(path, shape: Sequence[int], cfg: ModelConfig,
                mesh: Mesh) -> Spec:
    """The spec of one weight at ``path`` (reference layout,
    ``param_leaves``) of ``shape``: tensor parallel over 'model',
    vocab-sharded tables, norms and scalars replicated."""
    ms = mesh.shape["model"]
    keys = _keys(path)
    name = keys[-1]
    stacked = "stack" in keys
    ndim = len(shape)
    if name == "table":
        spec = ("model", None) if _div(cfg.vocab_size, ms) else ()
    elif name in ("scale", "bias", "A_log", "dt_bias", "D", "dt"):
        spec = ()
    elif "mixer" in keys and cfg.family == "ssm":
        spec = ()
    elif "mixer" in keys and name in ("in_x", "in_y", "w_a", "w_i",
                                      "lambda", "conv_w", "conv_b", "out"):
        spec = _rglru_spec(name, cfg, ms)
    elif name in ("w_q", "w_k", "w_v", "w_o", "b_q", "b_k", "b_v", "w_dq",
                  "w_dkv", "w_kr", "w_ukv"):
        spec = _attn_spec(name, cfg, ms)
    elif name in ("w_gate", "w_up", "w_down"):
        base = ndim - (1 if stacked else 0)
        if base == 3 and cfg.moe is not None and "shared" not in keys:
            spec = _moe_spec(name, cfg, ms, mesh.shape["data"])
        else:
            ff = shape[-1] if name != "w_down" else shape[-2]
            spec = _mlp_spec(name, ms, ff)
    else:   # router, the SSD block's projections, anything else
        spec = ()
    if stacked and len(spec) == ndim - 1:
        return (None, *spec)
    if len(spec) not in (0, ndim):
        return ()
    return spec


def zero1_pspec(path, shape: Sequence[int], cfg: ModelConfig,
                mesh: Mesh) -> Spec:
    """Optimizer-state spec (ZeRO-1): the weight's, plus 'data' on the
    first still-replicated dimension that 'data' divides."""
    base = param_pspec(path, shape, cfg, mesh)
    spec = list(base) + [None] * (len(shape) - len(base))
    if any(ax == "data" or (isinstance(ax, tuple) and "data" in ax)
           for ax in spec):
        return tuple(spec)
    ds = mesh.shape["data"]
    for i, (ax, dim) in enumerate(zip(spec, shape)):
        if ax is None and dim % ds == 0 and dim >= ds:
            spec[i] = "data"
            break
    return tuple(spec)


def cache_pspec(path, shape: Sequence[int], cfg: ModelConfig, mesh: Mesh,
                *, batch: int, shard_seq: bool = False) -> Spec:
    """Cache or recurrent-state spec: the batch over ('pod', 'data') where
    it divides; ``shard_seq`` (long_500k, batch 1) puts the K/V sequence
    over 'data' instead; K/V heads (or head_dim) over 'model'; MLA's
    compressed rows shard their sequence over every axis the batch does
    not use."""
    ms = mesh.shape["model"]
    keys = _keys(path)
    name = keys[-1]
    b = batch_sharding_spec(mesh, batch) or None
    if name in ("k", "v"):
        seq = "data" if (shard_seq and b is None) else None
        head = "model" if _div(cfg.num_kv_heads, ms) else None
        hd = "model" if head is None and _div(cfg.resolved_head_dim,
                                              ms) else None
        spec = (b, seq, head, hd)
    elif name in ("c_kv", "k_rope"):
        used = set(b) if b else set()
        rest = tuple(a for a in mesh.axis_names if a not in used)
        spec = (b, rest or None, None)
    elif name == "conv":
        spec = (b, None, None)
    elif name == "ssd":
        spec = (b, None, None, None)
    elif name == "h":
        spec = (b, None)
    else:
        spec = ()
    return (None, *spec) if "stack" in keys else spec


def batch_pspec(mesh: Mesh, batch: int, ndim: int = 2) -> Spec:
    """An activation's or token array's spec: batch over ('pod', 'data')
    where it divides, else replicated."""
    b = batch_sharding_spec(mesh, batch)
    return (b, *([None] * (ndim - 1))) if b else ()


def shard_shape(shape: Sequence[int], spec: Spec, mesh: Mesh
                ) -> Tuple[int, ...]:
    """The shape one device holds of a ``shape`` tensor under ``spec``
    (``NamedSharding.shard_shape``); raises where an axis does not
    divide its dimension."""
    out = list(shape)
    for i, ax in enumerate(spec):
        if ax is None:
            continue
        n = 1
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            n *= mesh.shape[a]
        if out[i] % n:
            raise ValueError(f"dimension {i} of {tuple(shape)} does not "
                             f"divide over {ax} ({n})")
        out[i] //= n
    return tuple(out)


def device_bytes(leaves: Iterable[Leaf], spec_fn, mesh: Mesh,
                 dtype: Optional[torch.dtype] = None) -> int:
    """Bytes one device holds of ``leaves`` under ``spec_fn(path,
    shape)``, each leaf in its own dtype or ``dtype``."""
    total = 0
    for path, shape, dt in leaves:
        n = 1
        for d in shard_shape(shape, spec_fn(path, shape), mesh):
            n *= d
        total += n * (dtype or dt).itemsize
    return total


# --------------------------------------------------------------------------
# the port's tensors as the reference's leaves
# --------------------------------------------------------------------------
def _stack_layers(cfg: ModelConfig, per_layer: list, top: str,
                  unstacked: bool = False):
    """(path, shape, dtype) of per-layer items laid out as the reference
    lays its layers out: ``prefix[i][0]``, the repeated unit's ``stack[k]``
    with a leading reps axis (or, ``unstacked``, the serving layout's
    ``units[r][k]``), ``tail[j]``.  ``per_layer[i]`` is a list of (key
    path in the layer, shape, dtype)."""
    n_prefix, u, reps, n_tail = _layout(cfg)
    out = []
    for i in range(n_prefix):
        out += [(("prefix", i, 0, *p), s, d) for p, s, d in per_layer[i]]
    for k in range(u):
        for r in range(reps if unstacked else 1):
            items = per_layer[n_prefix + r * u + k]
            if unstacked:
                out += [(("units", r, k, *p), s, d) for p, s, d in items]
            else:
                out += [(("stack", k, *p), (reps, *s), d)
                        for p, s, d in items]
    for j in range(n_tail):
        out += [((top, j, *p), s, d)
                for p, s, d in per_layer[n_prefix + reps * u + j]]
    return out


def _shapes(module) -> list:
    return [(path, tuple(w.shape), w.dtype)
            for path, w in _layer_leaves(module)]


def param_leaves(model) -> List[Leaf]:
    """The model's weights as the reference's parameter leaves: (key path,
    shape, dtype), a repeated unit's layers stacked on a leading axis, an
    encoder's layers too (``checkpoint.bridge.to_jax_params``'s layout,
    from shapes alone: a meta model serves)."""
    cfg = model.cfg
    out = [(("embed", "table"), tuple(model.embed.table.shape),
            model.embed.table.dtype),
           (("final_norm", "scale"), tuple(model.final_norm.scale.shape),
            model.final_norm.scale.dtype)]
    if model.lm_head is not None:
        out.append((("lm_head", "table"), tuple(model.lm_head.table.shape),
                    model.lm_head.table.dtype))
    out += _stack_layers(cfg, [_shapes(layer) for layer in model.layers],
                         "tail")
    if model.encoder is not None:
        enc = model.encoder
        n = len(enc.layers)
        out += [(("encoder", "layers", *p), (n, *s), d)
                for p, s, d in _shapes(enc.layers[0])]
        out.append((("encoder", "final_norm", "scale"),
                    tuple(enc.final_norm.scale.shape),
                    enc.final_norm.scale.dtype))
    return out


def cache_leaves(cfg: ModelConfig, cache: list, *,
                 stacked: bool = True) -> List[Leaf]:
    """A per-layer cache (``transformer.init_cache``, or
    ``specs.cache_specs``) as the reference's cache leaves: stacked
    (prefill's layout) or one per layer (``stacked=False``, the serving
    layout of the reference's decode step)."""
    per_layer = [[((name,), tuple(buf.shape), buf.dtype)
                  for name, buf in layer.items()] for layer in cache]
    return _stack_layers(cfg, per_layer, "tail", unstacked=not stacked)
