"""Decoder of every family the JAX package's ``repro/models/transformer.py``
serves: dense (GQA, with or without QKV bias; SwiGLU, GeGLU or GELU MLP),
MoE, MLA, modality (VLM prefix, encoder-decoder) and recurrent (Mamba-2
SSD, RecurrentGemma's RG-LRU with local attention, and attention+SSD
hybrids).  The reference's layer layout (dense ``prefix`` layers for a MoE
config's ``first_dense``, then ``reps`` scanned units of the config's
sub-layer kinds, then a ``tail`` of the first kinds of a unit) is one
``DecoderLayer`` per layer here, of kind ``cfg.block_kind(i)``
(``layer_kinds``, the same order): ``attn`` and ``local`` layers attend
(a ``local`` one within ``cfg.rglru.window``, every other kind within
``cfg.sliding_window``: ``layer_windows``), ``ssm`` layers run the SSD
mixer with no feed-forward block, ``rglru`` layers the RG-LRU mixer and an
MLP; attention layers have an MLP or a MoE block
(``config.layer_is_moe``).

Every entry point below (``forward``, ``loss_fn``, ``prefill``,
``prefill_chunk``, ``decode_step``, ``tree_verify_step``) takes the
reference's ``window_override``: -1 (the default) keeps each layer's
window (``Transformer.windows``, the config's), a value >= 0 replaces
every attention layer's, ``local`` ones included, for that call (0: no
window; ``resolve_windows``).  ``launch.specs.window_override`` gives 4096
for the full-attention families at ``long_500k``.

Modality inputs, as in the reference: ``prefix_embeds`` [1|B, P, d] (a
VLM's vision prefix, from the stub frontend) are put before the prompt's
embeddings by ``forward``, ``prefill`` and ``loss_fn``, so the prompt's
rows follow the P prefix rows in the cache; ``enc_out`` [1|B, T, d] (an
encoder-decoder's encoder output, ``encdec.encode``) is attended by each
decoder layer's ``cross`` sub-layer (self-attention, then ``cross_norm``
+ cross-attention, then ``norm2`` + MLP), in every mode; without
``enc_out`` the sub-layer is skipped.  ``forward`` and ``loss_fn`` take
``enc_out`` (``encdec.encode(train=True)`` in training, so the encoder
takes gradients); the serving step functions take the layers' cross K/V as
``cross_kv``, computed once per encoder output by ``encode_cross_kv``
(``ModelBundle`` does so).

``Transformer`` holds the weights in ``nn.Module``s with the JAX layouts
(one ``DecoderLayer`` per layer in an ``nn.ModuleList``, where the JAX
package stacks the layers along a leading axis).  The model is run by
plain functions, as in the JAX package:

  * ``prefill``          - a whole prompt, filling the model KV cache;
  * ``prefill_chunk``    - one chunk of a prompt fed in chunks (the
                           pipeline ring's admission lane);
  * ``decode_step``      - one token per batch row against the cache;
  * ``tree_verify_step`` - one prediction-tree layer against the two-level
                           cache (model cache + tree cache, paper 3.4.2);
  * ``commit_tree_node`` - move one verified tree node's K/V into the
                           model cache (two-level cache sync, paper 3.4.3).

and, for training (under autograd, attending in plain PyTorch: the
kernels have no backward), ``forward`` (logits), ``loss_fn`` and its
streaming cross-entropy ``chunked_ce``; and, for the slot-stacked arenas
of SpecPipe-DB, the batched cache-row
helpers ``slice_cache_rows`` / ``update_cache_rows`` /
``where_cache_rows``, ``commit_tree_nodes`` (the per-row two-level sync)
and ``remap_tree_cache_rows`` (the per-row post-prune compaction).

Caches are lists with one ``{"k", "v"}`` dict of [B, L, KV, hd] per
attention layer (plus ``{"k_scale", "v_scale"}`` [B, L, KV] for an int8
model, whose K/V are int8; ``{"c_kv" [B, L, r], "k_rope" [B, L, rope]}``
for MLA), and one recurrent state dict per recurrent layer (``{"conv",
"ssd"}`` for SSD, ``{"conv", "h"}`` for RG-LRU, batch on axis 0 and no
length axis), all updated in place (see ``attention``).  A prefill starts
each recurrence from the zero state, never from the cache's contents, and
copies the final state into the cache, so a recycled arena slot is clean
and an arena's slot views see the new state.  Tree caches have ``None``
for recurrent layers: a tree layer has no single successor state, so
tree verification and chunked prefill refuse recurrent layers
(``check_tree_supported``); recurrent models speculate in chain mode
(``core.chain``).  Every attention leaf keeps its length on axis 1, so
the row helpers below take every attention leaf alike (the reference's
``CACHE_LEN_AXIS_FROM_END`` exists for its stacked layers); recurrent
leaves and ``None`` layers pass through them by slot (axis 0).  An
attention leaf may instead be block-paged (``models.paging.Paged``);
every function here takes dense and paged leaves alike, and the paged ones
reach the layers as they are (the port has no layer scan, so nothing
densifies them).  Row offsets
(cache lengths, tree write offsets) are host ints, so every dense write is
checked to fit before it is made; bounds that the kernels read are built
once per step on the model's device.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import paging
from repro_torch.models.encdec import Encoder
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (MLP, MLP_VARIANTS, RMSNorm, embed,
                                       embed_init_, mlp, param, unembed,
                                       wide)
from repro_torch.models.moe import MoE, moe_forward
from repro_torch.models.rglru import (RGLRU, init_rglru_state, rglru_decode,
                                      rglru_forward)
from repro_torch.models.ssm import (SSM, init_ssm_state, ssm_decode,
                                    ssm_forward)

RECURRENT_KINDS = ("ssm", "rglru")
CHAIN_MODE = ("recurrent architectures speculate in chain-mode "
              "(repro_torch.core.chain.ChainSpecEngine)")


def check_supported(cfg: ModelConfig) -> None:
    """Raise for a configuration outside what the port runs: decoders of
    attention layers (GQA with or without QKV bias, or MLA) and MLP or MoE
    feed-forward blocks, with a vision prefix (``vlm``) or an encoder and
    cross-attention (``audio``), and the recurrent families (``ssm``:
    Mamba-2; ``hybrid``: RG-LRU and/or SSD sub-layers beside local
    attention); int8 for dense attention only."""
    bad = [name for name, on in (
        (f"family={cfg.family}", cfg.family not in (
            "dense", "moe", "vlm", "audio", "ssm", "hybrid")),
        ("ssm family without an ssm config",
         cfg.family == "ssm" and cfg.ssm is None),
        ("hybrid family without an rglru pattern",
         cfg.family == "hybrid" and cfg.rglru is None),
        ("an ssm sub-layer without an ssm config",
         cfg.rglru is not None and "s" in cfg.rglru.pattern
         and cfg.ssm is None),
        (f"mlp_variant={cfg.mlp_variant}",
         cfg.mlp_variant not in MLP_VARIANTS)) if on]
    if bad:
        raise NotImplementedError(
            f"{cfg.name}: the port runs dense, MoE, MLA, VLM, "
            f"encoder-decoder and recurrent models; not {', '.join(bad)}")
    if cfg.quant not in ("", "int8"):
        raise NotImplementedError(f"{cfg.name}: quant={cfg.quant!r}")
    if cfg.quant == "int8" and (cfg.moe is not None or cfg.mla is not None
                                or is_recurrent(cfg)):
        raise NotImplementedError(
            f"{cfg.name}: int8 serving supports dense attention only")


def layer_kinds(cfg: ModelConfig) -> List[str]:
    """Each layer's sub-layer kind in order: 'attn', 'local', 'ssm' or
    'rglru' (the reference's prefix, units and tail, flattened)."""
    return [cfg.block_kind(i) for i in range(cfg.num_layers)]


def layer_windows(cfg: ModelConfig) -> List[int]:
    """Each layer's attention window (0: none): ``cfg.rglru.window`` for a
    ``local`` layer, ``cfg.sliding_window`` for every other kind (the
    reference's ``_window``)."""
    return [cfg.rglru.window if kind == "local" else cfg.sliding_window
            for kind in layer_kinds(cfg)]


def resolve_windows(cfg: ModelConfig,
                    window_override: int = -1) -> List[int]:
    """Each layer's window for one call: ``window_override`` (0: none) for
    every attention layer, ``local`` ones included, when it is >= 0, else
    the config's (``layer_windows``), as the reference's ``_window`` reads
    ``Ctx.window_override``.  A recurrent layer has no attention and
    ignores it.  The model entry points and the ring's stage functions
    (``launch.pipeline.make_stage_fns``) both take their windows here."""
    windows = layer_windows(cfg)
    if window_override < 0:
        return windows
    return [int(window_override)] * len(windows)


def is_recurrent(cfg: ModelConfig) -> bool:
    """Whether any layer of ``cfg`` is recurrent (SSD or RG-LRU)."""
    return any(k in RECURRENT_KINDS for k in layer_kinds(cfg))


def check_tree_supported(cfg: ModelConfig, what: str = "tree-verify") -> None:
    """Raise for a recurrent configuration: a tree layer (or a prompt
    chunk re-entering the middle of a sequence) has no single recurrent
    successor state, so ``what`` through an ssm or rglru sub-layer is
    undefined, as in the reference."""
    kinds = sorted({k for k in layer_kinds(cfg) if k in RECURRENT_KINDS})
    if kinds:
        raise NotImplementedError(
            f"{cfg.name}: {what} through an {'/'.join(kinds)} sub-layer is "
            f"undefined; {CHAIN_MODE}")


class DecoderLayer(nn.Module):
    """Pre-norm mixer of ``kind`` + feed-forward block.  The mixer is
    attention (GQA, or MLA) for ``attn``/``local``, the SSD block for
    ``ssm``, the RG-LRU block for ``rglru``; the feed-forward block is an
    MLP of the config's variant, or MoE when ``moe``, and an ``ssm`` layer
    has none (no ``norm2``/``ffn``, as in the reference).  An
    encoder-decoder's layer also has a pre-norm cross-attention
    (``cross_norm``, ``cross``: plain GQA weights) between the two."""

    def __init__(self, cfg: ModelConfig, device, moe: bool = False,
                 kind: str = "attn"):
        super().__init__()
        self.cfg, self.kind = cfg, kind
        self.norm1 = RMSNorm(cfg.d_model, cfg.norm_eps, device)
        if kind == "ssm":
            self.mixer = SSM(cfg, device)
        elif kind == "rglru":
            self.mixer = RGLRU(cfg, device)
        elif kind in ("attn", "local"):
            self.mixer = (attn.MLAttention(cfg, device)
                          if cfg.mla is not None
                          else attn.Attention(cfg, device))
        else:
            raise ValueError(f"unknown layer kind {kind!r}")
        self.cross = None
        if cfg.is_encdec and kind in ("attn", "local"):
            self.cross_norm = RMSNorm(cfg.d_model, cfg.norm_eps, device)
            self.cross = attn.Attention(cfg, device)
        self.ffn = None
        if kind != "ssm" and (cfg.d_ff > 0 or cfg.moe is not None):
            self.norm2 = RMSNorm(cfg.d_model, cfg.norm_eps, device)
            self.ffn = (MoE(cfg, device) if moe else
                        MLP(cfg.d_model, cfg.d_ff, device,
                            quant=cfg.quant == "int8",
                            variant=cfg.mlp_variant))

    def reset_parameters(self, gen: torch.Generator) -> None:
        """Draw the layer's weights from ``gen``."""
        self.norm1.reset_parameters()
        self.mixer.reset_parameters(gen)
        if self.cross is not None:
            self.cross_norm.reset_parameters()
            self.cross.reset_parameters(gen)
        if self.ffn is not None:
            self.norm2.reset_parameters()
            self.ffn.reset_parameters(gen)


class Embedding(nn.Module):
    """Token table [V, d] (also the tied LM head)."""

    def __init__(self, vocab: int, d_model: int, device):
        super().__init__()
        self.table = param((vocab, d_model), device)


class Transformer(nn.Module):
    """Embedding, decoder layers, final norm and LM head (tied to the
    embedding when ``cfg.tie_embeddings``), and the ``encoder`` tower of an
    encoder-decoder (None otherwise).  Weights are uninitialised
    until ``reset_parameters`` or the weight bridge fills them.  With
    ``cfg.quant == "int8"`` the seven projections of each layer are int8
    ``QuantWeight``s; embeddings, norms and the LM head stay fp32."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.embed = Embedding(cfg.vocab_size, cfg.d_model, device)
        self.final_norm = RMSNorm(cfg.d_model, cfg.norm_eps, device)
        self.lm_head = (None if cfg.tie_embeddings
                        else Embedding(cfg.vocab_size, cfg.d_model, device))
        # the reference's layout (``prefix`` dense layers below a MoE
        # ``stack``, units of sub-layer kinds, a ``tail``) is one
        # DecoderLayer per layer here
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, device, cfg.layer_is_moe(i), kind)
            for i, kind in enumerate(layer_kinds(cfg)))
        self.windows = layer_windows(cfg)
        self.encoder = Encoder(cfg, device) if cfg.is_encdec else None

    @property
    def device(self) -> torch.device:
        """The device the weights live on."""
        return self.embed.table.device

    def reset_parameters(self, gen: torch.Generator) -> None:
        """Draw every weight from ``gen`` (the JAX package's distributions,
        not its values)."""
        if self.cfg.quant:
            raise ValueError("int8 weights are not drawn: draw an fp32 model "
                             "and quantize it (ModelBundle.quantize)")
        embed_init_(self.embed.table, gen)
        self.final_norm.reset_parameters()
        if self.lm_head is not None:
            embed_init_(self.lm_head.table, gen)
        for layer in self.layers:
            layer.reset_parameters(gen)
        if self.encoder is not None:
            self.encoder.reset_parameters(gen)


def init_model(cfg: ModelConfig, *, seed: int = 0,
               device: DeviceLike = None) -> Transformer:
    """A model with weights drawn on ``device`` (CUDA unless the caller asks
    for the CPU) from a generator seeded with ``seed``."""
    dev = resolve_device(device)
    model = Transformer(cfg, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    with torch.no_grad():
        model.reset_parameters(gen)
    return model


# --------------------------------------------------------------------------
# caches
# --------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device: DeviceLike = None) -> List[dict]:
    """Model cache: per attention layer one zeroed {"k", "v"} [batch,
    max_len, KV, hd] (int8, with fp32 per-row scales, for an int8 model),
    per recurrent layer its zeroed state ({"conv", "ssd"} or {"conv",
    "h"}, batch rows first)."""
    dev = resolve_device(device)
    out = []
    for kind in layer_kinds(cfg):
        if kind == "ssm":
            out.append(init_ssm_state(cfg, batch, dev))
        elif kind == "rglru":
            out.append(init_rglru_state(cfg, batch, dev))
        else:
            out.append(attn.init_kv_cache(cfg, batch, max_len, dev))
    return out


def cast_cache(cache: List[dict], dtype: torch.dtype) -> List[dict]:
    """The cache with its floating leaves in ``dtype`` (the reference's
    ``init_cache(dtype=)``), except those it keeps in fp32 whatever the
    dtype: RG-LRU's state ``h`` and an int8 cache's scales."""
    return [{name: (buf.to(dtype) if buf.is_floating_point()
                    and name != "h" and not name.endswith("scale")
                    else buf)
             for name, buf in layer.items()} for layer in cache]


def init_tree_caches(cfg: ModelConfig, batch: int, capacity: int, *,
                     device: DeviceLike = None) -> List[Optional[dict]]:
    """Tree (level-2) KV caches: ``capacity`` rows per attention layer,
    None for a recurrent layer (it has no tree state)."""
    dev = resolve_device(device)
    return [None if kind in RECURRENT_KINDS else
            attn.init_kv_cache(cfg, batch, capacity, dev)
            for kind in layer_kinds(cfg)]


# --------------------------------------------------------------------------
# forward passes
# --------------------------------------------------------------------------
def host_rows(x, b: int) -> List[int]:
    """Per-batch-row host ints from an int, a sequence or an array of one
    entry or ``b`` entries."""
    vals = [int(v) for v in np.asarray(
        x.cpu() if isinstance(x, torch.Tensor) else x).reshape(-1)]
    if len(vals) == 1:
        return vals * b
    if len(vals) != b:
        raise ValueError(f"expected 1 or {b} row values, got {len(vals)}")
    return vals


def _tokens(model: Transformer, tokens):
    return torch.as_tensor(tokens, device=model.device).long()


def _embed_inputs(model: Transformer, tokens, prefix_embeds=None):
    """Token embeddings [B,S,d], after the ``prefix_embeds`` [1|B,P,d]
    rows when given ([B,P+S,d])."""
    x = embed(model.embed.table, tokens)
    if prefix_embeds is None:
        return x
    pre = torch.as_tensor(prefix_embeds, device=x.device).to(x.dtype)
    return torch.cat([pre.expand(x.shape[0], -1, -1), x], dim=1)


def encode_cross_kv(model: Transformer, enc_out) -> list:
    """Per decoder layer, the cross-attention (k, v) [1|B,T,KV,hd] of the
    encoder output ``enc_out`` [1|B,T,d] (``attention.encode_cross_kv``),
    to be computed once per encoder output and passed to the serving step
    functions as ``cross_kv``; ``enc_out`` is taken in the weights'
    dtype."""
    enc = torch.as_tensor(enc_out, device=model.device).to(
        model.embed.table.dtype)
    return [attn.encode_cross_kv(layer.cross, model.cfg, enc)
            for layer in model.layers]


def _cross(model: Transformer, cross_kv, *, train: bool = False):
    """The layers' cross-attention ``cross(i, p, h)`` over ``cross_kv``, or
    None when it is not given or the model has no cross sub-layer (as the
    reference skips it).  ``train`` attends in plain PyTorch under
    autograd, else through the flash kernel."""
    if not model.cfg.is_encdec or cross_kv is None:
        return None

    def cross(i, p, h):
        return attn.cross_attn_forward(p, model.cfg, h, cross_kv[i],
                                       train=train)
    return cross


def _block(i: int, layer: DecoderLayer, x, attend, aux=None, cross=None,
           recur=None):
    """Residual block ``i``; ``attend(i, mixer, h)`` is its attention,
    ``recur(i, layer, h)`` its recurrent mixer (an ssm or rglru layer) and
    ``cross(i, p, h)``, when given, its cross-attention.  A MoE block
    appends its router term to ``aux`` when a list is given."""
    h = layer.norm1(x)
    if layer.kind in RECURRENT_KINDS:
        x = x + recur(i, layer, h)
    else:
        x = x + attend(i, layer.mixer, h)
    if cross is not None and layer.cross is not None:
        x = x + cross(i, layer.cross, layer.cross_norm(x))
    if layer.ffn is None:
        return x
    h = layer.norm2(x)
    if isinstance(layer.ffn, MoE):
        y, a = moe_forward(layer.ffn, layer.cfg, h)
        if aux is not None:
            aux.append(a)
        return x + y
    return x + mlp(layer.ffn, h)


def _run_layers(model: Transformer, x, attend, *, remat: bool = False,
                aux=None, cross=None, recur=None):
    """The residual blocks in order; with ``remat`` each block keeps only
    its input for backward and recomputes the rest there
    (``torch.utils.checkpoint``, the JAX package's ``jax.checkpoint``).
    MoE blocks append their router terms to ``aux`` (a list) when given;
    ``cross`` is the blocks' cross-attention (``_cross``), ``recur`` the
    recurrent layers' mixer for this mode (``_recur_*``)."""
    for i, layer in enumerate(model.layers):
        if remat:
            x = checkpoint(_block, i, layer, x, attend, aux, cross, recur,
                           use_reentrant=False)
        else:
            x = _block(i, layer, x, attend, aux, cross, recur)
    return x


def _mix_full(layer: DecoderLayer, h):
    """(y, final state) of a recurrent mixer over whole sequences
    ``h`` [B,S,d], from the zero state."""
    if layer.kind == "ssm":
        return ssm_forward(layer.mixer, layer.cfg, h)
    return rglru_forward(layer.mixer, layer.cfg, h)


def _recur_train(i, layer, h):
    """Whole-sequence recurrent mixer with no cache (training forward)."""
    return _mix_full(layer, h)[0]


def _recur_prefill(cache):
    """The prefill's recurrent mixer: from the zero state (never the
    cache's old contents, which a recycled slot still holds), then the
    final state copied into ``cache[i]`` in place."""
    def recur(i, layer, h):
        y, state = _mix_full(layer, h)
        for name, buf in cache[i].items():
            buf.copy_(state[name])
        return y
    return recur


def _recur_decode(cache):
    """The decode step's recurrent mixer: one token against ``cache[i]``,
    the new state copied back in place."""
    def recur(i, layer, h):
        fn = ssm_decode if layer.kind == "ssm" else rglru_decode
        y, state = fn(layer.mixer, layer.cfg, h, cache[i])
        for name, buf in cache[i].items():
            buf.copy_(state[name])
        return y
    return recur


def _head(model: Transformer) -> torch.Tensor:
    """The LM head's table [V, d] (the embedding's when tied)."""
    return (model.embed if model.lm_head is None else model.lm_head).table


def _logits(model: Transformer, x):
    return unembed(_head(model), model.final_norm(x))


def _hidden(model: Transformer, tokens, *, prefix_embeds=None,
            enc_out=None, remat: bool = False, window_override: int = -1):
    """Training forward up to the final norm: (hidden states [B,P+S,d],
    the summed MoE router term: 0 without MoE layers) under autograd,
    attention in plain PyTorch (``attn.attn_train``)."""
    cfg = model.cfg
    windows = resolve_windows(model.cfg, window_override)
    x = _embed_inputs(model, _tokens(model, tokens), prefix_embeds)
    b, s = x.shape[:2]
    positions = torch.arange(s, device=model.device).expand(b, s)

    def attend(i, mixer, h):
        return attn.attn_train(mixer, cfg, h, positions,
                               window=windows[i])

    aux = []
    x = _run_layers(model, x, attend, remat=remat, aux=aux,
                    cross=_cross(model, None if enc_out is None else
                                 encode_cross_kv(model, enc_out),
                                 train=True), recur=_recur_train)
    total = torch.zeros((), dtype=wide(x).dtype, device=x.device)
    for a in aux:
        total = total + a
    return model.final_norm(x), total


def forward(model: Transformer, tokens, *, prefix_embeds=None,
            enc_out=None, remat: bool = False, with_aux: bool = False,
            window_override: int = -1):
    """Training forward: logits [B,P+S,V] of every position, the
    ``prefix_embeds`` rows first when given, the decoder cross-attending
    ``enc_out`` when given; with ``with_aux``, (logits, the summed MoE
    router term), as the reference's ``forward`` returns (0 without MoE
    layers).  ``window_override`` >= 0 replaces every attention layer's
    window (``resolve_windows``), here and in every entry point below."""
    hidden, aux = _hidden(model, tokens, prefix_embeds=prefix_embeds,
                          enc_out=enc_out, remat=remat,
                          window_override=window_override)
    logits = unembed(_head(model), hidden)
    return (logits, aux) if with_aux else logits


def _ce_sum(table, hc, yc):
    """Summed next-token NLL of one chunk; labels < 0 count 0."""
    logp = torch.log_softmax(wide(hc @ table.T), dim=-1)
    nll = -torch.gather(logp, -1, yc.clamp_min(0)[..., None])[..., 0]
    return torch.where(yc >= 0, nll, 0.0).sum()


def chunked_ce(table, hidden, labels, *, chunk: int = 256):
    """Streaming cross-entropy that never holds [B,S,V] logits: the
    sequence is cut into chunks of ``chunk`` positions (the tail padded
    with label -1), each chunk's logits recomputed in backward
    (``torch.utils.checkpoint``), so the peak is one [B, chunk, V] fp32
    block.  The summed NLL of the valid labels over ``B * S`` (not over the
    count of valid labels), as in the JAX package."""
    b, s, _ = hidden.shape
    chunk = min(chunk, s)
    pad = (-s) % chunk
    if pad:
        hidden = torch.nn.functional.pad(hidden, (0, 0, 0, pad))
        labels = torch.nn.functional.pad(labels, (0, pad), value=-1)
    total = torch.zeros((), dtype=wide(hidden).dtype, device=hidden.device)
    for c in range(0, s + pad, chunk):
        total = total + checkpoint(_ce_sum, table, hidden[:, c:c + chunk],
                                   labels[:, c:c + chunk],
                                   use_reentrant=False)
    return total / (b * s)


def loss_fn(model: Transformer, tokens, labels, *, prefix_embeds=None,
            enc_out=None, remat: bool = False, ce_chunk: int = 256,
            window_override: int = -1):
    """Mean next-token cross-entropy of ``labels`` [B,S] (-1: ignored)
    given ``tokens`` [B,S] (the prefix rows' hidden states dropped), plus
    ``cfg.moe.router_aux_weight`` times the summed router term for a MoE
    model, as in the reference; under autograd."""
    hidden, aux = _hidden(model, tokens, prefix_embeds=prefix_embeds,
                          enc_out=enc_out, remat=remat,
                          window_override=window_override)
    if prefix_embeds is not None:
        hidden = hidden[:, prefix_embeds.shape[1]:]
    ce = chunked_ce(_head(model), hidden, _tokens(model, labels),
                    chunk=ce_chunk)
    if model.cfg.moe is not None:
        ce = ce + model.cfg.moe.router_aux_weight * aux
    return ce


@torch.no_grad()
def prefill(model: Transformer, tokens, cache, *, prefix_embeds=None,
            cross_kv=None, window_override: int = -1):
    """Fill the model cache from position 0 with ``tokens`` [B,S], after
    the ``prefix_embeds`` rows [0, P) when given; returns (last-position
    logits [B,V], cache)."""
    cfg = model.cfg
    x = _embed_inputs(model, _tokens(model, tokens), prefix_embeds)
    b, s = x.shape[:2]
    positions = torch.arange(s, device=model.device).expand(b, s)
    windows = resolve_windows(model.cfg, window_override)

    def attend(i, mixer, h):
        y, _ = attn.attn_forward(mixer, cfg, h, positions, cache=cache[i],
                                 window=windows[i])
        return y

    x = _run_layers(model, x, attend, cross=_cross(model, cross_kv),
                    recur=_recur_prefill(cache))
    return _logits(model, x[:, -1]), cache


@torch.no_grad()
def prefill_chunk(model: Transformer, tokens, cache, chunk_start, *,
                  on=None, cross_kv=None, window_override: int = -1):
    """Fill the model cache with one chunk of a longer prompt: row b's
    ``tokens[b]`` [B,s] sit at positions [chunk_start[b], chunk_start[b] +
    s) (host ints; one broadcasts).  Chunks are fed in order, each
    attending over the rows earlier chunks wrote
    (``attention.attn_prefill_chunk``); rows past the cache's end are
    dropped, and batch rows whose ``on[b]`` is False are left untouched.
    Returns (logits [B,s,V] of every chunk position, cache).  Recurrent
    models refuse (``check_tree_supported``): they prefill whole prompts."""
    cfg = model.cfg
    check_tree_supported(cfg, "chunked prefill")
    tokens = _tokens(model, tokens)
    b, s = tokens.shape
    start = host_rows(chunk_start, b)
    positions = (torch.as_tensor(start, device=model.device)[:, None]
                 + torch.arange(s, device=model.device))
    x = embed(model.embed.table, tokens)
    windows = resolve_windows(model.cfg, window_override)

    def attend(i, mixer, h):
        y, _ = attn.attn_prefill_chunk(mixer, cfg, h, positions, cache[i],
                                       start, on=on, window=windows[i])
        return y

    x = _run_layers(model, x, attend,
                    cross=_cross(model, cross_kv))
    return _logits(model, x), cache


@torch.no_grad()
def decode_step(model: Transformer, token, cache, cache_len, *,
                cross_kv=None, window_override: int = -1):
    """token [B] -> (logits [B,V], cache); row b's token sits at position
    ``cache_len[b]`` (an int broadcasts) and is written there; recurrent
    layers advance their state one step, in place."""
    cfg = model.cfg
    token = _tokens(model, token).reshape(-1)
    b = token.shape[0]
    rows = host_rows(cache_len, b)
    position = torch.as_tensor(rows, device=model.device)
    kv_len = (position + 1).to(torch.int32)
    x = embed(model.embed.table, token[:, None])
    windows = resolve_windows(model.cfg, window_override)

    def attend(i, mixer, h):
        y, _ = attn.attn_decode(mixer, cfg, h, position, cache[i], rows,
                                kv_len, window=windows[i])
        return y

    x = _run_layers(model, x, attend, cross=_cross(model, cross_kv),
                    recur=_recur_decode(cache))
    return _logits(model, x[:, 0]), cache


@torch.no_grad()
def tree_verify_step(model: Transformer, node_tokens, node_positions,
                     tree_mask, cache, cache_len, tree_caches,
                     tree_write_index, *, cross_kv=None,
                     window_override: int = -1):
    """Verify one tree layer (PipeDec 3.4.2).

    node_tokens [B,n] token ids of the new layer (padded); node_positions
    [B,n] absolute positions; tree_mask [B,n,T] (or [n,T]) per-row
    ancestor mask against the whole tree buffer; cache_len [B] committed
    prefix per row and tree_write_index [B] tree-buffer write offset per
    row (ints broadcast).  A row with no committed prefix (an empty
    slot's, ``cache_len`` 0) whose mask is all false attends as the
    reference's joint softmax does (``attention.attn_tree_verify``'s
    ``empty``).  Returns (logits [B,n,V], tree_caches).  Recurrent models
    refuse (``check_tree_supported``): they speculate in chain mode.
    """
    cfg = model.cfg
    check_tree_supported(cfg)
    dev = model.device
    node_tokens = _tokens(model, node_tokens)
    b, n = node_tokens.shape
    positions = torch.as_tensor(node_positions, device=dev).long()
    positions = positions.reshape(-1, n).expand(b, n)
    mask = torch.as_tensor(tree_mask, device=dev, dtype=torch.bool)
    mask = (mask if mask.dim() == 3 else mask[None]).expand(b, n,
                                                            mask.shape[-1])
    lens = host_rows(cache_len, b)
    model_len = torch.as_tensor(lens, device=dev, dtype=torch.int32)
    write_at = host_rows(tree_write_index, b)
    empty_slots = [i for i, ln in enumerate(lens) if ln == 0]
    empty = attn.empty_rows(empty_slots, mask, cache[0], tree_caches[0],
                            write_at) \
        if empty_slots and cfg.mla is None else None
    # every layer's tree cache takes the layer at the same rows
    write_rows = attn.write_index(next(iter(tree_caches[0].values())),
                                  write_at, b, n)
    x = embed(model.embed.table, node_tokens)
    windows = resolve_windows(model.cfg, window_override)

    def attend(i, mixer, h):
        y, _ = attn.attn_tree_verify(
            mixer, cfg, h, positions, model_cache=cache[i],
            model_len=model_len, tree_cache=tree_caches[i],
            tree_write_index=write_at, tree_mask=mask,
            window=windows[i], tree_write_rows=write_rows,
            empty=empty)
        return y

    x = _run_layers(model, x, attend,
                    cross=_cross(model, cross_kv))
    return _logits(model, x), tree_caches


@torch.no_grad()
def commit_tree_node(cache, tree_caches, node_idx: int, model_len: int):
    """Two-level cache sync (paper 3.4.3): copy tree row ``node_idx`` of
    every layer's tree cache into its model cache at row ``model_len``, in
    place: every leaf, so int8 rows move with their scales as they are,
    with no new quantization.  Returns the model cache."""
    for layer_cache, layer_tree in zip(cache, tree_caches):
        for name, buf in layer_cache.items():
            if not 0 <= model_len < buf.shape[1]:
                raise IndexError(f"commit at row {model_len} does not fit "
                                 f"{buf.shape[1]} rows")
            buf[:, model_len] = layer_tree[name][:, node_idx]
    return cache


# --------------------------------------------------------------------------
# slot-stacked cache rows (the SpecPipe-DB KV arena)
# --------------------------------------------------------------------------
def _leaf_map(fn, *caches):
    """``fn(leaf, *others)`` over the leaves of per-layer cache lists; a
    ``None`` layer (a recurrent layer's tree cache) stays None."""
    return [None if layer is None else
            {name: fn(buf, *(c[i][name] for c in caches[1:]))
             for name, buf in layer.items()}
            for i, layer in enumerate(caches[0])]


def slice_cache_rows(cache, start: int, size: int):
    """Slot rows [start, start + size) of every leaf, as views: dense
    slices (on axis 0, recurrent state too), and table slices over the
    shared pool for paged leaves.  Writes through the views land in the
    arena."""
    return _leaf_map(lambda buf: paging.slice_slots(buf, start, size)
                     if paging.is_paged(buf) else buf[start:start + size],
                     cache)


def update_cache_rows(cache, rows, start: int = 0):
    """Write a row slice (dense rows, or ``slice_cache_rows`` views) back
    into the full slot-stacked cache at slot ``start``, in place.  Views
    of the arena are in it already and are left as they are."""
    def put(buf, upd):
        if paging.is_paged(buf):
            if paging.is_paged(upd):
                return paging.adopt_pool(buf, upd)
            return paging.write_slot_rows(buf, upd, start)
        dst = buf[start:start + upd.shape[0]]
        if dst.data_ptr() != upd.data_ptr():
            dst.copy_(upd)
        return buf
    _leaf_map(put, cache, rows)
    return cache


def where_cache_rows(on, new, old):
    """Per-slot select: slot b of every leaf takes ``new`` where ``on[b]``
    and keeps ``old`` elsewhere (a new cache; paged leaves select per
    block through the shared table)."""
    def pick(o, n):
        if paging.is_paged(o):
            return paging.where_slots(on, n, o)
        sel = torch.as_tensor(on, device=o.device).reshape(
            -1, *([1] * (o.dim() - 1)))
        return torch.where(sel, n.to(o.dtype), o)
    return _leaf_map(pick, old, new)


def _rows_memo():
    """Physical-row index by table: the leaves of one arena share their
    tables, so a batched helper computes each index once per call."""
    memo = {}

    def get(p: paging.Paged, key, make):
        k = (p.table.data_ptr(), tuple(p.table.shape), key)
        if k not in memo:
            memo[k] = make()
        return memo[k]
    return get


@torch.no_grad()
def commit_tree_nodes(cache, tree_caches, node_idx, model_len,
                      commit_mask=None):
    """Batched two-level cache sync (SpecPipe-DB exit phase), in place:
    slot b moves tree row ``node_idx[b]`` into its model cache at row
    ``model_len[b]``, wherever ``commit_mask[b]`` (all slots when None);
    the other slots stay bit-unchanged.  Paged model leaves take the row
    through their table (``take_len_rows`` then ``write_len_rows``, drop
    semantics); dense ones are checked on the host to fit."""
    node = np.asarray(node_idx, np.int64).reshape(-1)
    mlen = np.asarray(model_len, np.int64).reshape(-1)
    on = (np.ones(node.shape, bool) if commit_mask is None
          else np.asarray(commit_mask, bool).reshape(-1))
    rows = np.nonzero(on)[0]
    memo = _rows_memo()
    dev = {}
    for layer_cache, layer_tree in zip(cache, tree_caches):
        for name, mbuf in layer_cache.items():
            tbuf = layer_tree[name]
            d = (mbuf.pages if paging.is_paged(mbuf) else mbuf).device
            if d not in dev:   # every index on the device once per call
                dev[d] = [torch.as_tensor(a, device=d) for a in (
                    node, mlen, on, rows, node[rows], mlen[rows])]
            node_d, mlen_d, on_d, rows_d, node_r, mlen_r = dev[d]
            if paging.is_paged(mbuf):
                src = (tbuf.pages[memo(tbuf, "src", lambda: paging.len_rows(
                    tbuf, node_d, 1))] if paging.is_paged(tbuf)
                    else tbuf[torch.arange(node.size, device=d), node_d,
                              None])
                dst = memo(mbuf, "dst", lambda: paging.len_rows(
                    mbuf, mlen_d, 1, on_d))
                paging.write_len_rows(mbuf, src, None, rows=dst)
                continue
            if rows.size and mlen[rows].max() >= mbuf.shape[1]:
                raise IndexError(f"commit at rows {mlen[rows].tolist()} "
                                 f"does not fit {mbuf.shape[1]} rows")
            if paging.is_paged(tbuf):
                tbuf = paging.to_dense(tbuf)
            mbuf[rows_d, mlen_r] = tbuf[rows_d, node_r]
    return cache


def _inverse_perms(index_maps: np.ndarray, length: int) -> np.ndarray:
    """Per slot, the gather order g[new] = old of a prune map (dropped
    rows, -1, pushed past the live prefix; the slack rows past the map's
    width count as dropped)."""
    im = np.full((index_maps.shape[0], length), -1, np.int64)
    im[:, :index_maps.shape[1]] = index_maps
    key = np.where(im >= 0, im, length + np.arange(length)[None])
    return np.argsort(key, axis=1, kind="stable")


@torch.no_grad()
def remap_tree_cache_rows(tree_caches, index_maps):
    """Batched post-prune tree-cache compaction (SpecPipe-DB exit phase),
    in place: ``index_maps`` [B, cap] holds one old -> new prune map per
    slot (identity rows leave a slot bit-unchanged, so pruned and
    untouched slots share one gather).  Per slot the permutation is
    ``speculative.remap_tree_caches``'s.  Paged leaves gather their
    permuted rows through the table and scatter them back through it."""
    maps = np.asarray(index_maps, np.int64)
    memo = _rows_memo()
    perms = {}
    for layer in tree_caches:
        for name, buf in layer.items():
            length = buf.length if paging.is_paged(buf) else buf.shape[1]
            d = (buf.pages if paging.is_paged(buf) else buf).device
            if (length, d) not in perms:
                perms[length, d] = torch.as_tensor(
                    _inverse_perms(maps, length), device=d)
            g = perms[length, d]
            if paging.is_paged(buf):
                src = memo(buf, "src", lambda: torch.gather(
                    paging.row_ids(buf), 1, g))
                dst = memo(buf, "dst", lambda: paging.row_ids(buf))
                buf.pages[dst.reshape(-1)] = buf.pages[src.reshape(-1)]
                continue
            idx = g.reshape(*g.shape, *([1] * (buf.dim() - 2)))
            buf.copy_(torch.gather(buf, 1, idx.expand_as(buf)))
    return tree_caches
