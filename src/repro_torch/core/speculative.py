"""Draft-propose / target-verify machinery of the port's PipeDec engine.

``ModelBundle`` wraps a ``Transformer`` with the step functions the engines
call (prefill, decode, tree verify, commit, cache construction, and the
SpecPipe-DB engine's batched ``tree_verify_rows`` / ``commit_rows`` over
slot-stacked arenas) and counts its calls by name in ``calls``, the hook
that tests and the chip smoke run use to tie kernel launches to model
steps.

Token selection at commit time follows the paper: greedy takes the argmax
of the target's logits at the accepted node; stochastic samples from the
target's temperature / top-k / top-p filtered distribution with a
``torch.Generator`` (it cannot replay ``jax.random``, so only greedy runs
match the JAX package token for token).  Either way the emitted token comes
from the target alone, so the output distribution is lossless.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Optional

import torch

from repro_torch.core import tree as tree_lib
from repro_torch.counting import bump
from repro_torch.kernels.quant import quantize_weight
from repro_torch.models import transformer as tf
from repro_torch.models.transformer import Transformer

# projection-weight name -> number of leading contraction axes, for the
# int8 serving path (per-out-channel symmetric quantization).  Everything
# else (embeddings, norms, the LM head) stays fp32.
QUANT_WEIGHTS = {"w_q": 1, "w_k": 1, "w_v": 1, "w_o": 2,
                 "w_gate": 1, "w_up": 1, "w_down": 1}


@dataclasses.dataclass
class SamplingParams:
    """Sampling controls: temperature (0 => greedy), top-k, top-p."""
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0


def select_token(logits: torch.Tensor, sp: SamplingParams,
                 generator: Optional[torch.Generator] = None) -> int:
    """logits [V] -> token id (the first maximum when greedy)."""
    if sp.temperature <= 0.0:
        return int(torch.argmax(logits))
    logits = logits.float() / sp.temperature
    if sp.top_k:
        kth = torch.topk(logits, sp.top_k).values[-1]
        logits = logits.masked_fill(logits < kth, -float("inf"))
    if sp.top_p < 1.0:
        sorted_logits = torch.sort(logits, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, -1), -1)
        cutoff_ix = min(int((cum < sp.top_p).sum()), logits.shape[0] - 1)
        logits = logits.masked_fill(logits < sorted_logits[cutoff_ix],
                                    -float("inf"))
    probs = torch.softmax(logits, -1)
    return int(torch.multinomial(probs, 1, generator=generator))


class ModelBundle:
    """A model plus the step functions the engines drive.

    ``calls`` counts prefill / decode / tree_verify / commit calls by name,
    exactly when several threads call (``counting.bump``).

    A modality bundle carries its inputs, as the reference's does:
    ``prefix_embeds`` [1, P, d] (a VLM's vision prefix) goes before every
    prompt this bundle prefills, and the engines count its P rows in the
    committed length; ``enc_out`` [1, T, d] (an encoder output,
    ``encdec.encode``) is cross-attended by every step.  Its per-layer
    cross K/V are computed once, here; one bundle's prefix and encoder
    output serve every slot of a SpecPipe-DB arena.

    ``window_override`` (-1: each layer's own window) is baked into every
    step, as the reference's bundle bakes it into its jitted steps: >= 0
    replaces every attention layer's window (0: none;
    ``transformer.resolve_windows``), e.g. ``launch.specs.window_override``
    of ``long_500k``.  Every engine drives the model through the bundle,
    so each serves the override; the overlapped ring turns its prefill
    lane off for such a bundle, as the reference does.
    """

    def __init__(self, model: Transformer, *, prefix_embeds=None,
                 enc_out=None, window_override: int = -1):
        self.model = model
        self.cfg = model.cfg
        self.window_override = int(window_override)
        self.calls = collections.Counter()
        dev = model.device
        self.prefix_embeds = (None if prefix_embeds is None else
                              torch.as_tensor(prefix_embeds,
                                              device=dev).float())
        self.enc_out = (None if enc_out is None else
                        torch.as_tensor(enc_out, device=dev).float())
        self.cross_kv = (tf.encode_cross_kv(model, self.enc_out)
                         if self.enc_out is not None and self.cfg.is_encdec
                         else None)

    @property
    def prefix_len(self) -> int:
        """Rows of the vision prefix before each prompt (0 without)."""
        return 0 if self.prefix_embeds is None else \
            self.prefix_embeds.shape[1]

    @property
    def device(self) -> torch.device:
        """The device the model runs on."""
        return self.model.device

    def prefill(self, tokens, cache):
        """(last-position logits [B,V], cache) for prompts [B,S]."""
        bump(self.calls, "prefill")
        return tf.prefill(self.model, tokens, cache,
                          prefix_embeds=self.prefix_embeds,
                          cross_kv=self.cross_kv,
                          window_override=self.window_override)

    def prefill_chunk(self, tokens, cache, chunk_start, *, on=None):
        """(logits [B,s,V], cache) for one prompt chunk per row at
        ``chunk_start`` (``transformer.prefill_chunk``)."""
        bump(self.calls, "prefill_chunk")
        return tf.prefill_chunk(self.model, tokens, cache, chunk_start,
                                on=on, cross_kv=self.cross_kv,
                                window_override=self.window_override)

    def decode(self, token, cache, cache_len):
        """(logits [B,V], cache) for one token per row at ``cache_len``."""
        bump(self.calls, "decode")
        return tf.decode_step(self.model, token, cache, cache_len,
                              cross_kv=self.cross_kv,
                              window_override=self.window_override)

    def tree_verify(self, node_tokens, node_positions, tree_mask, cache,
                    cache_len, tree_caches, tree_write_index):
        """(logits [B,n,V], tree_caches) for one tree layer per row."""
        bump(self.calls, "tree_verify")
        return tf.tree_verify_step(self.model, node_tokens, node_positions,
                                   tree_mask, cache, cache_len, tree_caches,
                                   tree_write_index, cross_kv=self.cross_kv,
                                   window_override=self.window_override)

    def tree_verify_rows(self, node_tokens, node_positions, tree_mask,
                         cache, cache_len, tree_caches, tree_write_index, *,
                         bucket: int):
        """One fused tree verify over the first ``bucket`` slot rows of
        slot-stacked arenas (SpecPipe-DB): row b is slot b's deepest tree
        layer, bounded by its own ``cache_len[b]`` and ancestor mask and
        written at its own ``tree_write_index[b]``.  The arenas are sliced
        into views (paged leaves into table slices over their pools) and
        reach the layers as they are, so the tree rows land in the arena
        in place.  Returns (logits [bucket,n,V], tree_caches)."""
        bump(self.calls, "tree_verify_rows")
        logits, _ = tf.tree_verify_step(
            self.model, node_tokens, node_positions, tree_mask,
            tf.slice_cache_rows(cache, 0, bucket), cache_len,
            tf.slice_cache_rows(tree_caches, 0, bucket), tree_write_index,
            cross_kv=self.cross_kv, window_override=self.window_override)
        return logits, tree_caches

    @torch.no_grad()
    def forward(self, tokens):
        """Logits [B,P+S,V] of every position of ``tokens`` [B,S] (the
        reference bundle's jitted ``forward``), after this bundle's prefix
        and against its encoder output, with its window override."""
        bump(self.calls, "forward")
        return tf.forward(self.model, tokens,
                          prefix_embeds=self.prefix_embeds,
                          enc_out=self.enc_out,
                          window_override=self.window_override)

    def commit(self, cache, tree_caches, node_idx: int, model_len: int):
        """Move tree row ``node_idx`` into the model cache at ``model_len``."""
        bump(self.calls, "commit")
        return tf.commit_tree_node(cache, tree_caches, node_idx, model_len)

    def commit_rows(self, cache, tree_caches, node_idx, model_len,
                    commit_mask):
        """Batched per-row two-level cache sync over slot-stacked arenas
        (rows whose ``commit_mask`` is False stay bit-unchanged)."""
        bump(self.calls, "commit_rows")
        return tf.commit_tree_nodes(cache, tree_caches, node_idx, model_len,
                                    commit_mask)

    def init_cache(self, batch: int, max_len: int):
        """Zeroed model cache on the model's device: K/V per attention
        layer, the zero state per recurrent layer."""
        return tf.init_cache(self.cfg, batch, max_len, device=self.device)

    def init_tree_caches(self, batch: int, capacity: int):
        """Zeroed tree KV caches on the model's device (None for a
        recurrent layer)."""
        return tf.init_tree_caches(self.cfg, batch, capacity,
                                   device=self.device)

    @torch.no_grad()
    def quantize(self) -> "ModelBundle":
        """Int8 serving copy: every projection weight of ``QUANT_WEIGHTS``
        becomes a per-out-channel symmetric int8 ``QuantWeight``, quantized
        once here, and ``cfg.quant = "int8"`` switches every cache the new
        bundle builds to the int8 KV layout.  This bundle is left
        untouched.  The fp32 weights that stay fp32 (embeddings, norms,
        the LM head) are shared with it, not copied, and so is the vision
        prefix; the window override carries over.  Dense models only.
        """
        cfg = self.cfg
        if cfg.quant:
            raise ValueError(f"{cfg.name} is already quantized ({cfg.quant})")
        # MoE, MLA and the recurrent families fail check_supported's int8
        # branch; an encoder-decoder is refused here
        tf.check_supported(dataclasses.replace(cfg, quant="int8"))
        if cfg.encoder is not None:
            raise NotImplementedError(
                f"int8 serving supports dense attention only, not "
                f"{cfg.name!r}")
        qmodel = Transformer(dataclasses.replace(cfg, quant="int8"),
                             torch.device("meta"))
        for name, w in self.model.named_parameters():
            path, _, leaf = name.rpartition(".")
            dst = qmodel.get_submodule(path)
            if leaf in QUANT_WEIGHTS:
                qw = getattr(dst, leaf)
                qw.q8, qw.scale = quantize_weight(w, QUANT_WEIGHTS[leaf])
            else:
                setattr(dst, leaf, w)
        return ModelBundle(qmodel, prefix_embeds=self.prefix_embeds,
                           enc_out=self.enc_out,
                           window_override=self.window_override)


@torch.no_grad()
def remap_tree_caches(tree_caches, index_map: torch.Tensor, capacity: int):
    """Compact tree-cache rows with the tree's prune permutation, in place.

    Rows whose ``index_map`` entry is -1 are dropped (pushed past the live
    prefix; stale rows are never attended).  Buffers carry ``capacity + w``
    rows (slack for fixed-width layer writes); the slack rows map to -1.
    """
    first = next(iter(tree_caches[0].values()))
    length = first.shape[1]
    im = torch.cat([index_map.long(),
                    torch.full((length - capacity,), -1, dtype=torch.long)])
    ar = torch.arange(length)
    # inverse permutation: g[new] = old, dropped rows pushed to the end
    g = torch.argsort(torch.where(im >= 0, im, length + ar), stable=True)
    g = g.to(first.device)
    for layer in tree_caches:
        for buf in layer.values():
            buf.copy_(buf.index_select(1, g))
    return tree_caches


@torch.no_grad()
def draft_candidates(logits: torch.Tensor, valid: torch.Tensor, c: int):
    """Per-node top-``c`` candidates from draft logits.

    logits [w, V] on the model's device; valid [w] bool (CPU).  Returns CPU
    (cand_tokens [w, c] int32, cand_logprobs [w, c] f32) with invalid rows
    at -1e30.  A stable descending sort keeps ``jax.lax.top_k``'s order
    among equal log-probabilities (lower token id first).
    """
    logp = torch.log_softmax(logits.float(), dim=-1)
    top_lp, top_tok = torch.sort(logp, dim=-1, descending=True, stable=True)
    top_lp, top_tok = top_lp[:, :c].cpu(), top_tok[:, :c].cpu()
    top_lp = torch.where(valid[:, None], top_lp,
                         torch.tensor(tree_lib.NEG_INF, dtype=torch.float32))
    return top_tok.to(torch.int32), top_lp
