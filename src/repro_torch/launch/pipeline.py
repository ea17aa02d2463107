"""The paper's pipeline-parallel deployment as a stage ring: the port of the
JAX package's ``repro/launch/pipeline.py``.

The reference runs the ring as one SPMD program, ``shard_map`` over a
``"model"`` mesh axis with ``ppermute`` as the hop between stages.  The port
runs it in one process on one card: the ring is a Python list with one
``RingEntry`` per stage, a stage's weights are the bundle's own
``DecoderLayer``s (views, not copies) and its caches the same per-layer
``{"k", "v"}`` buffers every other path of the port keeps, grouped by stage
(``split_stages``).  The hop is ``hop``, a rotation of that list: the one
place a deployment over several cards would move activations between
devices.

One tick (= one paper timestep, Fig. 2):
  * stage 0 ingests the newest tree layer; every other stage keeps the
    in-flight layer its ring slot holds (ingest first: an entry at tick t
    exits at ``t + n_stages - 1``, the engine's ``Flight.exit_t``);
  * each stage first applies the control message that reached it this
    tick (exit commit, then prune compaction: the paper's pruning
    propagation), then the prefill chunk it holds, then its layers to the
    tree layer it holds, reading and writing its own slice of the
    two-level KV cache;
  * the activation leaving the last stage is the exit; the caller
    unembeds it into the verify logits of the layer that completed;
  * ``hop`` moves every entry one stage forward.

What rides with a layer is frozen at its entry: positions, ancestor mask,
tree write offset, committed length, validity and the slot's tree
``version``.  The activations and the positions, mask and committed length
that the attention reads on the card are tensors made once, at entry;
the rest is host arrays (the committed length too, as ``lens``, which
marks a bucket's empty rows), so no stage ever reads a value back from
the card.

The ring serves what the reference's ring serves (``check_ring_supported``):
uniform attention stacks, with or without QKV bias, any MLP variant, MoE
with no dense layer before the stack, a vision prefix (it enters through
admission prefill only) and an encoder-decoder, whose per-layer cross K/V
(one encoder output for every slot) every stage's layers attend.

The overlapped schedule adds three mechanisms, as in the reference:
  * the gated ctrl channel: the exit decision of timestep t (commit length
    and the old -> new prune ``index_map``) enters at t + 1 and reaches
    stage k at tick t + 1 + k, after every pre-prune layer and before the
    first post-prune one; ``c_active`` rides beside it, and a stage whose
    message is inactive skips it;
  * ``kill [B]`` invalidates every in-flight layer of a slot (miss,
    retire): killed rows stop writing their tree rows (under MoE they
    are still computed, ``computed_rows``) and exit invalid,
    and ``version`` proves that a resolved exit belongs to the slot's
    current tree;
  * the prefill lane: a joining request's prompt chunk (``p_act [B, Pcap,
    d]`` with ``p_len``/``p_on``/``p_off``) enters at stage 0 and each
    stage applies its layers in chunk mode, writing the slot's model
    cache rows [p_off, p_off + Pcap); the chunk's last hidden state exits
    ``n_stages - 1`` ticks later (``p_last``/``p_valid``).

Every sub-step is skipped on the host when it has nothing to do (no valid
row, an inactive message, an empty lane), which is the identity by
construction; so kernel launches count only real stage applications.
``calls``, when given, counts them: ``stage_apply`` and ``stage_layers``
(layers run in tree mode: one flash and one tree launch each, and one
more flash launch for a cross sub-layer),
``stage_ctrl``, ``stage_prefill`` and ``prefill_layers``.

JAX's ``stage_apply`` computes every row and keeps old or new per row; the
port's caches are written in place, so the tree-row writes of an invalid
row (killed or padded) are masked out of the write itself
(``attention.cache_write_rows(on=)``), and its activations pass through.
A tick computes a bucket's empty rows beside the valid ones
(``computed_rows``), as the local fused verify does, while an entry has a
valid row; under MoE it computes the rows killed in flight too.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models import attention as attn
from repro_torch.models import paging
from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import Transformer


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Static shape of the pipelined deployment: stage count, tree layer
    width w (rows per ring entry), tree node capacity and model KV
    length.  Tree caches hold ``tree_capacity + width`` rows."""
    n_stages: int
    width: int
    tree_capacity: int
    max_len: int


def check_ring_supported(cfg: ModelConfig) -> None:
    """Raise for a configuration the reference's ring refuses, and for
    nothing else: a stack with a layer kind other than attention (the
    recurrent families: ``make_stage_fns`` asserts ``kinds == ("attn",)``;
    they speculate in chain mode), and dense layers before the uniform
    stack (MoE ``first_dense > 0``, Moonlight and DeepSeek-V2:
    ``stage_layout`` asserts a uniform layer stack).  Dense, QKV-bias,
    GeGLU and GELU MLPs, MoE with ``first_dense`` 0, a vision prefix and
    an encoder with cross-attention pass, in fp32 or int8."""
    tf.check_supported(cfg)
    kinds = sorted(set(tf.layer_kinds(cfg)) - {"attn"})
    if kinds:
        raise NotImplementedError(
            f"{cfg.name}: pipeline stages support attention stacks, not "
            f"{'/'.join(kinds)} sub-layers (the ring runs SpecPipe-DB's "
            f"tree verify); {tf.CHAIN_MODE}")
    first = cfg.moe.first_dense if cfg.moe is not None else 0
    if first:
        raise NotImplementedError(
            f"{cfg.name}: the pipeline deployment expects a uniform layer "
            f"stack, and moe.first_dense={first} puts dense layers before "
            "the MoE stack")


def stage_layout(cfg: ModelConfig, n_stages: int) -> Tuple[int, int]:
    """(layers_per_stage, padded_total): the layers are cut into
    ``n_stages`` runs of ``ceil(L / n_stages)``; the last stages carry
    padding when ``n_stages`` does not divide L."""
    check_ring_supported(cfg)
    lps = -(-cfg.num_layers // n_stages)
    return lps, lps * n_stages


def _by_stage(items: list, n_stages: int) -> list:
    """[S][lps] of ``items`` in stage order, None for padding."""
    lps = -(-len(items) // n_stages)
    return [[items[s * lps + i] if s * lps + i < len(items) else None
             for i in range(lps)] for s in range(n_stages)]


def stage_params(model: Transformer, n_stages: int):
    """(layers [S][lps], valid [S, lps]): stage s holds the model's own
    ``DecoderLayer``s ``s * lps + l`` (views: no weight is copied), None
    where the layout pads; ``valid`` marks the real ones."""
    layers = _by_stage(list(model.layers), n_stages)
    valid = np.asarray([[lay is not None for lay in st] for st in layers])
    return layers, valid


def split_stages(cache: list, n_stages: int) -> list:
    """A per-layer cache list grouped by stage, [S][lps] (the same dicts,
    None where the layout pads): the stage caches are the buffers the
    caller already holds."""
    return _by_stage(list(cache), n_stages)


def init_stage_caches(cfg: ModelConfig, pcfg: PipelineConfig, *,
                      batch: int = 1, device=None):
    """Zeroed (model_kv, tree_kv) grouped by stage: one per-layer cache of
    ``batch`` slot rows each, ``max_len`` and ``tree_capacity + width``
    rows."""
    model = tf.init_cache(cfg, batch, pcfg.max_len, device=device)
    tree = tf.init_tree_caches(cfg, batch, pcfg.tree_capacity + pcfg.width,
                               device=device)
    return (split_stages(model, pcfg.n_stages),
            split_stages(tree, pcfg.n_stages))


@dataclasses.dataclass
class RingEntry:
    """One stage slot of the ring: the tree layer it holds, the ctrl
    message and the prefill chunk riding with it.  Tensors are on the
    card (made once at entry); the rest are host arrays over the ``B``
    slot rows."""
    valid: np.ndarray                          # [B] bool
    version: np.ndarray                        # [B] int
    act: Optional[torch.Tensor] = None         # [B, w, d]
    positions: Optional[torch.Tensor] = None   # [B, w] int64
    mask: Optional[torch.Tensor] = None        # [B, w, T] bool
    model_len: Optional[torch.Tensor] = None   # [B] int32
    lens: Optional[np.ndarray] = None          # [B] model_len on the host
    entered: Optional[np.ndarray] = None       # [B] valid at entry
    write_idx: Optional[np.ndarray] = None     # [B]
    c_active: bool = False
    c_commit: Optional[np.ndarray] = None      # [B] bool
    c_len: Optional[np.ndarray] = None         # [B]
    c_imap: Optional[np.ndarray] = None        # [B, cap]
    p_act: Optional[torch.Tensor] = None       # [B, Pcap, d]
    p_len: Optional[np.ndarray] = None         # [B]
    p_on: Optional[np.ndarray] = None          # [B] bool
    p_off: Optional[np.ndarray] = None         # [B]
    rows: dict = dataclasses.field(default_factory=dict)  # per-entry memo

    @classmethod
    def dead(cls, batch: int) -> "RingEntry":
        """An empty slot: no valid row, no message, no chunk."""
        return cls(np.zeros(batch, bool), np.zeros(batch, np.int64))

    @property
    def prefilling(self) -> bool:
        return self.p_on is not None and bool(self.p_on.any())


def init_ring(pcfg: PipelineConfig, batch: int = 1) -> List[RingEntry]:
    """An empty ring: one dead entry per stage over ``batch`` slot rows."""
    return [RingEntry.dead(batch) for _ in range(pcfg.n_stages)]


def hop(ring: List[RingEntry]) -> List[RingEntry]:
    """The paper's transmission step (the reference's ``ppermute``): every
    entry moves one stage forward, the last stage's entry leaves, and
    stage 0's slot empties until the next ingest fills it.  On one card
    the entries' tensors stay where they are, so this rotates the list
    and copies nothing; a deployment over several cards would move
    ``act`` and ``p_act`` to the next stage's device here."""
    return [RingEntry.dead(len(ring[0].valid))] + ring[:-1]


def make_stage_fns(cfg: ModelConfig, pcfg: PipelineConfig, *,
                   window_override: int = -1):
    """The per-stage compute, defined once for every schedule.

    Returns ``(stage_apply, stage_ctrl, stage_prefill)``:

      * ``stage_apply(layers, valid_row, kv, tkv, x, positions, mask,
        write_idx, model_len, in_valid, *, write_rows=None, empty=None,
        cross=None) -> x_out`` - one stage's layers over its in-flight
        tree layer ([B, w, d]).  Rows whose ``in_valid`` is False pass
        through and leave the tree caches untouched; padded layers
        (``valid_row`` False) are skipped.  ``empty`` (``empty_rows``)
        gives the rows with no committed prefix the reference's value, as
        ``tree_verify_step`` does; ``cross`` is the stage's per-layer
        cross-attention K/V (``stage_cross``) of an encoder-decoder.
      * ``stage_ctrl(kv, tkv, commit_on, commit_len, index_map)`` - the
        pruning-propagation message on one stage's caches, in place:
        commit tree row 0 into the model cache at ``commit_len`` where
        ``commit_on``, then compact the tree rows through the old -> new
        ``index_map`` (no commit and identity maps: nothing is done).
      * ``stage_prefill(layers, valid_row, kv, x, on, off) -> x_out`` -
        one stage's layers in chunk mode over the prefill lane ([B, Pcap,
        d]), writing the model-cache rows [off[b], off[b] + Pcap) of the
        slots that are ``on``.  A bundle with an encoder output never
        uses the lane (the overlapped ring turns it off), so the lane has
        no cross sub-layer input.

    Every layer the ring accepts is a global attention layer, so
    ``cfg.sliding_window`` is each layer's window (``tf.layer_windows``),
    or ``window_override`` when it is >= 0 (the bundle's,
    ``tf.resolve_windows``).  The reference's stage functions leave out an
    encoder-decoder's cross sub-layer (``_apply_unit`` gets no encoder
    K/V) and build their layers' context with no window override, so its
    ring verifies with the config's window whatever its bundle holds; the
    port's run both, so the ring computes what the local engines compute.
    """
    check_ring_supported(cfg)
    window = tf.resolve_windows(cfg, window_override)[0]

    def _cross_fn(cross):
        if cross is None:
            return None

        def attend_enc(i, p, h):
            return attn.cross_attn_forward(p, cfg, h, cross[i])
        return attend_enc

    def stage_apply(layers, valid_row, kv, tkv, x, positions, mask,
                    write_idx, model_len, in_valid, *, write_rows=None,
                    empty=None, cross=None):
        ok = np.asarray(in_valid, bool)
        todo = [i for i, lay in enumerate(layers)
                if lay is not None and valid_row[i]]
        if not todo or not ok.any():
            return x
        b, n = x.shape[:2]
        starts = tf.host_rows(write_idx, b)
        if write_rows is None:
            write_rows = attn.write_index(tkv[todo[0]]["k"], starts, b, n,
                                          on=None if ok.all() else ok)
        sel = None if ok.all() else torch.as_tensor(
            ok, device=x.device)[:, None, None]
        for i in todo:
            def attend(_, mixer, h, i=i):
                y, _ = attn.attn_tree_verify(
                    mixer, cfg, h, positions, model_cache=kv[i],
                    model_len=model_len, tree_cache=tkv[i],
                    tree_write_index=starts, tree_mask=mask, window=window,
                    tree_write_rows=write_rows, empty=empty)
                return y
            y = tf._block(i, layers[i], x, attend, cross=_cross_fn(cross))
            x = y if sel is None else torch.where(sel, y, x)
        return x

    def stage_ctrl(kv, tkv, commit_on, commit_len, index_map):
        kv = [c for c in kv if c is not None]
        tkv = [c for c in tkv if c is not None]
        on = np.asarray(commit_on, bool)
        if on.any():
            tf.commit_tree_nodes(kv, tkv, np.zeros(on.shape, np.int32),
                                 commit_len, on)
        imap = np.asarray(index_map)
        if (imap != np.arange(imap.shape[-1])).any():
            tf.remap_tree_cache_rows(tkv, imap)

    def stage_prefill(layers, valid_row, kv, x, on, off):
        on = np.asarray(on, bool)
        todo = [i for i, lay in enumerate(layers)
                if lay is not None and valid_row[i]]
        if not todo or not on.any():
            return x
        b, cap = x.shape[:2]
        off = tf.host_rows(off, b)
        positions = (torch.as_tensor(off, device=x.device)[:, None]
                     + torch.arange(cap, device=x.device))
        sel = None if on.all() else torch.as_tensor(
            on, device=x.device)[:, None, None]
        for i in todo:
            def attend(_, mixer, h, i=i):
                y, _ = attn.attn_prefill_chunk(mixer, cfg, h, positions,
                                               kv[i], off, on=on,
                                               window=window)
                return y
            y = tf._block(i, layers[i], x, attend)
            x = y if sel is None else torch.where(sel, y, x)
        return x

    return stage_apply, stage_ctrl, stage_prefill


def computed_rows(cfg: ModelConfig, valid, entered, lens) -> np.ndarray:
    """[B] the rows a stage computes and writes: the valid ones, and the
    empty ones (host committed length 0: a bucket's slot with no pending
    layer, whose writes land in its own slack region), as the local fused
    verify computes them.  Under MoE the rows routed together decide
    which expert copies a capacity drops, so there every row valid at
    entry (``entered``) is computed, a row killed in flight included, as
    the local verify computed it (its exit is dropped): a stage meets a
    killed layer before the ctrl or in-ring admission that follows the
    kill, so the row reads what it would have read unkilled, and the
    live rows' values do not hang on where the kill caught it.  Without
    MoE a killed row passes through."""
    rows = np.asarray(valid if cfg.moe is None else entered, bool)
    return rows if lens is None else rows | (np.asarray(lens) == 0)


def _write_rows(e: RingEntry, tkv, on: np.ndarray) -> object:
    """The tree-row ``write_index`` of entry ``e``'s rows ``on``, once per
    entry and row mask: every stage's tree caches share one geometry (and,
    paged, one table)."""
    buf = next(c["k"] for c in tkv if c is not None)
    table = buf.table.data_ptr() if paging.is_paged(buf) else None
    key = (on.tobytes(), table)
    if key not in e.rows:
        b, n = e.act.shape[:2]
        e.rows[key] = attn.write_index(
            buf, tf.host_rows(e.write_idx, b), b, n,
            on=None if on.all() else on)
    return e.rows[key]


def empty_rows(cfg: ModelConfig, lens, mask, kv, tkv, write_idx):
    """``attention.EmptyRows`` of a tree layer's rows whose host committed
    length ``lens`` is 0 (a bucket's empty slots: no committed prefix, an
    all-false mask), over one stage's caches, or None when there is none
    (or the model is MLA, whose joint softmax needs no select): what
    ``tree_verify_step`` passes its layers as ``empty``."""
    slots = [i for i, ln in enumerate(np.asarray(lens)) if ln == 0]
    if not slots or cfg.mla is not None:
        return None
    i = next(i for i, c in enumerate(tkv) if c is not None)
    return attn.empty_rows(slots, mask, kv[i], tkv[i],
                           tf.host_rows(write_idx, mask.shape[0]))


def _empty_rows(cfg: ModelConfig, e: RingEntry, kv, tkv):
    """``empty_rows`` of entry ``e``, once per entry (None without host
    lengths): every stage's caches share one geometry."""
    if e.lens is None:
        return None
    buf = next(c["k"] for c in tkv if c is not None)
    key = ("empty", buf.table.data_ptr() if paging.is_paged(buf) else None)
    if key not in e.rows:
        e.rows[key] = empty_rows(cfg, e.lens, e.mask, kv, tkv, e.write_idx)
    return e.rows[key]


def stage_cross(cross_kv, n_stages: int) -> list:
    """An encoder-decoder's per-layer cross-attention K/V (``ModelBundle.
    cross_kv``) grouped by stage as ``split_stages`` groups the layers,
    [S][lps] (None for padding), or S Nones without one.  One encoder
    output serves every slot row (batch 1, broadcast)."""
    if cross_kv is None:
        return [None] * n_stages
    return _by_stage(list(cross_kv), n_stages)


def make_pipedec_tick(cfg: ModelConfig, pcfg: PipelineConfig, *,
                      calls: Optional[collections.Counter] = None,
                      cross_kv=None, window_override: int = -1) -> Callable:
    """The lockstep tick: ``tick(stage_layers, stage_valid, model_kv,
    tree_kv, ring, entry=None, kill=None, ctrl=None, pentry=None) ->
    (ring, exit)``, caches updated in place.

      stage_layers, stage_valid: ``stage_params``;
      model_kv, tree_kv: ``split_stages`` caches over the ring's B rows;
      ring: ``init_ring`` or the ring the last tick returned;
      entry: None (nothing enters) or {"act" [B, w, d], "positions" [B, w],
             "mask" [B, w, T], "model_len" [B] (tensors on the card),
             "write_idx" [B], "valid" [B], "version" [B], "lens" [B]
             (host; "lens" is ``model_len``, whose 0 rows are empty rows,
             ``empty_rows``)};
      kill: [B] host bools or None - invalidate every in-flight layer and
             prefill chunk of these slots (the entry ingested this tick is
             never killed);
      ctrl: None or {"commit" [B], "commit_len" [B], "index_map" [B, cap],
             "clear" [B], "active"} host values - the previous timestep's
             exit decision entering behind the in-flight layers, applied by
             each stage the tick it arrives, before its compute, when
             ``active``; ``clear`` neutralises the slot's messages still
             riding (retire: the slot is recycled); a miss must not clear;
      pentry: None or {"act" [B, Pcap, d] (card), "len", "on", "off" [B]
             (host)} - prompt chunks entering the prefill lane (the lane's
             width Pcap is the chunk's); chunks of one slot are fed on
             consecutive ticks in order.

    ``exit`` holds the entry that left the last stage: "act" (None when no
    row was valid), "valid", "version", "p_last" [B, d] (None when no
    chunk exits) and "p_valid".  A stage that holds only padding layers
    is skipped: it passes everything through.  ``cross_kv``: an
    encoder-decoder's per-layer cross K/V, attended by every stage's
    layers (``stage_cross``); ``window_override``: the bundle's
    (``make_stage_fns``)."""
    stage_apply, stage_ctrl, stage_prefill = make_stage_fns(
        cfg, pcfg, window_override=window_override)
    n_stages = pcfg.n_stages
    crosses = stage_cross(cross_kv, n_stages)
    calls = calls if calls is not None else collections.Counter()

    def ingest(batch, entry, ctrl, pentry) -> RingEntry:
        e = RingEntry.dead(batch)
        if entry is not None:
            e.valid = np.array(entry["valid"], bool)
            e.entered = e.valid.copy()
            e.version = np.array(entry.get("version", e.version), np.int64)
            e.write_idx = np.array(entry["write_idx"], np.int64)
            e.act, e.positions = entry["act"], entry["positions"]
            e.mask, e.model_len = entry["mask"], entry["model_len"]
            if "lens" in entry:
                e.lens = np.array(entry["lens"], np.int64)
        if ctrl is not None:
            e.c_active = bool(ctrl["active"])
            e.c_commit = np.array(ctrl["commit"], bool)
            e.c_len = np.array(ctrl["commit_len"], np.int64)
            e.c_imap = np.array(ctrl["index_map"], np.int64)
        if pentry is not None:
            e.p_act, e.p_len = pentry["act"], np.array(pentry["len"])
            e.p_on = np.array(pentry["on"], bool)
            e.p_off = np.array(pentry["off"], np.int64)
        return e

    def tick(stage_layers, stage_valid, model_kv, tree_kv, ring, entry=None,
             kill=None, ctrl=None, pentry=None):
        batch = len(ring[0].valid)
        riding = ring[1:]
        # 1. kill: the in-flight layers and chunks of pruned or retired
        # slots stop writing and exit invalid
        if kill is not None:
            kill = np.asarray(kill, bool)
            for e in riding:
                e.valid = e.valid & ~kill
                if e.p_on is not None:
                    e.p_on = e.p_on & ~kill
        # retire-clear: a recycled slot's old messages must never reach
        # the next occupant's caches
        if ctrl is not None and np.any(ctrl["clear"]):
            clr = np.asarray(ctrl["clear"], bool)
            for e in riding:
                if e.c_commit is not None:
                    e.c_commit = e.c_commit & ~clr
                    e.c_len = np.where(clr, 0, e.c_len)
                    e.c_imap = np.where(clr[:, None],
                                        np.arange(e.c_imap.shape[1]),
                                        e.c_imap)
        # 2. ingest: stage 0 takes the new layer, message and chunk
        cur = [ingest(batch, entry, ctrl, pentry)] + riding

        for k, e in enumerate(cur):
            layers, vrow = stage_layers[k], stage_valid[k]
            if not np.any(vrow):
                continue               # padding only: the identity
            kv, tkv = model_kv[k], tree_kv[k]
            # 3. pruning propagation: commit, then compact, before compute
            if e.c_active:
                stage_ctrl(kv, tkv, e.c_commit, e.c_len, e.c_imap)
                calls["stage_ctrl"] += 1
            # 3b. the prefill lane, in chunk mode
            if e.prefilling:
                e.p_act = stage_prefill(layers, vrow, kv, e.p_act, e.p_on,
                                        e.p_off)
                calls["stage_prefill"] += 1
                calls["prefill_layers"] += int(np.sum(vrow))
            # 4. this stage's layers over the tree layer it holds
            if e.valid.any():
                on = computed_rows(cfg, e.valid, e.entered, e.lens)
                e.act = stage_apply(layers, vrow, kv, tkv, e.act,
                                    e.positions, e.mask, e.write_idx,
                                    e.model_len, on,
                                    write_rows=_write_rows(e, tkv, on),
                                    empty=_empty_rows(cfg, e, kv, tkv),
                                    cross=crosses[k])
                calls["stage_apply"] += 1
                calls["stage_layers"] += int(np.sum(vrow))

        # 5. exit: the entry the last stage just finished
        last = cur[-1]
        out = {"act": last.act if last.valid.any() else None,
               "valid": last.valid.copy(), "version": last.version.copy()}
        p_valid = (last.p_on.copy() if last.p_on is not None
                   else np.zeros(batch, bool))
        out["p_valid"], out["p_last"] = p_valid, None
        if p_valid.any():
            idx = np.clip(last.p_len.astype(np.int64) - 1, 0,
                          last.p_act.shape[1] - 1)
            out["p_last"] = last.p_act[
                torch.arange(batch, device=last.p_act.device),
                torch.as_tensor(idx, device=last.p_act.device)]
        # 6. every entry one stage forward
        return hop(cur), out

    return tick


def make_pipeline_verify(cfg: ModelConfig, pcfg: PipelineConfig, *,
                         calls: Optional[collections.Counter] = None,
                         cross_kv=None, window_override: int = -1):
    """The flush schedule: ingest a batched entry layer into stage 0 of a
    fresh ring and run exactly ``n_stages`` ticks, so that it crosses
    every stage and exits (stage 0 ingests and processes on the same
    tick, so no trailing tick is needed).  The other stages hold dead
    entries and are skipped, so the flush is one pass of the stack.

    Returns ``verify(stage_layers, stage_valid, model_kv, tree_kv, entry)
    -> (exit_act [B, w, d], exit_valid [B])``; tree caches are written in
    place."""
    tick = make_pipedec_tick(cfg, pcfg, calls=calls, cross_kv=cross_kv,
                             window_override=window_override)

    def verify(stage_layers, stage_valid, model_kv, tree_kv, entry):
        ring = init_ring(pcfg, len(entry["valid"]))
        ent, out = entry, None
        for _ in range(pcfg.n_stages):
            ring, out = tick(stage_layers, stage_valid, model_kv, tree_kv,
                             ring, ent)
            ent = None
        return out["act"], out["valid"]

    return verify
