"""PipeDec decode engine: draft-in-pipeline speculative decoding.

The port of the JAX package's ``repro/core/pipedec.py``.  It is the
*logical* engine: it runs the exact computation and information schedule
of the paper's pipelined system on one device.  The target's stage
partition changes only *when* a tree layer's logits are available
(an entry at timestep t exits at ``t + n_stages - 1``), never *what* is
computed, so greedy output equals plain autoregressive decoding.

Per timestep (paper 3.4, Fig. 2):
  1. the deepest tree layer *enters*: the target verifies it (logits kept
     until exit) and the draft processes the same layer to propose the
     next one (tree expand);
  2. the layer that entered ``n_stages - 1`` timesteps ago *exits*: the
     root's logits give the next committed token x; the root's KV row moves
     from the tree cache to the model cache (two-level cache sync, 3.4.3);
     the tree is pruned to the child holding x (hit) or restarted at x
     (miss), and in-flight state is remapped or dropped to match.

One request's loop state is a ``DecodeState`` and one timestep is
``PipeDecEngine.step``, split into the phases the batched engine
(``serving.dynbatch.SpecPipeDBEngine``) drives across requests.  Its seams:
``init_state`` takes recycled arena rows (``caches``) or hands the prefill
to the executor that owns the arena (``prefill_fn``), and ``exit_apply``
takes the cache sync and the prune remap as callbacks (``commit_caches``,
``remap_caches``), which the batched engine defers to one batched call per
timestep.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import tree as tree_lib
from repro_torch.core.speculative import (ModelBundle, SamplingParams,
                                          draft_candidates,
                                          remap_tree_caches, select_token)


@dataclasses.dataclass
class PipeDecConfig:
    """Dynamic-tree SpecPipe config: stage count, max tree layer width
    w, max children per node c, tree depth cap and sampling."""
    n_stages: int = 4
    width: int = 8            # max tree layer width w
    branch: int = 4           # max children per node c
    max_depth: int = 0        # 0 => n_stages + 4
    sampling: SamplingParams = dataclasses.field(default_factory=SamplingParams)

    @property
    def depth_cap(self) -> int:
        """Deepest layer the tree may grow to."""
        return self.max_depth or self.n_stages + 4

    @property
    def capacity(self) -> int:
        """Tree node slots: the root plus ``depth_cap`` full layers."""
        return 1 + self.width * self.depth_cap

    @property
    def tree_buffer_capacity(self) -> int:
        """Tree KV rows: ``capacity`` plus width-w slack, so every
        fixed-width layer write fits."""
        return self.capacity + self.width


@dataclasses.dataclass
class Flight:
    """One in-flight tree layer between entry and exit."""
    exit_t: int
    node_idx: np.ndarray      # [w] int32 tree indices (-1 invalid)
    # [w, V] target verify logits, or a deferred handle whose resolve()
    # gives them at exit (the overlapped ring's Deferred futures)
    logits: object


@dataclasses.dataclass
class EntryInputs:
    """One request's deepest tree layer, ready for the tree-verify call."""
    tokens: torch.Tensor      # [w] int32 layer tokens (padded with 0)
    positions: torch.Tensor   # [w] absolute positions
    mask: torch.Tensor        # [w, Tcap] padded ancestor-mask rows
    write_index: int          # tree-buffer write offset
    node_idx: np.ndarray      # [w] int32 tree indices (-1 invalid)


def remap_flight_indices(node_idx: np.ndarray, index_map) -> np.ndarray:
    """Apply a prune's old -> new ``index_map`` to buffered node indices
    (-1 stays -1; dropped nodes become -1).  int32 in, int32 out."""
    imap = np.asarray(index_map)
    out = np.where(node_idx >= 0, imap[np.maximum(node_idx, 0)], -1)
    return out.astype(np.int32)


@dataclasses.dataclass
class GenStats:
    """Per-request SpecPipe counters: timesteps, commits, hit/miss
    verifications and ring entries."""
    timesteps: int = 0
    commits: int = 0
    hits: int = 0
    misses: int = 0
    entries: int = 0
    commits_per_step: List[int] = dataclasses.field(default_factory=list)

    @property
    def acceptance(self) -> float:
        """Hits over verified exits."""
        tot = self.hits + self.misses
        return self.hits / tot if tot else 0.0

    @property
    def tokens_per_timestep(self) -> float:
        """Committed tokens per pipeline timestep."""
        return self.commits / self.timesteps if self.timesteps else 0.0


@dataclasses.dataclass
class DecodeState:
    """Everything one in-flight request carries between timesteps."""
    committed: List[int]
    tree: tree_lib.Tree
    t_cache: list             # target model (level-1) KV cache
    d_cache: list             # draft model cache
    t_tree: list              # target tree (level-2) KV cache
    d_tree: list              # draft tree cache
    model_len: int
    generator: Optional[torch.Generator]
    max_new_tokens: int
    limit: int                # local-timestep budget
    flights: List[Flight] = dataclasses.field(default_factory=list)
    pending: bool = True      # deepest layer not yet entered
    last_draft: Optional[Tuple[np.ndarray, torch.Tensor]] = None
    stats: GenStats = dataclasses.field(default_factory=GenStats)
    t: int = 0                # local timestep counter
    eos: Optional[int] = None
    eos_hit: bool = False
    sampling: Optional[SamplingParams] = None  # per-request (None => cfg's)

    @property
    def done(self) -> bool:
        """Finished: eos, token budget or timestep budget reached."""
        return (self.eos_hit
                or len(self.committed) >= 1 + self.max_new_tokens
                or self.t >= self.limit)

    def output(self) -> np.ndarray:
        """The committed tokens, first token included."""
        return np.asarray(self.committed[: 1 + self.max_new_tokens])

    def caches(self) -> tuple:
        """(t_cache, d_cache, t_tree, d_tree)."""
        return (self.t_cache, self.d_cache, self.t_tree, self.d_tree)


class PipeDecEngine:
    """Single-request SpecPipe engine: drives the dynamic token tree
    through the stage ring one timestep at a time (entry at t exits
    at t + n_stages - 1) and commits on the hit path."""

    def __init__(self, target: ModelBundle, draft: ModelBundle,
                 pcfg: PipeDecConfig, max_len: int = 512):
        if target.cfg.vocab_size != draft.cfg.vocab_size:
            raise ValueError("target and draft must share a vocabulary")
        self.target, self.draft, self.pcfg = target, draft, pcfg
        self.max_len = max_len

    @property
    def tree_buffer_capacity(self) -> int:
        """Rows of each tree KV cache."""
        return self.pcfg.tree_buffer_capacity

    def init_state(self, prompt: np.ndarray, max_new_tokens: int,
                   seed: int = 0, max_timesteps: Optional[int] = None, *,
                   caches=None, eos: Optional[int] = None,
                   sampling: Optional[SamplingParams] = None,
                   prefill_fn=None) -> DecodeState:
        """Prefill both models and commit the first token.  ``seed`` seeds
        the sampling generator (unused when greedy).

        ``caches`` supplies recycled (t_cache, d_cache, t_tree, d_tree)
        batch-1 buffers (a KV arena's slot rows): prefill overwrites the
        prompt's rows and every mask is bounded by ``model_len`` or the
        ancestor mask, so a previous occupant's rows are never attended.
        ``prefill_fn`` hands the prefill to an executor that owns the
        arena: it takes the [1, len] prompt, fills both models' caches
        there and returns the target's last-position logits; the state
        then carries no caches of its own.  ``sampling`` overrides
        ``pcfg.sampling`` for this request."""
        p = self.pcfg
        tgt, drf = self.target, self.draft
        sp = sampling if sampling is not None else p.sampling
        gen = torch.Generator(device=tgt.device)
        gen.manual_seed(seed)
        prompt_b = np.asarray(prompt, np.int64)[None]
        if prefill_fn is not None:
            t_cache = d_cache = t_tree = d_tree = None
            t_logits = prefill_fn(prompt_b)
        else:
            if caches is None:
                tcap = self.tree_buffer_capacity
                caches = (tgt.init_cache(1, self.max_len),
                          drf.init_cache(1, self.max_len),
                          tgt.init_tree_caches(1, tcap),
                          drf.init_tree_caches(1, tcap))
            t_cache, d_cache, t_tree, d_tree = caches
            t_logits, t_cache = tgt.prefill(prompt_b, t_cache)
            _, d_cache = drf.prefill(prompt_b, d_cache)

        first = select_token(t_logits[0], sp, gen)
        # the target's vision prefix counts for the draft too (the
        # reference's rule: one committed length for both models)
        st = DecodeState(
            committed=[first], tree=tree_lib.tree_init(p.capacity, first),
            t_cache=t_cache, d_cache=d_cache, t_tree=t_tree, d_tree=d_tree,
            model_len=tgt.prefix_len + len(prompt), generator=gen,
            max_new_tokens=max_new_tokens,
            limit=max_timesteps or (max_new_tokens * (p.n_stages + 2) + 16),
            eos=eos, sampling=sp)
        st.eos_hit = eos is not None and first == eos
        return st

    # ---- phase 1a: gather-entry (pure read) --------------------------
    def gather_entry(self, st: DecodeState) -> Optional[EntryInputs]:
        """The deepest tree layer as verify inputs, or None when no layer
        is pending entry.  No state change."""
        if not st.pending:
            return None
        w = self.pcfg.width
        tokens, idxs, valid, mask_rows = tree_lib.last_layer(st.tree, w)
        depths = torch.where(valid, st.tree.depth[idxs], 0)
        pmask = F.pad(mask_rows, (0, self.tree_buffer_capacity
                                  - mask_rows.shape[1]))
        node_idx = np.where(valid.numpy(), idxs.numpy(), -1).astype(np.int32)
        return EntryInputs(tokens=tokens, positions=st.model_len + depths,
                           mask=pmask, write_index=st.tree.layer_start,
                           node_idx=node_idx)

    # ---- phase 1b: apply-entry (bookkeeping from the verify logits) --
    def apply_entry(self, st: DecodeState, entry: EntryInputs,
                    v_logits: torch.Tensor, d_logits: torch.Tensor) -> None:
        """Record the entry's flight from this request's verify logits
        ([w, V] each)."""
        st.flights.append(Flight(exit_t=st.t + self.pcfg.n_stages - 1,
                                 node_idx=entry.node_idx, logits=v_logits))
        st.stats.entries += 1
        st.last_draft = (entry.node_idx.copy(), d_logits)
        st.pending = False

    # ---- phase 1c: tree expansion (may be deferred) ------------------
    def can_expand(self, tree: tree_lib.Tree) -> bool:
        """Depth-cap / buffer-capacity guard: a full layer appends
        ``width`` slots, so ``n_nodes + width`` must fit ``capacity``."""
        p = self.pcfg
        cur_depth = int(torch.where(tree.valid(), tree.depth, 0).max())
        return cur_depth < p.depth_cap and tree.n_nodes + p.width <= \
            p.capacity

    def maybe_expand(self, st: DecodeState) -> None:
        """Grow the tree by one layer from the draft's last proposal."""
        p = self.pcfg
        if st.last_draft is None or st.pending:
            return
        if not self.can_expand(st.tree):
            return  # deferred: retried next timestep once a prune frees room
        nidx, dlog = st.last_draft
        rows_valid = nidx >= 0
        if not rows_valid.any():
            return
        if hasattr(dlog, "resolve"):
            # the async executor's draft verify is a future of the draft
            # actor: expansion is the first reader of its logits
            dlog = dlog.resolve()
        # surviving rows, in (compacted) index order, line up with the
        # deepest layer's slots
        order = np.argsort(np.where(rows_valid, nidx,
                                    np.iinfo(np.int32).max))
        dlog_sorted = dlog[torch.as_tensor(order, device=dlog.device)]
        cand_tok, cand_lp = draft_candidates(
            dlog_sorted, torch.as_tensor(rows_valid[order]), p.branch)
        st.tree = tree_lib.tree_expand(st.tree, cand_tok, cand_lp, p.width)
        st.pending = True
        st.last_draft = None

    # ---- phase 2a: pick the exiting flight ---------------------------
    def exit_pick(self, st: DecodeState) -> Optional[Tuple[Flight, int]]:
        """Pop the flight exiting this timestep: (flight, root_row), or
        None when nothing exits."""
        exiting = [f for f in st.flights if f.exit_t == st.t]
        st.flights = [f for f in st.flights if f.exit_t != st.t]
        for fl in exiting:
            root_rows = np.where(fl.node_idx == 0)[0]
            if len(root_rows):
                return fl, int(root_rows[0])
        return None

    # ---- phase 2b: exit-commit (token, prune, remap) -----------------
    def exit_apply(self, st: DecodeState, fl: Flight, root_row: int, *,
                   commit_caches=None, remap_caches=None) -> int:
        """Commit the root's token, sync the caches and prune or restart
        the tree.  The cache work is delegated when the callbacks are
        given: ``commit_caches(st)`` moves tree row 0 into the model caches
        at ``st.model_len`` (two-level cache sync, 3.4.3) and
        ``remap_caches(st, index_map)`` compacts the tree caches after a
        prune; by default the request's own caches are updated.  Returns
        the number of commits (1)."""
        p = self.pcfg
        sp = st.sampling if st.sampling is not None else p.sampling
        logits = fl.logits
        if hasattr(logits, "resolve"):   # a future the exit tick resolved
            logits = logits.resolve()
        x = select_token(logits[root_row], sp, st.generator)
        st.committed.append(x)
        st.stats.commits += 1
        (commit_caches or self._commit_own_caches)(st)
        st.model_len += 1
        if st.eos is not None and x == st.eos:
            st.eos_hit = True

        hit = tree_lib.find_child_with_token(st.tree, x)
        if hit >= 0:
            st.stats.hits += 1
            st.tree, index_map = tree_lib.tree_prune_to_child(st.tree, hit)
            (remap_caches or self._remap_own_caches)(st, index_map)
            imap = index_map.numpy()
            for f2 in st.flights:
                f2.node_idx = remap_flight_indices(f2.node_idx, imap)
            if st.last_draft is not None:
                st.last_draft = (remap_flight_indices(st.last_draft[0], imap),
                                 st.last_draft[1])
        else:
            st.stats.misses += 1
            st.tree = tree_lib.tree_init(p.capacity, x)
            st.flights = []
            st.last_draft = None
            st.pending = True
        return 1

    # default cache plumbing: the request owns its caches (B = 1)
    def _commit_own_caches(self, st: DecodeState) -> None:
        st.t_cache = self.target.commit(st.t_cache, st.t_tree, 0,
                                        st.model_len)
        st.d_cache = self.draft.commit(st.d_cache, st.d_tree, 0,
                                       st.model_len)

    def _remap_own_caches(self, st: DecodeState, index_map) -> None:
        cap = self.pcfg.capacity
        st.t_tree = remap_tree_caches(st.t_tree, index_map, cap)
        st.d_tree = remap_tree_caches(st.d_tree, index_map, cap)

    def step(self, st: DecodeState) -> DecodeState:
        """Advance one pipeline timestep: gather-entry -> verify (target
        entry + draft proposal) -> expansion -> exit-commit."""
        st.t += 1
        st.stats.timesteps = st.t
        step_commits = 0
        entry = self.gather_entry(st)
        if entry is not None:
            dev = self.target.device
            tokens = entry.tokens[None].to(dev)
            positions = entry.positions[None].to(dev)
            mask = entry.mask[None].to(dev)
            v_logits, st.t_tree = self.target.tree_verify(
                tokens, positions, mask, st.t_cache, st.model_len, st.t_tree,
                entry.write_index)
            d_logits, st.d_tree = self.draft.tree_verify(
                tokens, positions, mask, st.d_cache, st.model_len, st.d_tree,
                entry.write_index)
            self.apply_entry(st, entry, v_logits[0], d_logits[0])

        self.maybe_expand(st)

        ev = self.exit_pick(st)
        if ev is not None:
            step_commits += self.exit_apply(st, *ev)
        st.stats.commits_per_step.append(step_commits)
        return st

    def generate(self, prompt: np.ndarray, max_new_tokens: int,
                 seed: int = 0, max_timesteps: Optional[int] = None, *,
                 eos: Optional[int] = None,
                 sampling: Optional[SamplingParams] = None):
        """Run one request to completion: (tokens, GenStats)."""
        st = self.init_state(prompt, max_new_tokens, seed, max_timesteps,
                             eos=eos, sampling=sampling)
        while not st.done:
            self.step(st)
        return st.output(), st.stats
