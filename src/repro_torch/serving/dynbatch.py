"""SpecPipe-DB: the continuous-batching multi-request PipeDec engine, the
port of the JAX package's ``repro/serving/dynbatch.py``.

The single-request engine (``core.pipedec``) gives the lowest latency but
leaves the pipeline idle when one task stalls; the paper's DB mode keeps
several requests' token trees in flight at once: their tree layers share
every pipeline timestep (stacked along the batch axis) and finished
requests are replaced from the queue without draining the pipeline.

The engine is the logical scheduler only; a timestep's batched compute
(fused tree verify, batched commit, batched prune remap, admission
prefill) runs through a ``serving.executor.PipelineExecutor``, by default
``LocalFusedExecutor`` over a dense ``KVArena`` (``paged=True`` for the
block-paged arena).  Each request's decisions (flight bookkeeping, token
choice with its own ``SamplingParams`` and ``torch.Generator``, tree
expand and prune, index remaps) run through the ``PipeDecEngine`` phase
methods the single-request engine uses, so each request's operation
trace is the one it would have alone.

One global timestep:
  1. refill - admit arrived requests (priority and aging order, FIFO on
     ties) onto free slots, prefilling each into its arena rows;
  2. advance - stack every pending slot's entry layer into ONE verify per
     model, then expansion per slot, ONE batched commit over the exiting
     slots and ONE batched prune remap over the pruned ones;
  3. retire - requests at eos or their token budget free their slot.

On an overlapped executor (``serving.executor.OverlappedShardedExecutor``)
the schedule is the paper's steady state: ONE ring tick per executed
timestep, whether or not an entry is pending; each flight holds a
``Deferred`` future that the tick of its exit timestep resolves;
commits and prunes ride the next tick as a ctrl message; a miss kills the
slot's in-flight layers and a retire kills them and clears its messages.
Admission prefill rides the ring's prefill lane (``begin_prefill``): the
request waits as *joining* until its prompt's last chunk exits
``n_stages - 1`` ticks after entering, and its ``DecodeState`` is seeded
from the resolved logits.

The async executor (``serving.executor.AsyncPipelineExecutor``) runs
the same overlapped schedule on free-running stage actors: a timestep
pushes its entry and ctrl into the pipe (nothing when there is nothing to
push) and a flight's future blocks until its exit arrives.  It has no
prefill lane (``prefill_cap`` 0), so a request is admitted through
``executor.prefill`` and goes active at once; admission rides the ring
only on an overlapped executor with ``prefill_cap > 0``.

``run(on_token=...)`` streams ``(uid, token, timestep)`` as tokens are
committed (the admission timestep for the prefill token); the streamed
prefix always equals the final ``Result.tokens``.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.dynbatch import TreeBatch
from repro_torch.core.pipedec import (DecodeState, EntryInputs, GenStats,
                                      PipeDecConfig, PipeDecEngine)
from repro_torch.core.speculative import ModelBundle
from repro_torch.models import transformer as tf
from repro_torch.serving.executor import LocalFusedExecutor, PipelineExecutor
from repro_torch.serving.scheduler import DynamicBatchScheduler, KVArena


@dataclasses.dataclass
class _Active:
    req: object
    state: DecodeState
    t0: float
    emitted: int = 0          # tokens already streamed through on_token


@dataclasses.dataclass
class _Joining:
    """A request whose admission prefill rides the ring's prefill lane
    (overlapped executor): its slot is taken, and once the
    ``Deferred`` prefill future resolves its ``DecodeState`` is seeded from the
    resolved logits and it goes active."""
    req: object
    seed: int
    handle: object            # executor.Deferred
    t0: float


@dataclasses.dataclass
class DBStats:
    """Aggregate statistics of one ``run()``.

    ``timesteps`` counts *executed* shared timesteps (idle gaps between
    sparse arrivals are skipped), aligned 1:1 with ``occupancy``.
    ``verify_dispatches`` traces the fused verifies per model per timestep
    (0 when no slot had a pending entry, else exactly 1).
    ``tick_dispatches`` traces the overlapped executor's ring ticks per
    timestep (exactly 1 each; empty on the other executors).
    ``accepted`` / ``proposed`` count verify decisions per uid (a hit
    accepts the drafted node).  ``separate_prefill_dispatches`` counts
    admissions prefilled by ``executor.prefill`` instead of the ring's
    prefill lane (0 on an overlapped executor with a prefill lane).
    ``page_counters`` traces the paged arena's pool counters per timestep
    (empty on a dense arena)."""
    timesteps: int = 0
    total_commits: int = 0
    per_request: Dict[int, GenStats] = dataclasses.field(default_factory=dict)
    occupancy: List[int] = dataclasses.field(default_factory=list)
    verify_dispatches: List[int] = dataclasses.field(default_factory=list)
    tick_dispatches: List[int] = dataclasses.field(default_factory=list)
    accepted: Dict[int, int] = dataclasses.field(default_factory=dict)
    proposed: Dict[int, int] = dataclasses.field(default_factory=dict)
    total_accepted: int = 0
    total_proposed: int = 0
    separate_prefill_dispatches: int = 0
    page_counters: List[Dict] = dataclasses.field(default_factory=list)

    @property
    def tokens_per_timestep(self) -> float:
        """Committed tokens per executed timestep, over all requests."""
        return self.total_commits / self.timesteps if self.timesteps else 0.0

    @property
    def peak_occupancy(self) -> int:
        """Most requests active in one timestep."""
        return max(self.occupancy) if self.occupancy else 0

    @property
    def acceptance_rate(self) -> float:
        """Aggregate accepted / proposed over every retired request."""
        return (self.total_accepted / self.total_proposed
                if self.total_proposed else 0.0)

    def acceptance_of(self, uid: int) -> float:
        """One request's accepted / proposed."""
        prop = self.proposed.get(uid, 0)
        return self.accepted.get(uid, 0) / prop if prop else 0.0

    def record_acceptance(self, uid: int, st: GenStats) -> None:
        """Fold one retired request's verify decisions into the counters."""
        self.accepted[uid] = st.hits
        self.proposed[uid] = st.hits + st.misses
        self.total_accepted += st.hits
        self.total_proposed += st.hits + st.misses


def request_seed(seed: int, uid: int) -> int:
    """The sampling seed of request ``uid`` in a run seeded with ``seed``
    (each request gets a ``torch.Generator`` of its own)."""
    return int(np.random.SeedSequence([seed, uid]).generate_state(
        1, np.uint64)[0] >> np.uint64(1))


class SpecPipeDBEngine:
    """Dynamic-batching PipeDec: submit ``Request``s, then ``run()``."""

    def __init__(self, target: ModelBundle, draft: ModelBundle,
                 pcfg: Optional[PipeDecConfig] = None, *,
                 max_len: int = 512, max_slots: int = 4,
                 eos_token: Optional[int] = None, fused: bool = True,
                 executor: Optional[PipelineExecutor] = None):
        """``executor`` selects the compute backend (default: a dense
        ``LocalFusedExecutor``); ``fused=False`` runs the looped per-slot
        reference (two tree verifies per request per timestep), which the
        fused path is held to.  Recurrent models refuse: their sub-layers
        have no tree verify (``transformer.check_tree_supported``)."""
        for bundle in (target, draft):
            tf.check_tree_supported(bundle.cfg, "SpecPipe-DB's tree verify")
        self.fused = fused
        self.pcfg = pcfg or PipeDecConfig()
        self.inner = PipeDecEngine(target, draft, self.pcfg, max_len=max_len)
        if executor is None:
            executor = LocalFusedExecutor(
                target, draft, slots=max_slots, max_len=max_len,
                tree_capacity=self.inner.tree_buffer_capacity,
                capacity=self.pcfg.capacity)
        if executor.slots != max_slots:
            raise ValueError(f"executor has {executor.slots} slots, "
                             f"max_slots is {max_slots}")
        self.executor = executor
        self.arena = executor.arena
        if not fused and not isinstance(self.arena, KVArena):
            raise ValueError("the looped (fused=False) mode needs a local "
                             "KVArena backend")
        self.overlapped = bool(getattr(executor, "overlapped", False))
        if self.overlapped:
            if not fused:
                raise ValueError("the overlapped schedule is fused")
            if executor.n_stages != self.pcfg.n_stages:
                raise ValueError(
                    f"overlapped executor: its {executor.n_stages} stages "
                    f"must equal PipeDecConfig.n_stages "
                    f"({self.pcfg.n_stages}); the ring is the flight "
                    "bookkeeping, so the fill latencies must agree")
        self.sched = DynamicBatchScheduler(self.arena)
        self.trees = TreeBatch(max_slots, self.pcfg.capacity)
        self.max_slots = max_slots
        self.eos_token = eos_token
        self.stats = DBStats()
        self.results: Dict[int, object] = {}

    def submit(self, req) -> None:
        """Queue a request (``arrival_t`` is in global timesteps; it joins
        once arrived and a slot is free, highest effective priority
        first)."""
        self.sched.submit(req)

    def _timestep_guard(self) -> int:
        # a ring prefill adds the pipeline fill between admission and the
        # first entry, plus one tick per extra chunk of a streamed prompt
        cap = getattr(self.executor, "prefill_cap", 0)

        def chunks(r):
            return max(-(-int(np.asarray(r.prompt).size) // cap), 1) - 1 \
                if cap else 0
        per_req = sum(r.max_new_tokens * (self.pcfg.n_stages + 2) + 17
                      + self.pcfg.n_stages + 1 + chunks(r)
                      for r in self.sched.queue)
        arrivals = max((getattr(r, "arrival_t", 0)
                        for r in self.sched.queue), default=0)
        return 64 + arrivals + per_req

    # -- fused phase 1: stacked entry rows ------------------------------
    def _entry_rows(self, active: Dict[int, _Active], pending: List[int]):
        """Stack every pending slot's entry layer into full-slot arrays:
        (tokens, positions, masks, model_len, write_idx, row_on,
        node_idx).  Rows of other slots are masked and write only into
        their own slot's slack region."""
        p, tcap = self.pcfg, self.inner.tree_buffer_capacity
        row_on = np.zeros((self.max_slots,), bool)
        row_on[pending] = True
        on = torch.as_tensor(row_on)

        toks_b, idx_b, valid_b, mask_b = self.trees.deepest_layers(p.width)
        valid_b = valid_b & on[:, None]
        depth_b = torch.gather(self.trees.arrays["depth"], 1, idx_b)

        mlen = np.zeros((self.max_slots,), np.int64)
        for slot in pending:
            mlen[slot] = active[slot].state.model_len
        mlen_t = torch.as_tensor(mlen)
        # padded rows of a pending layer sit at model_len (depth 0), as in
        # the single-request gather; masked-off slots sit at 0
        depths = torch.where(valid_b, depth_b, 0)
        positions = torch.where(on[:, None], mlen_t[:, None] + depths, 0)
        masks = F.pad(mask_b, (0, tcap - mask_b.shape[-1]))
        masks = masks & valid_b[:, :, None]
        tokens = torch.where(valid_b, toks_b, 0)
        # masked rows park their (never attended) writes in the slack
        # region [capacity, capacity + w) of their own tree buffer
        wi = np.where(row_on, self.trees.counters["layer_start"],
                      p.capacity)
        node_idx = np.where(valid_b.numpy(), idx_b.numpy(),
                            -1).astype(np.int32)
        return tokens, positions, masks, mlen, wi, row_on, node_idx

    def _apply_entries(self, active: Dict[int, _Active],
                       pending: List[int], rows, v_of, d_all) -> None:
        """``apply_entry`` per pending slot: ``v_of(slot)`` is its target
        verify logits, a row of the fused logits or a ``Deferred`` future
        (overlapped)."""
        tokens, positions, masks, _, wi, _, node_idx = rows
        for slot in pending:
            entry = EntryInputs(tokens=tokens[slot],
                                positions=positions[slot], mask=masks[slot],
                                write_index=int(wi[slot]),
                                node_idx=node_idx[slot])
            self.inner.apply_entry(active[slot].state, entry, v_of(slot),
                                   d_all[slot])

    def _fused_entry(self, active: Dict[int, _Active],
                     pending: List[int]) -> None:
        """ONE bucketed verify per model over the stacked entry rows, then
        ``apply_entry`` per pending slot with its rows of the logits."""
        rows = self._entry_rows(active, pending)
        tokens, positions, masks, mlen, wi, row_on, _ = rows
        v_all, d_all = self.executor.verify_rows(tokens, positions, masks,
                                                 mlen, wi, row_on)
        self._apply_entries(active, pending, rows, lambda s: v_all[s], d_all)

    # -- per-timestep phases -------------------------------------------
    def _bump(self, active: Dict[int, _Active],
              stepping: List[int]) -> List[int]:
        for slot in stepping:
            st = active[slot].state
            st.t += 1
            st.stats.timesteps = st.t
            st.tree = self.trees.get_row(slot)
        return [s for s in stepping if active[s].state.pending]

    def _pick_exits(self, active: Dict[int, _Active],
                    stepping: List[int]) -> Dict[int, tuple]:
        picks = {}
        for slot in stepping:
            ev = self.inner.exit_pick(active[slot].state)
            if ev is not None:
                picks[slot] = ev
        return picks

    def _commit_exits(self, active: Dict[int, _Active], picks) -> None:
        """ONE batched two-level cache sync over every exiting slot."""
        if not picks:
            return
        mask_rows = np.zeros((self.max_slots,), bool)
        mlen_rows = np.zeros((self.max_slots,), np.int32)
        for slot in picks:
            mask_rows[slot] = True
            mlen_rows[slot] = active[slot].state.model_len
        self.executor.commit_rows(mlen_rows, mask_rows)

    def _apply_exits(self, active: Dict[int, _Active], stepping: List[int],
                     picks, *, kill_stale: bool = False) -> None:
        """Per-slot exit bookkeeping (token, prune, flight remap), then ONE
        batched prune remap over every pruned slot (identity rows for the
        rest).  With ``kill_stale`` (overlapped) a miss also kills the
        slot's in-flight ring layers: the pruning-propagation stage."""
        remaps: Dict[int, np.ndarray] = {}
        for slot in stepping:
            st = active[slot].state
            commits = 0
            if slot in picks:
                fl, root_row = picks[slot]
                misses0 = st.stats.misses
                commits = self.inner.exit_apply(
                    st, fl, root_row,
                    commit_caches=lambda _st: None,   # batched above
                    remap_caches=lambda _st, imap, s=slot:
                        remaps.__setitem__(s, imap))
                if kill_stale and st.stats.misses > misses0:
                    self.executor.kill(slot)
            st.stats.commits_per_step.append(commits)
            self.trees.set_row(slot, st.tree)
            st.tree = None
        if remaps:
            imaps = np.tile(np.arange(self.pcfg.capacity, dtype=np.int32),
                            (self.max_slots, 1))
            row_mask = np.zeros((self.max_slots,), bool)
            for slot, imap in remaps.items():
                imaps[slot] = np.asarray(imap, np.int32)
                row_mask[slot] = True
            self.executor.remap_rows(imaps, row_mask)

    def _advance_fused(self, active: Dict[int, _Active],
                       stepping: List[int]) -> None:
        """One shared timestep: stacked entries -> ONE fused verify per
        model -> per-slot expansion -> batched commit -> batched remap."""
        pending = self._bump(active, stepping)
        if pending:
            self._fused_entry(active, pending)
        self.stats.verify_dispatches.append(1 if pending else 0)
        for slot in stepping:
            self.inner.maybe_expand(active[slot].state)
        picks = self._pick_exits(active, stepping)
        self._commit_exits(active, picks)
        self._apply_exits(active, stepping, picks)

    def _advance_overlapped(self, active: Dict[int, _Active],
                            stepping: List[int]) -> None:
        """One steady-state timestep: ONE ring tick takes the entry of
        timestep t in and gives the exit of t - (n_stages - 1) out.  The
        tick runs whether or not anything enters (the in-flight layers
        must advance); entering slots get ``Deferred`` futures, and
        the flights exiting now hold futures this tick resolved.  Commits
        and prune maps ride the next tick's ctrl; a miss kills."""
        pending = self._bump(active, stepping)
        if pending:
            rows = self._entry_rows(active, pending)
        else:
            rows = (*self.executor.dead_entry,
                    np.zeros((self.max_slots,), bool), None)
        tokens, positions, masks, mlen, wi, row_on, _ = rows
        d_all, handles = self.executor.tick_rows(tokens, positions, masks,
                                                 mlen, wi, row_on)
        self.stats.verify_dispatches.append(1 if pending else 0)
        self.stats.tick_dispatches.append(1)
        self._apply_entries(active, pending, rows, lambda s: handles[s],
                            d_all)
        for slot in stepping:
            self.inner.maybe_expand(active[slot].state)
        picks = self._pick_exits(active, stepping)
        self._commit_exits(active, picks)
        self._apply_exits(active, stepping, picks, kill_stale=True)

    def _advance_looped(self, active: Dict[int, _Active],
                        stepping: List[int]) -> None:
        """The looped reference: each request steps alone on its own
        slot's caches."""
        for slot in stepping:
            st = active[slot].state
            st.tree = self.trees.get_row(slot)
            self.inner.step(st)
            self.trees.set_row(slot, st.tree)
            st.tree = None

    def _stream(self, active: Dict[int, _Active], now: int,
                on_token: Optional[Callable]) -> None:
        """Emit every committed token not yet streamed (up to the token
        budget) as ``on_token(uid, token, timestep)``."""
        if on_token is None:
            return
        for a in active.values():
            limit = 1 + a.state.max_new_tokens
            fresh = a.state.committed[a.emitted:limit]
            for tok in fresh:
                on_token(a.req.uid, int(tok), now)
            a.emitted += len(fresh)

    # ------------------------------------------------------------------
    def steps(self, seed: int = 0,
              on_token: Optional[Callable] = None) -> Iterator[int]:
        """Drive the shared schedule until the queue and the slots drain,
        yielding the global timestep after each executed timestep; the
        results collect in ``self.results`` ({uid: Result}).  ``run`` is
        this loop run to its end; a profiler steps it."""
        from repro_torch.serving.engine import Result

        self.stats = DBStats()  # per-run aggregates
        self.results = {}
        results = self.results
        active: Dict[int, _Active] = {}
        joining: Dict[int, _Joining] = {}
        ring_prefill = self.overlapped and \
            getattr(self.executor, "prefill_cap", 0) > 0
        guard = self._timestep_guard()
        now = 0
        while self.sched.pending or active or joining:
            if not active and not joining:
                # pipeline drained: skip to the next arrival
                nxt = self.sched.next_arrival()
                if nxt is not None and nxt > now:
                    now = nxt

            # 0. join: requests whose ring prefill resolved go active,
            # seeded from the resolved logits
            for slot in [s for s in sorted(joining)
                         if joining[s].handle.ready]:
                j = joining.pop(slot)
                st = self.inner.init_state(
                    j.req.prompt, j.req.max_new_tokens, seed=j.seed,
                    eos=self.eos_token,
                    sampling=getattr(j.req, "sampling", None),
                    prefill_fn=lambda _p, h=j.handle: h.resolve())
                self.trees.adopt_row(slot, st.tree)
                st.tree = None
                active[slot] = _Active(j.req, st, j.t0)

            # 1. refill: join-on-prefill of arrived requests (on an
            # overlapped executor with a prefill lane the prompt enters it
            # with the next tick and the request waits as joining)
            for req, slot in self.sched.admit(now):
                kw = dict(seed=request_seed(seed, req.uid),
                          eos=self.eos_token,
                          sampling=getattr(req, "sampling", None))
                if ring_prefill:
                    h = self.executor.begin_prefill(slot, req.prompt)
                    if h is not None:
                        joining[slot] = _Joining(req, kw["seed"], h,
                                                 time.perf_counter())
                        continue
                if self.fused:
                    self.stats.separate_prefill_dispatches += 1
                    st = self.inner.init_state(
                        req.prompt, req.max_new_tokens,
                        prefill_fn=functools.partial(self.executor.prefill,
                                                     slot), **kw)
                else:
                    st = self.inner.init_state(
                        req.prompt, req.max_new_tokens,
                        caches=self.arena.caches(slot), **kw)
                self.trees.adopt_row(slot, st.tree)
                st.tree = None  # the TreeBatch holds the canonical copy
                active[slot] = _Active(req, st, time.perf_counter())
            self._stream(active, now, on_token)   # prefill (first) tokens

            # 2. advance: every active request shares this timestep
            now += 1
            self.stats.timesteps += 1
            stepping = [s for s in sorted(active)
                        if not active[s].state.done]
            if self.overlapped:
                self._advance_overlapped(active, stepping)
            elif self.fused:
                self._advance_fused(active, stepping)
            else:
                self._advance_looped(active, stepping)
            self._stream(active, now, on_token)

            # 3. retire: free slots for the next refill
            for slot in [s for s, a in active.items() if a.state.done]:
                a = active.pop(slot)
                st = a.state
                results[a.req.uid] = Result(
                    a.req.uid, st.output(), time.perf_counter() - a.t0,
                    st.stats)
                self.stats.per_request[a.req.uid] = st.stats
                self.stats.total_commits += st.stats.commits
                self.stats.record_acceptance(a.req.uid, st.stats)
                self.trees.release_row(slot)
                if self.overlapped:
                    # the slot is recycled: kill its in-flight layers and
                    # drop its queued and riding ctrl
                    self.executor.kill(slot, drop_ctrl=True)
                self.sched.retire(a.req.uid, slot, now,
                                  caches=None if self.fused else st.caches())

            occ = len(active)
            self.stats.occupancy.append(occ)
            self.sched.stats.occupancy.append(occ)
            pages = getattr(self.arena, "pages", None)
            if pages is not None:
                self.stats.page_counters.append(pages.counters())
            if now > guard:
                raise RuntimeError(
                    f"SpecPipeDBEngine exceeded its timestep guard ({guard});"
                    f" {len(active)} active, {self.sched.pending} queued")
            yield now
        if self.overlapped:
            # every live flight resolved in the run (retires killed the
            # rest): this leaves the ring clean for the next run
            self.executor.drain()

    def run(self, seed: int = 0, on_token: Optional[Callable] = None):
        """Serve every submitted request; returns {uid: Result}.
        ``on_token(uid, token, timestep)`` streams tokens as they are
        committed; ``seed`` seeds each request's sampling generator."""
        for _ in self.steps(seed, on_token):
            pass
        return self.results


def generate_with_executor(target: ModelBundle, draft: ModelBundle,
                           pcfg: PipeDecConfig, prompt, max_new_tokens: int,
                           *, executor: Optional[PipelineExecutor] = None,
                           max_len: int = 512, eos: Optional[int] = None,
                           seed: int = 0, sampling=None):
    """The B = 1 PipeDec path on an executor: one request through a
    single-slot ``SpecPipeDBEngine``; greedy tokens equal
    ``PipeDecEngine.generate``'s.  Returns (tokens, GenStats)."""
    from repro_torch.serving.engine import Request

    eng = SpecPipeDBEngine(target, draft, pcfg, max_len=max_len,
                           max_slots=1, eos_token=eos, executor=executor)
    eng.submit(Request(0, np.asarray(prompt), max_new_tokens,
                       sampling=sampling))
    res = eng.run(seed=seed)[0]
    return res.tokens, res.stats
