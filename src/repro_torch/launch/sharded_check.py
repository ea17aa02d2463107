"""Equivalence check of the pipelined SpecPipe-DB executors, as a runnable:
the port of the JAX package's ``repro/launch/sharded_check.py``.

    PYTHONPATH=src python -m repro_torch.launch.sharded_check --stages 8 \
        [--overlap] [--async] [--quant] [--paged [--page-size 16]] \
        [--device cpu]

On a tiny target (d 64, 4 heads / 2 KV, ff 128, vocab 128, one layer per
stage unless ``--layers``) and draft (d 32, one layer, tied), the greedy
tokens of ``SpecPipeDBEngine`` must equal the single-request
``PipeDecEngine``'s for every request (staggered arrivals, more requests
than slots) on every executor: ``LocalFusedExecutor`` and
``ShardedPipelineExecutor`` (one flush of the ring per timestep, checked
to be exactly one per timestep with entries), and:

  * ``--overlap``: ``OverlappedShardedExecutor`` (one ring tick per
    executed timestep, deferred exit logits, commits and prunes riding the
    ring, admission in the ring's prefill lane) on three workloads: an
    independent draft (misses: kills with layers in flight), a self-draft
    (every commit a hit, so prune maps ride every stage) and long prompts
    (every prompt longer than the 64-token lane, ``PREFILL_LANE``, so
    admission streams in chunks); one tick per timestep, no separate
    prefill, a ctrl gate that closes on some ticks; a slot-recycle
    scenario (a retired occupant's ctrl must not leak into the next
    occupant's caches); and a tick-level pruning-propagation scenario: a
    slot killed with layers in flight writes nothing more into its stage
    tree caches, its stale exits come out dead, and the other slot is
    untouched;
  * ``--async``: ``AsyncPipelineExecutor`` (free-running stage actors and
    a draft actor) on the same workloads, with one stage step per entry
    per stage, a drained pipe, one separate prefill per admission, and
    the async scenarios: kill latency (a paused entry killed before the
    actors resume dies at stage 0), fail loudly (an injected stage fault
    reaches the host as ``AsyncExecutorError`` within the timeout), clean
    shutdown (every actor thread joined, twice, and a repeat run gives
    the same tokens) and slot recycle;
  * ``--quant``: the workloads again on ``ModelBundle.quantize()``
    bundles, held bit for bit to the int8 single-request engine, plus
    statistical gates against fp32: the acceptance rate moves by at most
    ``QUANT_ACCEPTANCE_TOL``, an int8 arena costs at most
    ``QUANT_BYTES_RATIO_MAX`` of the fp32 bytes per slot, so an equal
    budget admits at least ``QUANT_SLOTS_MULT_MIN`` x the slots, and the
    int8 self-draft keeps its perfect acceptance;
  * ``--paged``: every executor on block-paged arenas (``--page-size``
    rows per block); ``--async`` has no paged path and refuses it.

The port has one process and one card: the stages share the device (the
async actors one CUDA stream each), so no device count is set.  It runs on
the card unless ``--device cpu``.  Prints one JSON summary line, then
``SHARDED_CHECK ok stages=...``; on any mismatch it prints ``SHARDED_CHECK
fail ...`` and exits 1.
"""
from __future__ import annotations

import argparse
import json
import sys
import threading
import time
import traceback

import numpy as np
import torch

from repro_torch.core.pipedec import PipeDecConfig, PipeDecEngine
from repro_torch.core.speculative import ModelBundle
from repro_torch.device import resolve_device
from repro_torch.launch import pipeline as pl
from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig
from repro_torch.serving import (AsyncExecutorError, AsyncPipelineExecutor,
                                 LocalFusedExecutor,
                                 OverlappedShardedExecutor, Request,
                                 ShardedPipelineExecutor, SpecPipeDBEngine)
from repro_torch.serving.executor import PREFILL_LANE
from repro_torch.serving.scheduler import KVArena

# int8 gates (the reference's constants)
QUANT_ACCEPTANCE_TOL = 0.15     # |acc(int8) - acc(fp32)| on the workload
QUANT_BYTES_RATIO_MAX = 0.55    # int8 arena bytes / fp32 arena bytes
QUANT_SLOTS_MULT_MIN = 1.9      # slots admitted at an equal byte budget
ASYNC_TIMEOUT_S = 60.0          # every blocking wait of the async pipe
MAX_LEN = 160


def _pruning_propagation_scenario(stages: int, device) -> dict:
    """Tick-level check of the in-ring kill on the ``stages``-stage ring:
    two slots, slot 0 killed at tick ``kill_at`` while its layers ride."""
    cfg = ModelConfig(name="pp-chk", family="dense", num_layers=stages,
                      d_model=32, num_heads=2, num_kv_heads=1, d_ff=64,
                      vocab_size=64)
    model = tf.init_model(cfg, seed=3, device=device)
    w, kill_at = 4, 2
    ticks = stages + 2
    cap = 1 + w * (ticks + 1)
    pcfg = pl.PipelineConfig(n_stages=stages, width=w, tree_capacity=cap,
                             max_len=32)
    sp, valid = pl.stage_params(model, stages)
    committed = 4           # zero rows of the model cache every node sees

    def entry(t, slot0_on):
        gen = torch.Generator().manual_seed(100 + t)
        wi = 1 + t * w
        mask = torch.zeros((w, cap + w), dtype=torch.bool)
        mask[torch.arange(w), wi + torch.arange(w)] = True
        return {
            "act": torch.randn((2, w, cfg.d_model), generator=gen).to(device),
            "positions": (committed + torch.arange(w)).expand(2, w).to(
                device),
            "mask": mask.expand(2, w, cap + w).to(device),
            "model_len": torch.full((2,), committed, dtype=torch.int32,
                                    device=device),
            "write_idx": np.full((2,), wi), "valid": np.array([slot0_on,
                                                              True]),
            "version": np.zeros((2,), np.int64)}

    tick = pl.make_pipedec_tick(cfg, pcfg)

    def run(with_kill: bool):
        model_kv, tree_kv = pl.init_stage_caches(cfg, pcfg, batch=2,
                                                 device=device)
        ring = pl.init_ring(pcfg, 2)
        states, exits = [], []
        for t in range(ticks):
            killed = with_kill and t >= kill_at
            kill = np.array([with_kill and t == kill_at, False])
            ring, ex = tick(sp, valid, model_kv, tree_kv, ring,
                            entry(t, not killed), kill)
            states.append([{k: v.cpu().clone() for k, v in c.items()}
                           for st in tree_kv for c in st if c is not None])
            act = None if ex["act"] is None else ex["act"].cpu().clone()
            exits.append((ex["valid"].copy(), act))
        return states, exits

    states_a, exits_a = run(False)
    states_b, exits_b = run(True)

    def slot(state, b):
        return [v[b] for c in state for v in c.values()]

    def same(x, y):
        return all(torch.equal(a, b) for a, b in zip(x, y))

    # (1) the killed slot's rows are untouched after the kill tick...
    for t in range(kill_at, ticks):
        assert same(slot(states_b[t], 0), slot(states_b[kill_at - 1], 0)), \
            f"killed slot written at tick {t}"
    # ...whereas without the kill the same layers kept writing
    assert not same(slot(states_a[-1], 0), slot(states_b[-1], 0)), \
        "the control run must show the writes the kill suppressed"
    # (2) the other slot is unaffected, every tick
    for t in range(ticks):
        assert same(slot(states_b[t], 1), slot(states_a[t], 1)), \
            f"other slot changed by the kill at tick {t}"
    # (3) stale slot-0 exits are dead; slot 1's exits are the same
    saw_dead = saw_live = False
    for t in range(ticks):
        (va, aa), (vb, ab) = exits_a[t], exits_b[t]
        assert bool(va[1]) == bool(vb[1])
        if va[1]:
            assert torch.equal(ab[1], aa[1]), f"slot 1 exit at tick {t}"
            saw_live = True
        if t >= stages - 1:
            assert bool(va[0]), "control run: slot-0 layers must exit live"
        if t >= max(stages - 1, kill_at):
            assert not bool(vb[0]), "stale slot-0 exit must be dead"
            saw_dead = True
    assert saw_dead and saw_live
    return {"killed_rows_untouched": True, "other_slot_unaffected": True,
            "stale_exits_dropped": True, "live_exits_match": True,
            "ticks": ticks, "kill_at": kill_at}


def main(argv=None) -> int:
    """Run every workload on every executor the flags ask for, plus the
    scenarios; print the JSON summary and the ``SHARDED_CHECK`` line.
    Returns the exit code (0 ok, 1 fail)."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.sharded_check")
    ap.add_argument("--stages", type=int, default=8)
    ap.add_argument("--slots", type=int, default=3)
    ap.add_argument("--requests", type=int, default=5)
    ap.add_argument("--layers", type=int, default=0,
                    help="target layers (default: one per stage)")
    ap.add_argument("--overlap", action="store_true",
                    help="also check the overlapped ring (one tick per "
                         "timestep; PipeDecConfig.n_stages is then "
                         "--stages)")
    ap.add_argument("--async", dest="use_async", action="store_true",
                    help="also check the async executor (free-running "
                         "stage actors and a draft actor) and its "
                         "kill-latency, fail-loudly, shutdown and "
                         "slot-recycle scenarios")
    ap.add_argument("--quant", action="store_true",
                    help="also run the workloads on int8 bundles, with the "
                         "acceptance, arena-bytes and self-draft gates")
    ap.add_argument("--paged", action="store_true",
                    help="every executor on block-paged arenas")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)
    if args.use_async and args.paged:
        ap.error("--async has no paged path: drop one of --async/--paged")
    dev = resolve_device(args.device)

    layers = args.layers or args.stages
    target_cfg = ModelConfig(name="chk-target", family="dense",
                             num_layers=layers, d_model=64, num_heads=4,
                             num_kv_heads=2, d_ff=128, vocab_size=128)
    draft_cfg = ModelConfig(name="chk-draft", family="dense", num_layers=1,
                            d_model=32, num_heads=2, num_kv_heads=1,
                            d_ff=64, vocab_size=128, tie_embeddings=True)
    target = ModelBundle(tf.init_model(target_cfg, seed=0, device=dev))
    draft = ModelBundle(tf.init_model(draft_cfg, seed=9, device=dev))
    # the overlapped ring and the async actor chain are the flight
    # bookkeeping, so PipeDecConfig.n_stages must be their stage count
    n_stages = args.stages if (args.overlap or args.use_async) else 4
    pcfg = PipeDecConfig(n_stages=n_stages, width=4, branch=2)
    rng = np.random.default_rng(0)

    def mk_reqs(lo_new, hi_new):
        return [Request(i, rng.integers(0, 100, size=int(rng.integers(3, 8))),
                        int(rng.integers(lo_new, hi_new)),
                        arrival_t=int(rng.integers(0, 3 * args.requests)))
                for i in range(args.requests)]

    common = dict(slots=args.slots, max_len=MAX_LEN,
                  tree_capacity=pcfg.tree_buffer_capacity,
                  capacity=pcfg.capacity)
    ring = dict(common, n_stages=args.stages, paged=args.paged,
                page=args.page_size)
    mk = {
        "local": lambda t, d: LocalFusedExecutor(
            t, d, paged=args.paged, page=args.page_size, **common),
        "sharded": lambda t, d: ShardedPipelineExecutor(t, d, **ring),
    }
    if args.overlap:
        mk["sharded_overlapped"] = lambda t, d: OverlappedShardedExecutor(
            t, d, **ring)
    if args.use_async:
        mk["sharded_async"] = lambda t, d: AsyncPipelineExecutor(
            t, d, n_stages=args.stages, timeout_s=ASYNC_TIMEOUT_S, **common)

    def check_workload(tgt, drf, reqs):
        single = PipeDecEngine(tgt, drf, pcfg, max_len=MAX_LEN)
        want, acc = {}, {}
        for r in reqs:
            want[r.uid], st = single.generate(r.prompt, r.max_new_tokens)
            acc[r.uid] = st.acceptance
        part = {"acceptance_mean": float(np.mean(list(acc.values())))}
        for name, make in mk.items():
            ex = make(tgt, drf)
            eng = SpecPipeDBEngine(tgt, drf, pcfg, max_len=MAX_LEN,
                                   max_slots=args.slots, executor=ex)
            before = {id(m): dict(m.calls) for m in (tgt, drf)}
            for r in reqs:
                eng.submit(r)
            res = eng.run()
            for uid, tokens in want.items():
                np.testing.assert_array_equal(
                    res[uid].tokens, tokens,
                    err_msg=f"{name} executor vs single-request uid={uid}")
            disp = eng.stats.verify_dispatches
            assert max(disp) == 1, f"{name}: >1 dispatch in one timestep"
            assert ex.calls["verify_rows"] == sum(disp), \
                f"{name}: one batched dispatch per pending timestep"
            for r in reqs:
                st = res[r.uid].stats
                assert eng.stats.accepted[r.uid] == st.hits, \
                    f"{name}: DBStats.accepted mismatch uid={r.uid}"
                assert eng.stats.proposed[r.uid] == st.hits + st.misses, \
                    f"{name}: DBStats.proposed mismatch uid={r.uid}"
            part[name] = {
                "timesteps": eng.stats.timesteps,
                "tokens_per_timestep": eng.stats.tokens_per_timestep,
                "peak_occupancy": eng.stats.peak_occupancy,
                "acceptance_rate": eng.stats.acceptance_rate,
                "dispatches": dict(ex.calls)}
            if name == "sharded":
                assert ex.calls["pipeline_verify"] == sum(disp), \
                    "one batched flush per pending timestep"
            if name == "sharded_overlapped":
                assert ex.calls["pipeline_tick"] == eng.stats.timesteps, \
                    "overlapped: one ring tick per executed timestep"
                assert eng.stats.tick_dispatches == \
                    [1] * eng.stats.timesteps
                assert ex.calls["drain_tick"] == 0, \
                    "per-timestep ticks must resolve every live flight"
                assert ex.calls["prefill_in_ring"] == len(reqs), \
                    "every admission must prefill in the ring"
                assert eng.stats.separate_prefill_dispatches == 0, \
                    "overlapped: no separate prefill at any prompt length"
                for m in (tgt, drf):
                    assert m.calls["prefill"] == \
                        before[id(m)].get("prefill", 0), \
                        "overlapped: no separate ModelBundle prefill"
                rate = ex.calls["ctrl_active_ticks"] / \
                    max(ex.calls["pipeline_tick"], 1)
                assert rate < 1.0, "the ctrl gate must close on some ticks"
                part[name]["ctrl_active_rate"] = rate
            if name == "sharded_async":
                assert ex.calls["stage_steps"] == \
                    ex.calls["entry_msgs"] * args.stages, \
                    "async: one stage step per entry per stage"
                assert ex._consumed == ex._pushed, \
                    "async: the drained pipe must consume every message"
                # one separate prefill per model per admission (a
                # self-draft bundle counts both roles)
                per_model = len(reqs) * (2 if tgt is drf else 1)
                for m in {id(tgt): tgt, id(drf): drf}.values():
                    assert m.calls["prefill"] - \
                        before[id(m)].get("prefill", 0) == per_model, \
                        "async: one separate prefill per admission"
                ctr = ex.counters()
                part[name]["max_draft_lead"] = ctr["max_draft_lead"]
                part[name]["max_inbox_depth"] = max(
                    s["max_depth"] for s in ctr["stages"])
                part[name]["stale_rows"] = sum(
                    s["stale_rows"] for s in ctr["stages"])
                ex.shutdown()
                assert not [t for t in threading.enumerate()
                            if t.name.startswith("async-")], \
                    "async: shutdown must join every actor thread"
        return part

    def recycle_requests():
        # A: a tiny prompt and two tokens, retiring with its last commits
        # still riding; B: the same slot next, with a prompt longer than
        # the prefill lane, whose low rows those commits would overwrite
        a = Request(0, np.arange(1, 4), 2, arrival_t=0)
        b = Request(1, np.arange(5, 5 + PREFILL_LANE + 36) % 100, 4,
                    arrival_t=1)
        single = PipeDecEngine(target, target, pcfg, max_len=MAX_LEN)
        want = {r.uid: single.generate(r.prompt, r.max_new_tokens)[0]
                for r in (a, b)}
        return (a, b), want

    def check_recycle(ex, label):
        """A retired occupant's in-flight ctrl must not leak into the
        recycled slot's next occupant."""
        reqs, want = recycle_requests()
        eng = SpecPipeDBEngine(target, target, pcfg, max_len=MAX_LEN,
                               max_slots=1, executor=ex)
        for r in reqs:
            eng.submit(r)
        res = eng.run()
        for uid, tokens in want.items():
            np.testing.assert_array_equal(
                res[uid].tokens, tokens,
                err_msg=f"{label} slot-recycle ctrl leak uid={uid}")
        kills = int(ex.calls["kill"])
        assert kills >= 2, "both retires must kill in-flight state"
        return {"bit_identical": True, "kills": kills}

    def one_slot(cls, **kw):
        return cls(target, target, **dict(common, slots=1, **kw))

    def check_async_kill_latency():
        """A paused entry killed before the actors resume dies at stage
        0: stopped before one hop, where the lockstep ring lets a stale
        layer ride ``n_stages - 1`` more hops."""
        ex = mk["sharded_async"](target, draft)
        try:
            ex.pause()
            row_on = np.zeros(args.slots, bool)
            row_on[0] = True
            _d, handles = ex.tick_rows(*ex.dead_entry, row_on)
            ex.kill(0)
            ex.resume()
            ex.drain()
            ctr = ex.counters()
            stale0 = ctr["stages"][0]["stale_rows"]
            assert stale0 >= 1, "the kill must beat the paused layer to " \
                "stage 0"
            assert all(s["stale_rows"] >= 1 for s in ctr["stages"])
            assert handles[0].dead, "the flight's future must be dead"
            assert ex.calls["stale_exits"] >= 1, \
                "the stale exit must be dropped, not delivered"
        finally:
            ex.shutdown()
        return {"stale_at_stage0": int(stale0),
                "revolution_hops_saved": args.stages - 1}

    def check_async_failfast():
        """An injected stage fault reaches the host as
        ``AsyncExecutorError`` carrying the original traceback, well
        inside the timeout."""
        ex = mk["sharded_async"](target, draft)

        def boom(*a, **k):
            raise RuntimeError("injected stage fault")

        ex._apply = boom
        row_on = np.zeros(args.slots, bool)
        row_on[0] = True
        t0 = time.monotonic()
        try:
            ex.tick_rows(*ex.dead_entry, row_on)
            ex.drain()
        except AsyncExecutorError as e:
            elapsed = time.monotonic() - t0
            assert "injected stage fault" in str(e), \
                "the original traceback must ride the host-side error"
            assert elapsed < ex.timeout_s, "must fail fast, not time out"
        else:
            raise AssertionError(
                "a stage fault must surface as AsyncExecutorError")
        finally:
            ex.shutdown()
        return {"propagates": True, "seconds": elapsed}

    def check_async_shutdown(reqs):
        """``shutdown()`` joins every actor (none leaked), twice, and a
        fresh executor repeating the workload gives the same tokens."""
        def run_once():
            ex = mk["sharded_async"](target, draft)
            eng = SpecPipeDBEngine(target, draft, pcfg, max_len=MAX_LEN,
                                   max_slots=args.slots, executor=ex)
            for r in reqs:
                eng.submit(r)
            res = eng.run()
            ex.shutdown()
            ex.shutdown()    # idempotent
            return {u: res[u].tokens for u in res}

        a, b = run_once(), run_once()
        leaked = [t.name for t in threading.enumerate()
                  if t.name.startswith("async-")]
        assert not leaked, f"leaked actor threads: {leaked}"
        for u in a:
            np.testing.assert_array_equal(a[u], b[u],
                                          err_msg=f"async repeat uid={u}")
        return {"deterministic": True, "no_leaked_threads": True}

    def check_quant_arena():
        """The int8 arena's bytes per slot against fp32's (shapes on the
        meta device: nothing is allocated)."""
        def bps(t, d):
            return KVArena(t, d, slots=1, max_len=MAX_LEN,
                           tree_capacity=pcfg.tree_buffer_capacity
                           ).bytes_per_slot()

        fp32_b = bps(target, draft)
        int8_b = bps(target.quantize(), draft.quantize())
        ratio = int8_b / fp32_b
        mult = fp32_b // int8_b if int8_b else 0
        assert ratio <= QUANT_BYTES_RATIO_MAX, \
            f"int8 arena ratio {ratio:.3f} > {QUANT_BYTES_RATIO_MAX}"
        assert mult >= QUANT_SLOTS_MULT_MIN, \
            f"int8 slots multiplier {mult} < {QUANT_SLOTS_MULT_MIN}"
        return {"fp32": fp32_b, "int8": int8_b, "ratio": ratio,
                "slots_multiplier": int(mult)}

    summary = {"stages": args.stages, "slots": args.slots,
               "requests": args.requests, "layers": layers,
               "overlap": args.overlap, "async": args.use_async,
               "quant": args.quant, "paged": args.paged,
               "page_size": args.page_size, "prefill_lane": PREFILL_LANE,
               "device": str(dev)}
    try:
        reqs_main = mk_reqs(3, 7)
        summary["independent_draft"] = check_workload(target, draft,
                                                      reqs_main)
        if args.quant:
            q_target, q_draft = target.quantize(), draft.quantize()
            q = summary["quant_int8"] = check_workload(q_target, q_draft,
                                                       reqs_main)
            delta = abs(q["acceptance_mean"]
                        - summary["independent_draft"]["acceptance_mean"])
            assert delta <= QUANT_ACCEPTANCE_TOL, \
                f"int8 acceptance delta {delta:.4f} > {QUANT_ACCEPTANCE_TOL}"
            q["acceptance_delta_vs_fp32"] = delta
            q["arena_bytes_per_slot"] = check_quant_arena()
            if args.overlap:
                # draft == target: quantization noise hits both alike
                qsd = check_workload(q_target, q_target, mk_reqs(8, 14))
                assert qsd["acceptance_mean"] > 0.99, \
                    "int8 self-draft must keep its perfect acceptance"
                summary["quant_self_draft"] = qsd
        if args.overlap:
            summary["self_draft"] = check_workload(target, target,
                                                   mk_reqs(8, 14))
            # every prompt longer than the lane: admission streams
            long_reqs = [
                Request(i, rng.integers(0, 100, size=int(rng.integers(
                    PREFILL_LANE + 4, 2 * PREFILL_LANE + 9))),
                    int(rng.integers(3, 6)),
                    arrival_t=int(rng.integers(0, args.requests)))
                for i in range(args.requests)]
            summary["long_prompt"] = check_workload(target, draft,
                                                    long_reqs)
            lp = summary["long_prompt"]["sharded_overlapped"]["dispatches"]
            assert lp["prefill_chunks"] > args.requests, \
                "the long-prompt workload must chunk its prefills"
            summary["slot_recycle"] = check_recycle(
                one_slot(OverlappedShardedExecutor, n_stages=args.stages,
                         paged=args.paged, page=args.page_size),
                "overlapped")
            assert summary["self_draft"]["acceptance_mean"] > 0.99
            assert summary["self_draft"]["sharded_overlapped"][
                "dispatches"].get("remap_rows", 0) > 0, \
                "the self-draft workload must prune in the ring"
            summary["pruning_propagation"] = \
                _pruning_propagation_scenario(args.stages, dev)
        if args.use_async:
            asy = summary["independent_draft"]["sharded_async"]
            assert asy["dispatches"].get("kill", 0) > 0, \
                "the miss-heavy workload must kill in-flight async layers"
            summary["async_kill_latency"] = check_async_kill_latency()
            summary["async_failfast"] = check_async_failfast()
            summary["async_shutdown"] = check_async_shutdown(reqs_main)
            ex = one_slot(AsyncPipelineExecutor, n_stages=args.stages,
                          timeout_s=ASYNC_TIMEOUT_S)
            try:
                summary["async_slot_recycle"] = check_recycle(ex, "async")
            finally:
                ex.shutdown()
    except Exception as e:   # one loud line and exit 1, never exit 0
        traceback.print_exc(file=sys.stderr)
        reason = str(e).splitlines()[0][:200] if str(e) else ""
        print(f"SHARDED_CHECK fail stages={args.stages} "
              f"slots={args.slots} requests={args.requests} "
              f"overlap={int(args.overlap)} quant={int(args.quant)} "
              f"paged={int(args.paged)} async={int(args.use_async)} "
              f"error={type(e).__name__}: {reason}", flush=True)
        return 1
    summary["bit_identical"] = True
    print(json.dumps(summary))
    parts = [f"SHARDED_CHECK ok stages={args.stages}",
             f"slots={args.slots}", f"requests={args.requests}",
             f"overlap={int(args.overlap)}", f"quant={int(args.quant)}",
             f"paged={int(args.paged)}", f"async={int(args.use_async)}",
             "bit_identical=1"]
    if args.paged:
        parts.append(f"page_size={args.page_size}")
    if args.use_async:
        asy = summary["independent_draft"]["sharded_async"]
        parts += [f"async_kills={asy['dispatches']['kill']}",
                  "async_stale_at_stage0="
                  f"{summary['async_kill_latency']['stale_at_stage0']}",
                  f"async_max_draft_lead={asy['max_draft_lead']}"]
    if args.overlap:
        over = summary["independent_draft"]["sharded_overlapped"]
        lp = summary["long_prompt"]["sharded_overlapped"]
        parts += [
            "ticks_per_timestep="
            f"{over['dispatches']['pipeline_tick'] / over['timesteps']:.2f}",
            f"ctrl_active_rate={over['ctrl_active_rate']:.4f}",
            f"prefill_in_ring={over['dispatches']['prefill_in_ring']}",
            f"prefill_chunks_long={lp['dispatches']['prefill_chunks']}"]
    if args.quant:
        q = summary["quant_int8"]
        arena = q["arena_bytes_per_slot"]
        parts += [
            f"quant_acceptance_delta={q['acceptance_delta_vs_fp32']:.4f}",
            f"quant_arena_ratio={arena['ratio']:.4f}",
            f"quant_slots_multiplier={arena['slots_multiplier']}"]
    print(" ".join(parts), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
