"""The port's ``AsyncPipelineExecutor`` (free-running stage actors and a
disaggregated draft actor) on the CPU, against the port's flush ring, the
single-request ``PipeDecEngine`` and the JAX package's async executor on
bridged weights: the counterparts of the JAX async pins
(``tests/test_executor_sharded.py``).

Tokens and ``GenStats`` are held exactly: the actors apply the same stage
functions to the same rows in the lockstep schedule's order.  Every
blocking wait of the pipe is bounded by ``TIMEOUT_S``, so an actor bug
fails a test instead of stalling the run.
"""
import dataclasses
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.pipedec import PipeDecConfig as JaxPipeDecConfig
from repro.core.speculative import ModelBundle as JaxBundle
from repro.models.config import ModelConfig as JaxModelConfig
from repro.serving import AsyncPipelineExecutor as JaxAsyncPipelineExecutor
from repro.serving import Request as JaxRequest
from repro.serving import SpecPipeDBEngine as JaxSpecPipeDBEngine
from repro_torch.checkpoint import from_jax_params
from repro_torch.core.pipedec import PipeDecConfig, PipeDecEngine
from repro_torch.core.speculative import ModelBundle
from repro_torch.launch import serve
from repro_torch.models.config import ModelConfig
from repro_torch.serving import (AsyncExecutorError, AsyncPipelineExecutor,
                                 Request, ShardedPipelineExecutor,
                                 SpecPipeDBEngine)

MAX_LEN = 128
TIMEOUT_S = 60.0
PCFG = PipeDecConfig(n_stages=3, width=4, branch=2)
STATS = ("timesteps", "commits", "hits", "misses", "entries",
         "commits_per_step")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair(tiny_dense, tiny_draft):
    """{"target"|"draft": (port bundle, JAX bundle)}: the 3-layer target
    (one layer per stage) and the 1-layer draft on the same numpy weights
    in both packages."""
    from test_torch_model import numpy_params
    out = {}
    for name, jcfg, seed in (("target", tiny_dense, 0),
                             ("draft", tiny_draft, 9)):
        params = numpy_params(jcfg, seed)
        cfg = ModelConfig(**{f.name: getattr(jcfg, f.name)
                             for f in dataclasses.fields(ModelConfig)})
        out[name] = (ModelBundle(from_jax_params(cfg, params, device="cpu")),
                     JaxBundle(jax.tree.map(jnp.asarray, params), jcfg))
    return out


def _requests(seed, n, arrivals, max_new):
    rng = np.random.default_rng(seed)
    return [Request(i, rng.integers(0, 100, size=int(rng.integers(3, 8))),
                    int(max_new[i]), arrival_t=int(arrivals[i]))
            for i in range(n)]


def _executor(cls, target, draft, slots, **kw):
    if cls is AsyncPipelineExecutor:
        kw.setdefault("timeout_s", TIMEOUT_S)
    return cls(target, draft, slots=slots, max_len=MAX_LEN,
               tree_capacity=PCFG.tree_buffer_capacity,
               capacity=PCFG.capacity, n_stages=PCFG.n_stages, **kw)


def _serve(ex, target, draft, reqs):
    eng = SpecPipeDBEngine(target, draft, PCFG, max_len=MAX_LEN,
                           max_slots=ex.slots, executor=ex)
    for r in reqs:
        eng.submit(r)
    return eng, eng.run()


def _async_threads():
    return [t.name for t in threading.enumerate()
            if t.name.startswith("async-")]


def test_async_bitmatches_flush_and_single(pair):
    """Staggered arrivals and slot churn (the JAX pin's workload): the
    async executor commits the single-request engine's and the flush
    ring's tokens with their GenStats; every entry stepped every stage
    actor once, the drained pipe consumed every message it was fed, and
    each admission made one separate prefill per model."""
    target, _ = pair["target"]
    draft, _ = pair["draft"]
    reqs = _requests(11, 4, arrivals=[0, 1, 4, 6], max_new=[4, 5, 3, 4])
    single = PipeDecEngine(target, draft, PCFG, max_len=MAX_LEN)
    want = {r.uid: single.generate(r.prompt, r.max_new_tokens)
            for r in reqs}
    _, flush = _serve(_executor(ShardedPipelineExecutor, target, draft, 2),
                      target, draft, reqs)
    ex = _executor(AsyncPipelineExecutor, target, draft, 2)
    before = {b: dict(b.calls) for b in (target, draft)}
    try:
        eng, res = _serve(ex, target, draft, reqs)
        for uid, (tokens, stats) in want.items():
            np.testing.assert_array_equal(flush[uid].tokens, tokens)
            np.testing.assert_array_equal(res[uid].tokens, tokens)
            assert {k: getattr(res[uid].stats, k) for k in STATS} == \
                {k: getattr(stats, k) for k in STATS}, uid
        assert ex.calls["stage_steps"] == \
            ex.calls["entry_msgs"] * PCFG.n_stages
        assert ex._consumed == ex._pushed
        assert ex.calls["pipeline_tick"] == eng.stats.timesteps
        assert ex.calls["verify_rows"] == sum(eng.stats.verify_dispatches)
        assert ex.calls["kill"] >= len(reqs)       # misses and retires
        assert eng.stats.separate_prefill_dispatches == len(reqs)
        for b in (target, draft):
            assert b.calls["prefill"] - before[b].get("prefill", 0) == \
                len(reqs)
        ctr = ex.counters()
        assert ctr["pushed"] == ctr["consumed"] == ex._pushed
        assert ctr["max_draft_lead"] >= 1
        assert all(s["layers"] == ex.calls["entry_msgs"]
                   for s in ctr["stages"])
    finally:
        ex.shutdown()
    assert not _async_threads()


def test_async_self_draft_hits_and_prunes(pair):
    """The target as its own draft: every prediction hits, so commits and
    prune maps ride the ctrl messages through every stage, and the
    tokens and GenStats are the single-request engine's."""
    target, _ = pair["target"]
    reqs = _requests(5, 3, arrivals=[0, 0, 2], max_new=[8, 6, 7])
    single = PipeDecEngine(target, target, PCFG, max_len=MAX_LEN)
    ex = _executor(AsyncPipelineExecutor, target, target, 2)
    try:
        eng, res = _serve(ex, target, target, reqs)
        for r in reqs:
            tokens, stats = single.generate(r.prompt, r.max_new_tokens)
            np.testing.assert_array_equal(res[r.uid].tokens, tokens)
            assert res[r.uid].stats.acceptance == 1.0
        assert ex.calls["remap_rows"] > 0 and ex.calls["ctrl_msgs"] > 0
        assert ex.calls["stage_ctrl"] > 0
    finally:
        ex.shutdown()


def test_async_matches_jax_async_engine(pair):
    """The JAX ``AsyncPipelineExecutor`` engine and the port's on the same
    weights and requests commit the same tokens with the same GenStats
    and acceptance."""
    target, jtarget = pair["target"]
    draft, jdraft = pair["draft"]
    jpcfg = JaxPipeDecConfig(n_stages=3, width=4, branch=2)
    reqs = _requests(11, 4, arrivals=[0, 1, 4, 6], max_new=[4, 5, 3, 4])
    ex = _executor(AsyncPipelineExecutor, target, draft, 2)
    jex = JaxAsyncPipelineExecutor(
        jtarget, jdraft, slots=2, max_len=MAX_LEN,
        tree_capacity=jpcfg.tree_buffer_capacity, capacity=jpcfg.capacity,
        n_stages=3, timeout_s=TIMEOUT_S)
    jeng = JaxSpecPipeDBEngine(jtarget, jdraft, jpcfg, max_len=MAX_LEN,
                               max_slots=2, executor=jex)
    for r in reqs:
        jeng.submit(JaxRequest(r.uid, np.asarray(r.prompt, np.int32),
                               r.max_new_tokens, arrival_t=r.arrival_t))
    try:
        eng, res = _serve(ex, target, draft, reqs)
        jres = jeng.run()
    finally:
        ex.shutdown()
        jex.shutdown()
    for uid in jres:
        np.testing.assert_array_equal(res[uid].tokens, jres[uid].tokens)
        assert {k: getattr(res[uid].stats, k) for k in STATS} == \
            {k: getattr(jres[uid].stats, k) for k in STATS}, uid
    assert (eng.stats.accepted, eng.stats.proposed) == \
        (jeng.stats.accepted, jeng.stats.proposed)
    assert ex.calls["entry_msgs"] == jex.calls["entry_msgs"]


def test_async_kill_short_circuits_in_flight_layer(pair):
    """Kill latency: with the stage actors paused, a pushed layer whose
    slot is killed dies at stage 0, before one hop (the lockstep ring
    lets it ride ``n_stages - 1`` more); its future is dead and its exit
    is dropped."""
    target, _ = pair["target"]
    draft, _ = pair["draft"]
    ex = _executor(AsyncPipelineExecutor, target, draft, 2)
    try:
        ex.pause()
        row_on = np.array([True, False])
        _d, handles = ex.tick_rows(*ex.dead_entry, row_on)
        ex.kill(0)
        ex.resume()
        ex.drain()
        ctr = ex.counters()
        assert ctr["stages"][0]["stale_rows"] >= 1
        assert all(s["stale_rows"] >= 1 for s in ctr["stages"])
        assert handles[0].dead
        assert ex.calls["stale_exits"] >= 1
        assert ex.calls["stage_layers"] == 0       # no stage computed it
        with pytest.raises(RuntimeError, match="stale"):
            handles[0].resolve()
    finally:
        ex.shutdown()


def test_async_actor_exception_propagates(pair):
    """Fail loudly, never hang: a stage actor that raises surfaces on the
    host thread as ``AsyncExecutorError`` carrying the original
    traceback, well inside the timeout, and shutdown still joins every
    actor."""
    target, _ = pair["target"]
    draft, _ = pair["draft"]
    ex = _executor(AsyncPipelineExecutor, target, draft, 2)

    def boom(*a, **k):
        raise RuntimeError("injected stage fault")

    ex._apply = boom
    t0 = time.monotonic()
    try:
        with pytest.raises(AsyncExecutorError,
                           match="injected stage fault"):
            ex.tick_rows(*ex.dead_entry, np.array([True, False]))
            ex.drain()
        assert time.monotonic() - t0 < TIMEOUT_S
    finally:
        ex.shutdown()
    assert not _async_threads()


def test_async_shutdown_clean_and_deterministic(pair):
    """``shutdown()`` joins every actor thread (none leaked), is
    idempotent, a fresh executor repeating the workload gives the same
    tokens, and a shut-down executor restarts on its next use."""
    target, _ = pair["target"]
    draft, _ = pair["draft"]
    reqs = _requests(13, 3, arrivals=[0, 1, 3], max_new=[4, 3, 4])

    def run_once(ex):
        _, res = _serve(ex, target, draft, reqs)
        ex.shutdown()
        ex.shutdown()
        assert not _async_threads()
        return {u: res[u].tokens for u in res}

    ex = _executor(AsyncPipelineExecutor, target, draft, 2)
    a = run_once(ex)
    b = run_once(_executor(AsyncPipelineExecutor, target, draft, 2))
    c = run_once(ex)                               # restarted lazily
    for u in a:
        np.testing.assert_array_equal(a[u], b[u])
        np.testing.assert_array_equal(a[u], c[u])


def test_async_refuses_paged(pair, capsys):
    """The async executor has no paged arena: the constructor and the CLI
    refuse ``paged``, each with a message."""
    target, _ = pair["target"]
    draft, _ = pair["draft"]
    with pytest.raises(ValueError, match="no paged arena"):
        _executor(AsyncPipelineExecutor, target, draft, 2, paged=True)
    with pytest.raises(SystemExit):
        serve.main(["--mode", "pipedec-db", "--executor", "async",
                    "--paged", "--device", "cpu"])
    assert "no paged arena" in capsys.readouterr().err


def test_counts_exact_under_threads():
    """The actors bump shared call and launch counts: with more threads
    than cores and a short switch interval, no update is lost."""
    import collections
    import os
    import sys

    from repro_torch.counting import bump, bump_attr

    def fn():
        pass
    fn.launches = 0
    calls = collections.Counter()
    n_threads = 2 * (os.cpu_count() or 1) + 2
    n = 2000

    def work():
        for _ in range(n):
            bump(calls, "stage_steps")
            bump_attr(fn, "launches")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert calls["stage_steps"] == fn.launches == n_threads * n
