"""SpecPipe-DB on the port's stage ring: ``ShardedPipelineExecutor`` (one
flush of the ring per timestep) and ``OverlappedShardedExecutor`` (one
tick per timestep, deferred exit logits, pruning propagation in the ring,
prefill in the ring), dense and paged, at 1, 2 and 4 stages.

The bit-identity tower: for every request, the single-request
``PipeDecEngine``, DB on the local executor, DB flush and DB overlapped
commit the same tokens with the same ``GenStats``; the flush also selects
every token from the local run's logits bit for bit, and its ``DBStats``
equal the local run's.  On the overlapped ring admission rides the
prefill lane (``PREFILL_LANE`` = 64-token chunks; the prompts run up to
150 tokens, so some stream in several chunks): the requests join
``n_stages - 1`` timesteps later and the prompt's cache rows come from
the chunk attention over the cache (on the CPU the flash kernel's plain
version over every cache row) instead of a prefill over the prompt's
rows, so there tokens, per-request stats and acceptance are held exactly
and the logits are not compared.  The overlapped tokens are also
held to the JAX package's ``LocalFusedExecutor`` engine on bridged
weights (its own sharded-executor pins fail on this JAX version).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.pipedec import PipeDecConfig as JaxPipeDecConfig
from repro.core.speculative import ModelBundle as JaxBundle
from repro.models.config import ModelConfig as JaxModelConfig
from repro.serving import LocalFusedExecutor as JaxLocalFusedExecutor
from repro.serving import Request as JaxRequest
from repro.serving import SpecPipeDBEngine as JaxSpecPipeDBEngine
from repro_torch.checkpoint import from_jax_params
from repro_torch.core import pipedec as pipedec_mod
from repro_torch.core.pipedec import PipeDecConfig, PipeDecEngine
from repro_torch.core.speculative import ModelBundle
from repro_torch.models.config import ModelConfig
from repro_torch.serving import (Deferred, LocalFusedExecutor,
                                 OverlappedShardedExecutor, Request,
                                 ShardedPipelineExecutor, SpecPipeDBEngine,
                                 generate_with_executor)
from repro_torch.serving.executor import PREFILL_LANE

MAX_LEN = 256
LONG = (3, 150)       # prompt lengths: some stream through the lane in chunks
STATS = ("timesteps", "commits", "hits", "misses", "entries",
         "commits_per_step")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair(tiny_draft):
    """{"target"|"draft": (port bundle, JAX bundle)}: a 4-layer target
    and the 1-layer draft on the same numpy weights in both packages."""
    from test_torch_model import numpy_params
    jtarget = JaxModelConfig(name="t4", family="dense", num_layers=4,
                             d_model=64, num_heads=4, num_kv_heads=2,
                             d_ff=128, vocab_size=128)
    out = {}
    for name, jcfg, seed in (("target", jtarget, 0),
                             ("draft", tiny_draft, 9)):
        params = numpy_params(jcfg, seed)
        cfg = ModelConfig(**{f.name: getattr(jcfg, f.name)
                             for f in dataclasses.fields(ModelConfig)})
        out[name] = (ModelBundle(from_jax_params(cfg, params, device="cpu")),
                     JaxBundle(jax.tree.map(jnp.asarray, params), jcfg))
    return out


def _pcfg(stages):
    return PipeDecConfig(n_stages=stages, width=4, branch=2)


def _requests(seed, n, arrivals, max_new, lens=(3, 9)):
    rng = np.random.default_rng(seed)
    return [Request(i, rng.integers(0, 100, size=int(rng.integers(*lens))),
                    int(max_new[i]), arrival_t=int(arrivals[i]))
            for i in range(n)]


def _executor(kind, target, draft, pcfg, slots, paged=False, **kw):
    common = dict(slots=slots, max_len=MAX_LEN,
                  tree_capacity=pcfg.tree_buffer_capacity,
                  capacity=pcfg.capacity, paged=paged, page=16)
    if kind == "local":
        return LocalFusedExecutor(target, draft, **common)
    cls = OverlappedShardedExecutor if kind == "overlapped" \
        else ShardedPipelineExecutor
    return cls(target, draft, n_stages=pcfg.n_stages, **common, **kw)


def _run(ex, target, draft, pcfg, reqs, monkeypatch):
    """Serve ``reqs``; returns (engine, results, the logits every
    committed token was selected from, in order)."""
    seen = []
    real = pipedec_mod.select_token

    def select(logits, sp, gen=None):
        seen.append(logits.clone())
        return real(logits, sp, gen)
    monkeypatch.setattr(pipedec_mod, "select_token", select)
    eng = SpecPipeDBEngine(target, draft, pcfg, max_len=MAX_LEN,
                           max_slots=ex.slots, executor=ex)
    for r in reqs:
        eng.submit(r)
    res = eng.run()
    monkeypatch.setattr(pipedec_mod, "select_token", real)
    return eng, res, seen


def _stats(st):
    return {k: getattr(st, k) for k in STATS}


def _db(st):
    return (st.timesteps, st.occupancy, st.verify_dispatches, st.accepted,
            st.proposed, st.total_commits)


# --------------------------------------------------------------------------
# the tower
# --------------------------------------------------------------------------
@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("stages,slots,self_draft", [
    (1, 2, False), (2, 2, False), (4, 3, False), (4, 2, True)])
def test_tower_single_local_flush_overlapped(pair, monkeypatch, stages,
                                             slots, self_draft, paged):
    """More requests than slots, staggered arrivals: every request's tokens
    and GenStats are the single-request engine's on every executor.  The
    random draft misses, so the overlapped executor kills in-flight layers
    (on 3 slots, with live slots on both sides); as its own draft the
    target hits every time, so commit and compact propagate through every
    stage and retires kill.  The flush selects every token from the local
    run's logits bit for bit and its DBStats equal the local run's; the
    overlapped ring gates its ctrl (a gate that skipped a real message
    would change tokens) and streams prompts longer than the lane."""
    target, _ = pair["target"]
    draft = target if self_draft else pair["draft"][0]
    pcfg = _pcfg(stages)
    reqs = _requests(stages * 7 + slots, 5, arrivals=[0, 1, 1, 4, 6],
                     max_new=[5, 4, 6, 3, 4], lens=LONG)
    single = PipeDecEngine(target, draft, pcfg, max_len=MAX_LEN)
    want = {r.uid: single.generate(r.prompt, r.max_new_tokens)
            for r in reqs}
    runs = {}
    for kind in ("local", "flush", "overlapped"):
        before = dict(target.calls)
        ex = _executor(kind, target, draft, pcfg, slots, paged)
        eng, res, seen = _run(ex, target, draft, pcfg, reqs, monkeypatch)
        runs[kind] = eng, ex, seen
        for uid, (tokens, stats) in want.items():
            np.testing.assert_array_equal(res[uid].tokens, tokens,
                                          err_msg=f"{kind} uid {uid}")
            assert _stats(res[uid].stats) == _stats(stats), (kind, uid)
        if kind != "local" and not self_draft:   # the target: ring only
            assert target.calls["tree_verify_rows"] == before.get(
                "tree_verify_rows", 0)
    local, lseen = runs["local"][0], runs["local"][2]
    eng, ex, seen = runs["flush"]
    assert _db(eng.stats) == _db(local.stats)
    assert len(seen) == len(lseen)
    assert all(torch.equal(a, b) for a, b in zip(seen, lseen))
    eng, ex, _ = runs["overlapped"]
    assert (eng.stats.accepted, eng.stats.proposed) == \
        (local.stats.accepted, local.stats.proposed)
    assert eng.stats.separate_prefill_dispatches == 0
    assert ex.calls["prefill_in_ring"] == len(reqs)
    assert ex.calls["prefill_chunks"] > len(reqs)  # a prompt streamed
    assert eng.stats.tick_dispatches == [1] * eng.stats.timesteps
    assert ex.calls["pipeline_tick"] == eng.stats.timesteps
    assert ex.calls["drain_tick"] == 0
    assert ex.calls["kill"] >= len(reqs)           # every retire kills
    assert ex.calls["stage_ctrl"] > 0              # commits propagated
    # the gate skipped the ticks whose message was the identity
    assert 0 < ex.calls["ctrl_active_ticks"] < ex.calls["pipeline_tick"]
    eng, ex, _ = runs["flush"]
    assert ex.calls["pipeline_verify"] == sum(eng.stats.verify_dispatches)
    assert ex.calls["stage_layers"] == 4 * ex.calls["pipeline_verify"]
    if self_draft:
        assert local.stats.acceptance_rate == 1.0
        assert runs["overlapped"][1].calls["remap_rows"] > 0
    else:
        assert local.stats.total_proposed > local.stats.total_accepted


def test_overlapped_matches_jax_local_engine(pair):
    """The overlapped ring (2 stages, prefill in the ring) serves the
    requests of the JAX ``LocalFusedExecutor`` engine on the same weights
    with its tokens, GenStats and acceptance."""
    target, jtarget = pair["target"]
    draft, jdraft = pair["draft"]
    pcfg, jpcfg = _pcfg(2), JaxPipeDecConfig(n_stages=2, width=4, branch=2)
    reqs = _requests(4, 4, arrivals=[0, 1, 1, 4], max_new=[5, 4, 6, 3],
                     lens=LONG)
    ex = _executor("overlapped", target, draft, pcfg, 2)
    eng = SpecPipeDBEngine(target, draft, pcfg, max_len=MAX_LEN,
                           max_slots=2, executor=ex)
    jex = JaxLocalFusedExecutor(jtarget, jdraft, slots=2, max_len=MAX_LEN,
                                tree_capacity=jpcfg.tree_buffer_capacity,
                                capacity=jpcfg.capacity)
    jeng = JaxSpecPipeDBEngine(jtarget, jdraft, jpcfg, max_len=MAX_LEN,
                               max_slots=2, executor=jex)
    for r in reqs:
        eng.submit(r)
        jeng.submit(JaxRequest(r.uid, np.asarray(r.prompt, np.int32),
                               r.max_new_tokens, arrival_t=r.arrival_t))
    res, jres = eng.run(), jeng.run()
    for uid in jres:
        np.testing.assert_array_equal(res[uid].tokens, jres[uid].tokens)
        assert _stats(res[uid].stats) == _stats(jres[uid].stats)
    assert (eng.stats.accepted, eng.stats.proposed) == \
        (jeng.stats.accepted, jeng.stats.proposed)


# --------------------------------------------------------------------------
# the counterparts of the JAX executor pins
# --------------------------------------------------------------------------
def test_flush_one_pipeline_verify_per_timestep(pair):
    """Every timestep with pending entries issues ONE flush of the ring
    and ONE draft verify, never one per slot, and the target never runs
    the local fused verify."""
    target, _ = pair["target"]
    draft, _ = pair["draft"]
    pcfg = _pcfg(2)
    ex = _executor("flush", target, draft, pcfg, 2)
    eng = SpecPipeDBEngine(target, draft, pcfg, max_len=MAX_LEN,
                           max_slots=2, executor=ex)
    before = {b: dict(b.calls) for b in (target, draft)}
    for r in _requests(5, 3, arrivals=[0, 0, 2], max_new=[4, 3, 4]):
        eng.submit(r)
    eng.run()
    disp = eng.stats.verify_dispatches
    assert len(disp) == eng.stats.timesteps and max(disp) == 1
    assert ex.calls["pipeline_verify"] == ex.calls["verify_rows"] == \
        sum(disp)
    assert draft.calls["tree_verify_rows"] - before[draft].get(
        "tree_verify_rows", 0) == sum(disp)
    for b in (target, draft):
        assert b.calls["tree_verify"] == before[b].get("tree_verify", 0)
    assert eng.stats.peak_occupancy == 2


def test_overlapped_one_tick_per_timestep_and_prefill_in_ring(pair):
    """One ring tick per executed timestep, entries pending or not; every
    admission rides the tick (no ``prefill`` call on either bundle), and
    no flush is made."""
    target, _ = pair["target"]
    draft, _ = pair["draft"]
    pcfg = _pcfg(2)
    ex = _executor("overlapped", target, draft, pcfg, 2)
    eng = SpecPipeDBEngine(target, draft, pcfg, max_len=MAX_LEN,
                           max_slots=2, executor=ex)
    before = {b: dict(b.calls) for b in (target, draft)}
    reqs = _requests(8, 4, arrivals=[0, 0, 2, 5], max_new=[4, 3, 4, 3])
    for r in reqs:
        eng.submit(r)
    eng.run()
    assert eng.stats.tick_dispatches == [1] * eng.stats.timesteps
    assert ex.calls["pipeline_tick"] == eng.stats.timesteps
    assert ex.calls["pipeline_verify"] == ex.calls["drain_tick"] == 0
    assert ex.calls["prefill_in_ring"] == len(reqs)
    for b in (target, draft):
        assert b.calls["prefill"] == before[b].get("prefill", 0)
    # the draft's chunk prefills ride the same ticks, one per tick with
    # chunks entering
    assert 0 < draft.calls["prefill_chunk"] - before[draft].get(
        "prefill_chunk", 0) <= ex.calls["prefill_chunks"]
    assert ex.calls["ctrl_active_ticks"] <= ex.calls["pipeline_tick"]
    assert eng.stats.peak_occupancy == 2


def test_long_prompt_streams_through_ring_in_chunks(pair):
    """A prompt longer than the lane streams in ``PREFILL_LANE``-token
    chunks over consecutive ticks: tokens equal the single-request
    engine's, with no separate prefill."""
    target, _ = pair["target"]
    draft, _ = pair["draft"]
    pcfg = _pcfg(2)
    rng = np.random.default_rng(14)
    reqs = [Request(0, rng.integers(0, 100, size=150), 4, arrival_t=0),
            Request(1, rng.integers(0, 100, size=4), 3, arrival_t=1)]
    ex = _executor("overlapped", target, draft, pcfg, 2)
    assert ex.prefill_cap == PREFILL_LANE == 64
    eng = SpecPipeDBEngine(target, draft, pcfg, max_len=MAX_LEN,
                           max_slots=2, executor=ex)
    for r in reqs:
        eng.submit(r)
    res = eng.run()
    single = PipeDecEngine(target, draft, pcfg, max_len=MAX_LEN)
    for r in reqs:
        np.testing.assert_array_equal(
            res[r.uid].tokens, single.generate(r.prompt, r.max_new_tokens)[0])
    assert ex.calls["prefill_chunks"] == 4     # 150 tokens: 64 + 64 + 22
    assert eng.stats.separate_prefill_dispatches == 0
    assert ex.calls["pipeline_tick"] == eng.stats.timesteps


@pytest.mark.parametrize("kind", ["flush", "overlapped"])
def test_all_padding_stage_serves(pair, kind):
    """The 4-layer target on 3 stages (two layers a stage; the last stage
    holds only padding, as ``serve --executor sharded --stages 3`` cuts
    it): the ring skips that stage and serves the single-request
    engine's tokens and GenStats."""
    target, _ = pair["target"]
    draft, _ = pair["draft"]
    pcfg = _pcfg(3)
    reqs = _requests(3, 3, arrivals=[0, 1, 3], max_new=[4, 5, 3], lens=LONG)
    ex = _executor(kind, target, draft, pcfg, 2)
    assert not ex.stage_valid[-1].any()
    eng = SpecPipeDBEngine(target, draft, pcfg, max_len=MAX_LEN,
                           max_slots=2, executor=ex)
    for r in reqs:
        eng.submit(r)
    res = eng.run()
    single = PipeDecEngine(target, draft, pcfg, max_len=MAX_LEN)
    for r in reqs:
        tokens, stats = single.generate(r.prompt, r.max_new_tokens)
        np.testing.assert_array_equal(res[r.uid].tokens, tokens)
        assert _stats(res[r.uid].stats) == _stats(stats)


@pytest.mark.parametrize("kind", ["flush", "overlapped"])
def test_generate_with_executor_b1_path(pair, kind):
    """The B = 1 path through ``generate_with_executor`` on the ring gives
    the single-request engine's tokens and GenStats."""
    target, _ = pair["target"]
    draft, _ = pair["draft"]
    pcfg = _pcfg(4)
    prompt = np.array([5, 3, 2, 7, 11])
    got, stats = generate_with_executor(
        target, draft, pcfg, prompt, 6, max_len=MAX_LEN,
        executor=_executor(kind, target, draft, pcfg, 1))
    want, wstats = PipeDecEngine(target, draft, pcfg,
                                 max_len=MAX_LEN).generate(prompt, 6)
    np.testing.assert_array_equal(got, want)
    assert _stats(stats) == _stats(wstats)


def test_slot_and_stage_counts_must_match(pair):
    """The engine refuses an executor with another slot count, and an
    overlapped one whose stage count is not ``PipeDecConfig.n_stages``
    (the ring is the flight bookkeeping); int8 bundles are served on the
    ring, whose caches then hold int8 rows with their scales."""
    target, _ = pair["target"]
    draft, _ = pair["draft"]
    pcfg = _pcfg(2)
    with pytest.raises(ValueError, match="slots"):
        SpecPipeDBEngine(target, draft, pcfg, max_len=MAX_LEN, max_slots=3,
                         executor=_executor("flush", target, draft, pcfg, 2))
    ex = _executor("overlapped", target, draft, _pcfg(4), 2)
    with pytest.raises(ValueError, match="n_stages"):
        SpecPipeDBEngine(target, draft, pcfg, max_len=MAX_LEN, max_slots=2,
                         executor=ex)
    ex = _executor("flush", target.quantize(), draft.quantize(), pcfg, 2)
    assert sorted(ex.t_cache[0]) == ["k", "k_scale", "v", "v_scale"]
    assert ex.t_tree[0]["k"].dtype == torch.int8


def test_stale_flight_cannot_commit():
    """A future resolves only after its exit tick and never once killed."""
    h = Deferred(slot=0, version=3)
    with pytest.raises(RuntimeError, match="before its exit"):
        h.resolve()
    h.dead = True
    with pytest.raises(RuntimeError, match="stale"):
        h.resolve()


def test_kill_cancels_in_flight_prefill(pair):
    """A slot killed while its prompt rides the lane leaves the executor
    clean: the prefill future is dead, ``drain`` has nothing to wait for,
    and the slot admits a fresh prefill, which resolves."""
    target, _ = pair["target"]
    draft, _ = pair["draft"]
    pcfg = _pcfg(2)
    ex = _executor("overlapped", target, draft, pcfg, 1)
    prompt = np.random.default_rng(3).integers(0, 100, size=100)
    h = ex.begin_prefill(0, prompt)
    ex.tick_rows(*ex.dead_entry, np.zeros(1, bool))      # chunk 1 rides
    ex.kill(0)
    with pytest.raises(RuntimeError, match="killed"):
        h.resolve()
    assert ex.drain() == 0
    h2 = ex.begin_prefill(0, prompt)
    assert ex.drain() == 3 and h2.ready          # 2 chunks (64 + 36), 2 stages
    want, _ = target.prefill(prompt[None], target.init_cache(1, MAX_LEN))
    np.testing.assert_allclose(h2.resolve().numpy(), want.numpy(), rtol=0,
                               atol=1e-5)
