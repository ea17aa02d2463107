"""SpecPipe-DB in the port against the JAX package's, on the tiny pair of
``tests/conftest.py`` with the same numpy weights in both packages (the
weight bridge): ``TreeBatch``, and the greedy ``SpecPipeDBEngine`` on the
local executor, dense and paged, with staggered arrivals and priorities,
with a real draft (misses) and with the target as its own draft (hits, so
the batched prune remap runs).  Tokens, ``DBStats`` and the executor's
dispatch counts must be equal.  Within the port: DB tokens equal the
single-request ``PipeDecEngine`` per request, the fused dispatch equals
the looped reference, a streamed prefix equals the final result, and a
recycled slot whose new blocks differ from its old ones reads its own
rows.

Every comparison here is exact (greedy tokens, counts, tree arrays),
except the trees' cumulative log-probabilities: the two packages' fp32
log-softmax sums differ in the last bits, so those agree within 1e-6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import tree as jtree_lib
from repro.core.dynbatch import TreeBatch as JaxTreeBatch
from repro.core.pipedec import PipeDecConfig as JaxPipeDecConfig
from repro.core.speculative import ModelBundle as JaxBundle
from repro.core.speculative import draft_candidates as jax_candidates
from repro.serving import LocalFusedExecutor as JaxLocalFusedExecutor
from repro.serving import Request as JaxRequest
from repro.serving import SpecPipeDBEngine as JaxSpecPipeDBEngine
from repro_torch.checkpoint import from_jax_params
from repro_torch.core import tree as tree_lib
from repro_torch.core.dynbatch import TreeBatch
from repro_torch.core.pipedec import PipeDecConfig, PipeDecEngine
from repro_torch.core.speculative import ModelBundle, draft_candidates
from repro_torch.models.config import ModelConfig
from repro_torch.serving import (LocalFusedExecutor, Request,
                                 ServingEngine, SpecPipeDBEngine,
                                 generate_with_executor)

PCFG = (3, 4, 2)             # n_stages, width, branch
MAX_LEN = 128
STATS = ("timesteps", "commits", "hits", "misses", "entries",
         "commits_per_step")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_cfg(jcfg) -> ModelConfig:
    return ModelConfig(**{f.name: getattr(jcfg, f.name)
                          for f in dataclasses.fields(ModelConfig)})


@pytest.fixture(scope="module")
def pair(tiny_dense, tiny_draft):
    """{"target"|"draft": (port bundle, JAX bundle)} on the same weights."""
    from test_torch_model import numpy_params
    out = {}
    for name, jcfg, seed in (("target", tiny_dense, 0),
                             ("draft", tiny_draft, 9)):
        params = numpy_params(jcfg, seed)
        out[name] = (ModelBundle(from_jax_params(_port_cfg(jcfg), params,
                                                 device="cpu")),
                     JaxBundle(jax.tree.map(jnp.asarray, params), jcfg))
    return out


def _requests(seed, n, arrivals, max_new, priorities=None):
    rng = np.random.default_rng(seed)
    return [Request(i, rng.integers(0, 100, size=int(rng.integers(3, 9))),
                    int(max_new[i]), arrival_t=int(arrivals[i]),
                    priority=int(priorities[i]) if priorities else 0)
            for i in range(n)]


def _jax_request(r):
    return JaxRequest(r.uid, np.asarray(r.prompt, np.int32),
                      r.max_new_tokens, arrival_t=r.arrival_t,
                      priority=r.priority)


def _port_db(target, draft, reqs, *, paged, slots=2, fused=True):
    pcfg = PipeDecConfig(*PCFG)
    ex = LocalFusedExecutor(target, draft, slots=slots, max_len=MAX_LEN,
                            tree_capacity=pcfg.tree_buffer_capacity,
                            capacity=pcfg.capacity, paged=paged, page=16)
    eng = SpecPipeDBEngine(target, draft, pcfg, max_len=MAX_LEN,
                           max_slots=slots, executor=ex, fused=fused)
    for r in reqs:
        eng.submit(r)
    return eng, eng.run()


# --------------------------------------------------------------------------
# TreeBatch
# --------------------------------------------------------------------------
def test_treebatch_matches_jax():
    """Init, expand and prune rows from the same candidate streams: every
    tree array, the counters and the stacked deepest-layer view equal the
    JAX package's."""
    w, c, cap = 3, 2, 13
    ours, ref = TreeBatch(slots=2, capacity=cap), JaxTreeBatch(2, cap)
    for slot, root in ((0, 5), (1, 9)):
        ours.init_row(slot, root)
        ref.init_row(slot, root)
    rng = np.random.default_rng(0)
    for step in range(3):
        for slot in range(2):
            logits = rng.normal(size=(w, 32)).astype(np.float32)
            valid = np.arange(w) < min(w, step + 1)
            tok, lp = draft_candidates(torch.as_tensor(logits),
                                       torch.as_tensor(valid), c)
            jtok, jlp = jax_candidates(jnp.asarray(logits),
                                       jnp.asarray(valid), c)
            ours.expand_row(slot, tok, lp, w)
            ref.expand_row(slot, jtok, jlp, w)
    child = tree_lib.root_argmax_child(ours.get_row(0))
    assert child == int(jtree_lib.root_argmax_child(ref.get_row(0)))
    _, imap = ours.prune_row(0, child)
    _, jimap = ref.prune_row(0, child)
    np.testing.assert_array_equal(imap.numpy(), np.asarray(jimap))
    for slot in range(2):
        got, want = ours.get_row(slot), ref.get_row(slot)
        for name in tree_lib.Tree._fields:
            g, x = np.asarray(getattr(got, name)), np.asarray(getattr(want,
                                                                      name))
            if name == "logprob":     # log-softmax sums in another order
                np.testing.assert_allclose(g, x, rtol=1e-6, atol=1e-6)
            else:
                np.testing.assert_array_equal(g, x, err_msg=name)
    for got, want in zip(ours.deepest_layers(w), ref.deepest_layers(w)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    ours.release_row(0)
    assert ours.occupancy() == 1


# --------------------------------------------------------------------------
# the DB engine against the JAX package's
# --------------------------------------------------------------------------
@pytest.mark.parametrize("self_draft", [False, True])
@pytest.mark.parametrize("paged", [False, True])
def test_db_engine_matches_jax(pair, paged, self_draft):
    """Staggered arrivals and mixed priorities on 2 slots: tokens, per-
    request GenStats, the occupancy trace, acceptance and the executor's
    verify / commit / remap counts equal the JAX engine's on the same
    executor kind.  The self-draft case hits, so the prune remap runs."""
    target, jtarget = pair["target"]
    draft, jdraft = pair["target"] if self_draft else pair["draft"]
    reqs = _requests(3, 4, arrivals=[0, 1, 1, 4], max_new=[5, 4, 6, 3],
                     priorities=[0, 0, 2, 1])
    eng, res = _port_db(target, draft, reqs, paged=paged)
    jpcfg = JaxPipeDecConfig(*PCFG)
    jex = JaxLocalFusedExecutor(
        jtarget, jdraft, slots=2, max_len=MAX_LEN,
        tree_capacity=jpcfg.tree_buffer_capacity, capacity=jpcfg.capacity,
        paged=paged, page=16)
    jeng = JaxSpecPipeDBEngine(jtarget, jdraft, jpcfg, max_len=MAX_LEN,
                               max_slots=2, executor=jex)
    for r in reqs:
        jeng.submit(_jax_request(r))
    jres = jeng.run()
    assert set(res) == set(jres) == {r.uid for r in reqs}
    for uid in jres:
        np.testing.assert_array_equal(res[uid].tokens, jres[uid].tokens)
        assert {k: getattr(res[uid].stats, k) for k in STATS} == \
            {k: getattr(jres[uid].stats, k) for k in STATS}
    st, jst = eng.stats, jeng.stats
    assert st.timesteps == jst.timesteps
    assert st.occupancy == jst.occupancy
    assert st.verify_dispatches == jst.verify_dispatches
    assert (st.accepted, st.proposed) == (jst.accepted, jst.proposed)
    assert eng.sched.stats.admitted_t == jeng.sched.stats.admitted_t
    for key in ("verify_rows", "commit_rows", "remap_rows"):
        assert eng.executor.calls[key] == jex.calls[key], key
    if self_draft:
        assert st.acceptance_rate == 1.0 and eng.executor.calls[
            "remap_rows"] > 0
    if paged:
        assert st.page_counters == jst.page_counters
        np.testing.assert_array_equal(eng.arena.pages.model_table,
                                      jex.arena.pages.model_table)


# --------------------------------------------------------------------------
# the bit-identity tower inside the port
# --------------------------------------------------------------------------
@pytest.mark.parametrize("paged", [False, True])
def test_db_equals_pipedec_and_fused_equals_looped(pair, paged):
    """More requests than slots, slot recycling, staggered arrivals: the
    fused and the looped DB runs give each request the tokens and
    GenStats of running it alone; one target and one draft verify per
    timestep that has entries."""
    target, _ = pair["target"]
    draft, _ = pair["draft"]
    reqs = _requests(8, 5, arrivals=[0, 1, 2, 6, 8], max_new=[4, 5, 3, 6, 4])
    single = PipeDecEngine(target, draft, PipeDecConfig(*PCFG),
                           max_len=MAX_LEN)
    want = {r.uid: single.generate(r.prompt, r.max_new_tokens)
            for r in reqs}
    runs = {}
    for fused in (True, False):
        before = {m: dict(m.calls) for m in (target, draft)}
        eng, res = _port_db(target, draft, reqs, paged=paged, fused=fused)
        runs[fused] = res
        for uid, (tokens, stats) in want.items():
            np.testing.assert_array_equal(res[uid].tokens, tokens)
            assert {k: getattr(res[uid].stats, k) for k in STATS} == \
                {k: getattr(stats, k) for k in STATS}
        for m in (target, draft):
            fused_calls = m.calls["tree_verify_rows"] - before[m].get(
                "tree_verify_rows", 0)
            assert fused_calls == (sum(eng.stats.verify_dispatches)
                                   if fused else 0)
        assert eng.stats.peak_occupancy == 2
        assert eng.arena.n_used == 0
    for uid in runs[True]:
        np.testing.assert_array_equal(runs[True][uid].tokens,
                                      runs[False][uid].tokens)


def test_streaming_prefix_equals_final_result(pair):
    target, _ = pair["target"]
    draft, _ = pair["draft"]
    reqs = _requests(6, 4, arrivals=[0, 1, 3, 7], max_new=[4, 5, 3, 4])
    pcfg = PipeDecConfig(*PCFG)
    eng = SpecPipeDBEngine(target, draft, pcfg, max_len=MAX_LEN,
                           max_slots=2)
    for r in reqs:
        eng.submit(r)
    events = []
    res = eng.run(on_token=lambda uid, tok, t: events.append((uid, tok, t)))
    for r in reqs:
        mine = [(tok, t) for uid, tok, t in events if uid == r.uid]
        np.testing.assert_array_equal([tok for tok, _ in mine],
                                      res[r.uid].tokens)
        times = [t for _, t in mine]
        assert times == sorted(times)
        assert times[0] == eng.sched.stats.admitted_t[r.uid]
        assert times[-1] <= eng.sched.stats.finished_t[r.uid]


def test_recycled_slot_with_new_blocks_reads_its_own_rows(pair):
    """Tight pools on 1 slot: each request gets other physical blocks than
    the one before it in the slot, and its tokens still equal running it
    alone: the card's tables follow every bind and free."""
    target, _ = pair["target"]
    draft, _ = pair["draft"]
    pcfg = PipeDecConfig(*PCFG)
    reqs = _requests(12, 3, arrivals=[0, 0, 0], max_new=[3, 4, 3])
    ex = LocalFusedExecutor(target, draft, slots=1, max_len=MAX_LEN,
                            tree_capacity=pcfg.tree_buffer_capacity,
                            capacity=pcfg.capacity, paged=True, page=8)
    eng = SpecPipeDBEngine(target, draft, pcfg, max_len=MAX_LEN,
                           max_slots=1, executor=ex)
    tables = []
    orig_bind = ex.arena.bind

    def bind(slot, req):
        orig_bind(slot, req)
        tables.append(ex.arena.pages.model_table[slot].copy())
        # the card's copy is the host table
        np.testing.assert_array_equal(
            ex.arena.stacked[0][0]["k"].table.numpy(),
            ex.arena.pages.model_table)
    ex.arena.bind = bind
    for r in reqs:
        eng.submit(r)
    res = eng.run()
    single = PipeDecEngine(target, draft, pcfg, max_len=MAX_LEN)
    for r in reqs:
        np.testing.assert_array_equal(
            res[r.uid].tokens, single.generate(r.prompt,
                                               r.max_new_tokens)[0])
    # freed blocks go back on the free list, so the next occupant of the
    # slot is handed blocks in another order
    assert len(tables) == 3 and not np.array_equal(tables[0], tables[1])


def test_serving_engine_pipedec_db(pair):
    """``ServingEngine(mode="pipedec-db")`` keeps the run's DBStats."""
    target, _ = pair["target"]
    draft, _ = pair["draft"]
    reqs = _requests(1, 3, arrivals=[0, 0, 2], max_new=[3, 4, 5])
    se = ServingEngine(target, draft, mode="pipedec-db", max_batch=2,
                       max_len=MAX_LEN, pipedec=PipeDecConfig(*PCFG))
    for r in reqs:
        se.submit(r)
    res = se.run()
    assert sorted(res) == [0, 1, 2] and not se.queue
    assert se.db_stats.total_commits >= sum(r.max_new_tokens for r in reqs)


def test_generate_with_executor_is_pipedec(pair):
    """One request through a single-slot DB engine on a paged executor
    gives the single-request engine's tokens and GenStats."""
    target, _ = pair["target"]
    draft, _ = pair["draft"]
    pcfg = PipeDecConfig(*PCFG)
    prompt = np.array([4, 8, 15, 16, 23])
    ex = LocalFusedExecutor(target, draft, slots=1, max_len=MAX_LEN,
                            tree_capacity=pcfg.tree_buffer_capacity,
                            capacity=pcfg.capacity, paged=True, page=16)
    tokens, stats = generate_with_executor(target, draft, pcfg, prompt, 6,
                                           executor=ex, max_len=MAX_LEN)
    want, wstats = PipeDecEngine(target, draft, pcfg,
                                 max_len=MAX_LEN).generate(prompt, 6)
    np.testing.assert_array_equal(tokens, want)
    assert {k: getattr(stats, k) for k in STATS} == \
        {k: getattr(wstats, k) for k in STATS}


@pytest.mark.parametrize("paged", [False, True])
def test_batched_remap_equals_per_slot_remap(pair, paged):
    """``remap_rows`` (one batched gather per model) leaves the tree
    arenas as the per-slot ``remap_row`` loop does: pruned slots
    compacted, the other slots bit-unchanged."""
    from repro_torch.core.tree import (tree_expand, tree_init,
                                       tree_prune_to_child)
    from repro_torch.serving.executor import PipelineExecutor
    target, _ = pair["target"]
    draft, _ = pair["draft"]
    pcfg = PipeDecConfig(*PCFG)
    arenas = []
    for _ in range(2):
        ex = LocalFusedExecutor(target, draft, slots=3, max_len=MAX_LEN,
                                tree_capacity=pcfg.tree_buffer_capacity,
                                capacity=pcfg.capacity, paged=paged, page=8)
        for slot in range(3):
            ex.arena.alloc()
            if paged:
                ex.arena.bind(slot, Request(slot, np.arange(4), 4))
        gen = torch.Generator().manual_seed(0)
        for tree in ex.arena.stacked[2:]:
            for layer in tree:
                for buf in layer.values():
                    pages = buf.pages if paged else buf
                    pages.copy_(torch.randn(pages.shape, generator=gen))
        arenas.append(ex)
    # a real prune map: a root with two children, pruned to the first
    w = pcfg.width
    lp = torch.full((w, 2), -1e30)
    lp[0] = torch.tensor([-0.1, -0.2])
    t = tree_expand(tree_init(pcfg.capacity, 1),
                    torch.tensor([[5, 6]] * w, dtype=torch.int32), lp, w)
    _, imap = tree_prune_to_child(t, 1)
    assert imap[:3].tolist() == [-1, 0, -1]
    maps = np.tile(np.arange(pcfg.capacity, dtype=np.int32), (3, 1))
    maps[1] = imap.numpy()
    on = np.asarray([False, True, False])
    arenas[0].remap_rows(maps, on)
    PipelineExecutor.remap_rows(arenas[1], maps, on)
    assert arenas[0].calls["remap_rows"] == 1
    for ta, tb in zip(arenas[0].arena.stacked[2:], arenas[1].arena.stacked[2:]):
        for la, lb in zip(ta, tb):
            for k in la:
                a, b = la[k], lb[k]
                if paged:
                    a, b = a.pages, b.pages
                assert torch.equal(a, b), k
