"""The port's SpecPipe-DB scheduler and paged arena against the JAX
package's (the pins of ``tests/test_scheduler_priority.py``, run on both
packages side by side), and the int8 paged DB path against the JAX
package's int8 paged DB on the tiny pair with the same weights.

Admission orders, preemption victims, block tables and tokens are
compared exactly; a swapped-out-and-back slot must read back its rows bit
for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.pipedec import PipeDecConfig as JaxPipeDecConfig
from repro.core.speculative import ModelBundle as JaxBundle
from repro.serving import DynamicBatchScheduler as JaxScheduler
from repro.serving import KVArena as JaxKVArena
from repro.serving import LocalFusedExecutor as JaxLocalFusedExecutor
from repro.serving import PagedKVArena as JaxPagedKVArena
from repro.serving import Request as JaxRequest
from repro.serving import SlotPool as JaxSlotPool
from repro.serving import SpecPipeDBEngine as JaxSpecPipeDBEngine
from repro_torch.checkpoint import from_jax_params
from repro_torch.core.pipedec import PipeDecConfig, PipeDecEngine
from repro_torch.core.speculative import ModelBundle
from repro_torch.models.config import ModelConfig
from repro_torch.serving import (DynamicBatchScheduler, KVArena,
                                 LocalFusedExecutor, PagedKVArena, Request,
                                 SlotPool, SpecPipeDBEngine)

PCFG = (3, 4, 2)
MAX_LEN = 128


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair(tiny_dense, tiny_draft):
    """{"target"|"draft": (port bundle, JAX bundle)} on the same weights."""
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


def _req(cls, uid, arrival=0, priority=0, deadline=None, new=4):
    return cls(uid, np.asarray([1, 2, 3], np.int32), new, arrival_t=arrival,
               priority=priority, deadline_t=deadline)


def _both(script, make_arena):
    """Run ``script(sched, cls)`` on a port and a JAX scheduler; return
    both results."""
    out = []
    for sched_cls, req_cls, pool_cls in (
            (DynamicBatchScheduler, Request, SlotPool),
            (JaxScheduler, JaxRequest, JaxSlotPool)):
        out.append(script(sched_cls, req_cls, make_arena(pool_cls)))
    return out


def _uids(admitted):
    return [r.uid for r, _ in admitted]


def test_priority_reorders_admission_like_jax():
    def script(sched_cls, req, arena):
        sched = sched_cls(arena)
        for r in (_req(req, 0), _req(req, 1), _req(req, 2, priority=5)):
            sched.submit(r)
        return _uids(sched.admit(now=0))
    ours, ref = _both(script, lambda cls: cls(1))
    assert ours == ref == [2]


def test_fifo_arrivals_aging_and_deadline_like_jax():
    """Equal priorities are FIFO; unarrived requests wait; aging lets a
    default-priority request tie and beat fresher priority-1 traffic; a
    deadline inside the aging window lifts a request."""
    def script(sched_cls, req, arena):
        trace = []
        sched = sched_cls(arena, aging=4)
        for uid in (3, 1):
            sched.submit(_req(req, uid))
        sched.submit(_req(req, 7, arrival=5, priority=9))
        trace.append(_uids(sched.admit(now=0)))
        sched.submit(_req(req, 0, arrival=0))
        sched.submit(_req(req, 4, arrival=2, priority=1))
        for s in list(arena._in_use):
            arena.free(s)
        trace.append(_uids(sched.admit(now=2)))
        for s in list(arena._in_use):
            arena.free(s)
        sched.submit(_req(req, 5, arrival=4, priority=1))
        sched.submit(_req(req, 6, deadline=7))
        trace.append([sched.effective_priority(r, 4) for r in sched.queue])
        trace.append(_uids(sched.admit(now=5)))
        return trace
    ours, ref = _both(script, lambda cls: cls(2))
    assert ours == ref == [[3, 1], [4, 0], [9, 1, 2], [7, 6]]


def _paged_arenas(pair, **kw):
    """Port and JAX paged arenas with tight pools (page 8, 32 model rows,
    12 tree rows per slot): with model_blocks=3, tree_blocks=2 one
    default request fits at a time."""
    kw.setdefault("slots", 2)
    (t, jt), (d, jd) = pair["target"], pair["draft"]
    return (PagedKVArena(t, d, max_len=32, tree_capacity=12, page=8, **kw),
            JaxPagedKVArena(jt, jd, max_len=32, tree_capacity=12, page=8,
                            **kw))


def _fill(rows, seed):
    """Distinct values in every leaf of a slot's dense rows."""
    return tuple([{k: (torch.arange(v.numel()) % 7 + seed).reshape(
        v.shape).to(v.dtype) for k, v in layer.items()} for layer in cache]
        for cache in rows)


def test_swap_out_swap_in_resume_bit_identical(pair):
    """Swap a slot out, let another request take its blocks and scribble
    on them, swap it back in (other block ids): its rows read back bit for
    bit, and the tables equal the JAX arena's over the same operations."""
    arena, jarena = _paged_arenas(pair, model_blocks=3, tree_blocks=2)
    r0, r1 = _req(Request, 0), _req(Request, 1)
    s0 = arena.alloc()
    arena.bind(s0, r0)
    arena.store(s0, _fill(arena.caches(s0), seed=3))
    before = arena.caches(s0)
    js0 = jarena.alloc()
    jarena.bind(js0, _req(JaxRequest, 0))

    arena.swap_out(s0)
    jarena.swap_out(js0)
    assert arena.pages.swaps == 1
    assert arena.pages.model.in_use + arena.pages.tree.in_use == 0
    s1 = arena.alloc()
    arena.bind(s1, r1)
    arena.store(s1, _fill(arena.caches(s1), seed=11))
    js1 = jarena.alloc()
    jarena.bind(js1, _req(JaxRequest, 1))
    assert not arena.swap_in(s0) and not jarena.swap_in(js0)
    arena.free(s1)
    jarena.free(js1)
    assert arena.swap_in(s0) and jarena.swap_in(js0)
    np.testing.assert_array_equal(arena.pages.model_table,
                                  jarena.pages.model_table)
    np.testing.assert_array_equal(arena.pages.tree_table,
                                  jarena.pages.tree_table)
    for cb, ca in zip(before, arena.caches(s0)):
        for lb, la in zip(cb, ca):
            for k in lb:
                assert torch.equal(lb[k], la[k]), k


def test_admission_preempts_lru_parked_slot_like_jax(pair):
    """A request whose horizon does not fit swaps out the least recently
    touched parked slot; busy slots are never preempted."""
    arena, jarena = _paged_arenas(pair, slots=3, model_blocks=6,
                                  tree_blocks=4)
    victims = []
    for a, req in ((arena, Request), (jarena, JaxRequest)):
        cls = DynamicBatchScheduler if a is arena else JaxScheduler
        sched = cls(a)
        sched.submit(_req(req, 0))
        sched.submit(_req(req, 1))
        slots = {r.uid: s for r, s in sched.admit(now=0)}
        a.park(slots[0])
        a.park(slots[1])
        a.touch(slots[0])
        sched.submit(_req(req, 2))
        assert _uids(sched.admit(now=1)) == [2]
        assert a.pages.preemptions == 1
        victims.append(sorted(a._swapped))
    assert victims[0] == victims[1] == [1]
    np.testing.assert_array_equal(arena.pages.model_table,
                                  jarena.pages.model_table)


def test_aging_bounds_starvation_under_page_pressure_like_jax(pair):
    arena, jarena = _paged_arenas(pair, model_blocks=3, tree_blocks=2)
    trace = []
    for a, req, cls in ((arena, Request, DynamicBatchScheduler),
                        (jarena, JaxRequest, JaxScheduler)):
        sched = cls(a, aging=4)
        sched.submit(_req(req, 0))
        first = sched.admit(now=0)
        sched.submit(_req(req, 1))
        blocked = sched.admit(now=1)
        pending = sched.pending
        sched.retire(0, first[0][1], now=3)
        sched.submit(_req(req, 2, arrival=4, priority=1))
        trace.append((_uids(first), blocked, pending,
                      _uids(sched.admit(now=4))))
    assert trace[0] == trace[1] == ([0], [], 1, [1])


def test_int8_paged_db_matches_jax(pair):
    """The int8 pair (both bundles quantized) on the paged arena: tokens,
    stats and dispatch counts equal the JAX package's int8 paged DB, and
    the tokens equal the port's int8 single-request engine."""
    target, jtarget = (b.quantize() for b in pair["target"])
    draft, jdraft = (b.quantize() for b in pair["draft"])
    rng = np.random.default_rng(5)
    reqs = [Request(i, rng.integers(0, 100, size=n), m, arrival_t=a)
            for i, (n, m, a) in enumerate(((5, 4, 0), (7, 5, 1), (4, 3, 2)))]
    pcfg, jpcfg = PipeDecConfig(*PCFG), JaxPipeDecConfig(*PCFG)
    ex = LocalFusedExecutor(target, draft, slots=2, max_len=MAX_LEN,
                            tree_capacity=pcfg.tree_buffer_capacity,
                            capacity=pcfg.capacity, paged=True, page=16)
    eng = SpecPipeDBEngine(target, draft, pcfg, max_len=MAX_LEN,
                           max_slots=2, executor=ex)
    jex = JaxLocalFusedExecutor(
        jtarget, jdraft, slots=2, max_len=MAX_LEN,
        tree_capacity=jpcfg.tree_buffer_capacity, capacity=jpcfg.capacity,
        paged=True, page=16)
    jeng = JaxSpecPipeDBEngine(jtarget, jdraft, jpcfg, max_len=MAX_LEN,
                               max_slots=2, executor=jex)
    for r in reqs:
        eng.submit(r)
        jeng.submit(JaxRequest(r.uid, r.prompt.astype(np.int32),
                               r.max_new_tokens, arrival_t=r.arrival_t))
    res, jres = eng.run(), jeng.run()
    single = PipeDecEngine(target, draft, pcfg, max_len=MAX_LEN)
    for r in reqs:
        np.testing.assert_array_equal(res[r.uid].tokens, jres[r.uid].tokens)
        np.testing.assert_array_equal(
            res[r.uid].tokens,
            single.generate(r.prompt, r.max_new_tokens)[0])
    assert eng.stats.timesteps == jeng.stats.timesteps
    assert (eng.stats.accepted, eng.stats.proposed) == \
        (jeng.stats.accepted, jeng.stats.proposed)
    for key in ("verify_rows", "commit_rows", "remap_rows"):
        assert ex.calls[key] == jex.calls[key], key
    leaf = ex.arena.stacked[0][0]
    assert set(leaf) == {"k", "v", "k_scale", "v_scale"}
    assert leaf["k"].pages.dtype == torch.int8
    assert leaf["k_scale"].table is leaf["k"].table


def test_lazy_tree_grows_like_jax(pair):
    """``lazy_tree`` backs one tree row at bind and grows the tree region
    block by block (copy-on-expand events), with the JAX arena's tables."""
    arena, jarena = _paged_arenas(pair, lazy_tree=True)
    for a, req in ((arena, Request), (jarena, JaxRequest)):
        slot = a.alloc()
        a.bind(slot, _req(req, 0))
        assert a.pages.blocks_of("tree", slot) == 1
        a.ensure_tree(slot, 9)
        a.ensure_tree(slot, 40)          # capped at tree_capacity
    np.testing.assert_array_equal(arena.pages.tree_table,
                                  jarena.pages.tree_table)
    assert arena.pages.counters() == jarena.pages.counters()
    assert arena.pages.expand_copies == 1
    np.testing.assert_array_equal(arena.stacked[2][0]["k"].table.numpy(),
                                  arena.pages.tree_table)


def test_arena_bytes_like_jax(pair):
    """KV bytes per slot, fp32 and int8, equal the JAX arena's (the int8
    layout holds a slot in under 0.55x the fp32 bytes)."""
    (t, jt), (d, jd) = pair["target"], pair["draft"]
    got, want = [], []
    for (pt, pd), (qt, qd) in (((t, d), (jt, jd)),
                               ((t.quantize(), d.quantize()),
                                (jt.quantize(), jd.quantize()))):
        got.append(KVArena(pt, pd, slots=2, max_len=64,
                           tree_capacity=16).bytes_per_slot())
        want.append(JaxKVArena(qt, qd, slots=2, max_len=64,
                               tree_capacity=16).bytes_per_slot())
    assert got == want and got[1] <= 0.55 * got[0]
