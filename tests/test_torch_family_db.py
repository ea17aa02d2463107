"""SpecPipe-DB over the MoE and MLA families: the port's
``SpecPipeDBEngine`` on the local executor, dense and paged arenas, for
the DeepSeek-V2 and Moonlight smoke models against the JAX
``SpecPipeDBEngine`` (tokens, per-request ``GenStats``, occupancy, the
executor's counts, page counters) and against autoregressive decoding, at
dropless MoE capacity (``test_torch_moe.bundles``); and at a capacity
that drops expert copies, where the rows of a bucket's empty slots reach
the router beside the live rows: the tree-verify row of an empty slot
(no committed prefix, an all-false mask) against the reference's, then
the engines' tokens for Moonlight, Qwen-MoE and DeepSeek.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jreg
from repro.core.pipedec import PipeDecConfig as JaxPipeDecConfig
from repro.models import transformer as jtf
from repro.serving import LocalFusedExecutor as JaxLocalFusedExecutor
from repro.serving import Request as JaxRequest
from repro.serving import SpecPipeDBEngine as JaxSpecPipeDBEngine
from repro_torch.core.baselines import generate_autoregressive
from repro_torch.checkpoint import from_jax_params
from repro_torch.core.pipedec import PipeDecConfig
from repro_torch.models import paging
from repro_torch.models import transformer as tf
from repro_torch.serving import (LocalFusedExecutor, Request,
                                 SpecPipeDBEngine)
from test_torch_families import family_params, port_cfg
from test_torch_moe import bundles

STATS = ("timesteps", "commits", "hits", "misses", "entries",
         "commits_per_step")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _requests(seed):
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(0, 100, size=int(rng.integers(3, 9))), n, t)
            for i, (n, t) in enumerate(((5, 0), (4, 0), (6, 3)))]


@pytest.mark.parametrize("arch,paged,self_draft", [
    ("deepseek-v2-236b", False, False), ("deepseek-v2-236b", True, False),
    ("moonshot-v1-16b-a3b", False, False),
    ("moonshot-v1-16b-a3b", True, False),
    ("deepseek-v2-236b", True, True)])
def test_db_matches_jax_engine(arch, paged, self_draft):
    """3 requests on 2 slots with a staggered arrival: tokens, per-request
    GenStats, the occupancy trace and the executor's counts equal the JAX
    engine's, on the dense and the paged arena (MLA's compressed rows
    paged like K/V).  With the target as its own draft every prediction
    hits, so the batched commit and prune remap move MLA rows."""
    b = bundles(arch, 1)
    (target, jtarget), (draft, jdraft) = b["target"], (
        b["target"] if self_draft else b["draft"])
    pcfg, jpcfg = PipeDecConfig(3, 4, 2), JaxPipeDecConfig(3, 4, 2)
    ex = LocalFusedExecutor(target, draft, slots=2, max_len=128,
                            tree_capacity=pcfg.tree_buffer_capacity,
                            capacity=pcfg.capacity, paged=paged, page=16)
    eng = SpecPipeDBEngine(target, draft, pcfg, max_len=128, max_slots=2,
                           executor=ex)
    jex = JaxLocalFusedExecutor(jtarget, jdraft, slots=2, max_len=128,
                                tree_capacity=jpcfg.tree_buffer_capacity,
                                capacity=jpcfg.capacity, paged=paged,
                                page=16)
    jeng = JaxSpecPipeDBEngine(jtarget, jdraft, jpcfg, max_len=128,
                               max_slots=2, executor=jex)
    for uid, prompt, n, t in _requests(3):
        eng.submit(Request(uid, prompt, n, arrival_t=t))
        jeng.submit(JaxRequest(uid, prompt.astype(np.int32), n,
                               arrival_t=t))
    res, jres = eng.run(), jeng.run()
    assert set(res) == set(jres) == {0, 1, 2}
    for uid, prompt, n, _ in _requests(3):
        np.testing.assert_array_equal(res[uid].tokens, jres[uid].tokens)
        np.testing.assert_array_equal(
            res[uid].tokens, generate_autoregressive(target, prompt, n,
                                                     max_len=128))
        assert {k: getattr(res[uid].stats, k) for k in STATS} == \
            {k: getattr(jres[uid].stats, k) for k in STATS}
    assert eng.stats.occupancy == jeng.stats.occupancy
    for key in ("verify_rows", "commit_rows", "remap_rows"):
        assert ex.calls[key] == jex.calls[key], key
    if paged:
        assert eng.stats.page_counters == jeng.stats.page_counters
    if self_draft:
        assert eng.stats.acceptance_rate == 1.0 and ex.calls["remap_rows"]


def _drop_requests():
    rng = np.random.default_rng(11)
    return [(i, rng.integers(0, 100, size=int(rng.integers(20, 40))), 8, t)
            for i, t in enumerate((0, 0, 0, 1, 3))]


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "qwen2-moe-a2.7b",
                                  "deepseek-v2-236b"])
def test_db_matches_jax_engine_under_capacity_drops(arch, paged):
    """MoE capacity factor 0.25 (expert copies drop), 5 requests of 20-39
    prompt tokens on 4 slots, arrivals 0, 0, 0, 1, 3, PipeDecConfig(3, 8,
    4): buckets hold empty slots, whose fully masked rows reach the MoE
    router beside the live rows, so the port must give them the
    reference's value.  Tokens, GenStats and occupancy equal the JAX
    engine's, dense and paged."""
    b = bundles(arch, 1, capacity_factor=0.25)
    (target, jtarget), (draft, jdraft) = b["target"], b["draft"]
    pcfg, jpcfg = PipeDecConfig(3, 8, 4), JaxPipeDecConfig(3, 8, 4)
    ex = LocalFusedExecutor(target, draft, slots=4, max_len=128,
                            tree_capacity=pcfg.tree_buffer_capacity,
                            capacity=pcfg.capacity, paged=paged, page=16)
    eng = SpecPipeDBEngine(target, draft, pcfg, max_len=128, max_slots=4,
                           executor=ex)
    jex = JaxLocalFusedExecutor(jtarget, jdraft, slots=4, max_len=128,
                                tree_capacity=jpcfg.tree_buffer_capacity,
                                capacity=jpcfg.capacity, paged=paged,
                                page=16)
    jeng = JaxSpecPipeDBEngine(jtarget, jdraft, jpcfg, max_len=128,
                               max_slots=4, executor=jex)
    for uid, prompt, n, t in _drop_requests():
        eng.submit(Request(uid, prompt, n, arrival_t=t))
        jeng.submit(JaxRequest(uid, prompt.astype(np.int32), n,
                               arrival_t=t))
    res, jres = eng.run(), jeng.run()
    assert set(res) == set(jres) == set(range(5))
    for uid in res:
        np.testing.assert_array_equal(res[uid].tokens, jres[uid].tokens)
        assert {k: getattr(res[uid].stats, k) for k in STATS} == \
            {k: getattr(jres[uid].stats, k) for k in STATS}
    assert eng.stats.occupancy == jeng.stats.occupancy


@pytest.mark.parametrize("paged", [False, True])
def test_empty_row_equals_reference_tree_verify_row(paged):
    """Row 1 has no committed prefix (cache_len 0) and an all-false tree
    mask: the reference's joint softmax gives it uniform weights over
    every past and tree row (stale values included), the kernels' plain
    twins 0; the port's tree verify gives the reference's logits for both
    rows.  Paged: row 1's table is the null block (filled with noise) and
    the reference reads the dense views gathered through the tables, as
    its SpecPipe-DB dispatch does."""
    jcfg = jreg.get_config("qwen2.5-32b", smoke=True)
    params = family_params(jcfg, seed=4)
    cfg = port_cfg(jcfg)
    model = from_jax_params(cfg, params, device="cpu")
    rng = np.random.default_rng(5)
    b, n, max_len, tcap, page = 2, 4, 32, 16, 8
    cache = [{k: torch.as_tensor(rng.normal(size=(b, max_len, cfg.num_kv_heads,
                                                  cfg.resolved_head_dim)),
                                 dtype=torch.float32) for k in ("k", "v")}
             for _ in range(cfg.num_layers)]
    tree = [{k: torch.as_tensor(rng.normal(size=(b, tcap, cfg.num_kv_heads,
                                                 cfg.resolved_head_dim)),
                                dtype=torch.float32) for k in ("k", "v")}
            for _ in range(cfg.num_layers)]
    if paged:
        def pg(dense, blocks):
            p = paging.make_paged(dense, [list(range(1, blocks + 1)),
                                          [0] * blocks], page)
            p.pages[:page] = torch.as_tensor(rng.normal(
                size=p.pages[:page].shape), dtype=torch.float32)
            return p
        cache = [{k: pg(v, max_len // page) for k, v in c.items()}
                 for c in cache]
        tree = [{k: pg(v, tcap // page) for k, v in c.items()}
                for c in tree]
    dense = [[{k: np.asarray(paging.to_dense(v) if paged else v)
               for k, v in c.items()} for c in caches]
             for caches in (cache, tree)]
    stack = [{k: np.stack([c[k] for c in d]) for k in ("k", "v")}
             for d in dense]
    tokens = rng.integers(0, cfg.vocab_size, (b, n)).astype(np.int32)
    pos = np.array([[20, 21, 21, 22], [0, 0, 0, 0]], np.int32)
    mask = np.zeros((b, n, tcap), bool)
    mask[0, :, :3] = True
    cache_len, write_at = np.array([20, 0], np.int32), [3, 8]
    want, _ = jtf.tree_verify_step(
        jax.tree.map(jnp.asarray, params), jcfg, jnp.asarray(tokens),
        jnp.asarray(pos), jnp.asarray(mask), {"stack": [stack[0]]},
        jnp.asarray(cache_len), {"stack": [stack[1]]},
        jnp.asarray(write_at, np.int32))
    got, _ = tf.tree_verify_step(model, tokens, pos, mask, cache, cache_len,
                                 tree, write_at)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)
