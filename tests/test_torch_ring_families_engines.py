"""The port's ring executors against the JAX engines on the families,
at smoke size on bridged weights: the async executor against the JAX
``AsyncPipelineExecutor`` engine (Qwen-MoE, Gemma, Qwen 2.5), and
Qwen-MoE at capacity factor 0.25 on F2's workload
(``test_torch_family_db``), where expert copies drop, so the rows routed
together in one call decide each other's values: the flush and the
async executor give the JAX local engine's tokens (the ring computes a
bucket's empty rows with the reference's value, as the local verify
does); the overlapped ring gives them with its prefill lane off and
parts from them through the lane, whose padded batch equals the JAX
``stage_prefill``'s.  The bundles and serving helpers are
``test_torch_ring_families``'s.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.pipedec import PipeDecConfig as JaxPipeDecConfig
from repro.launch import pipeline as jpl
from repro.models import transformer as jtf
from repro.serving import AsyncPipelineExecutor as JaxAsyncPipelineExecutor
from repro.serving import LocalFusedExecutor as JaxLocalFusedExecutor
from repro_torch.core.pipedec import PipeDecConfig
from repro_torch.launch import pipeline as pl
from repro_torch.models.layers import embed
from repro_torch.serving import Request
from repro_torch.serving.executor import PREFILL_LANE
from test_torch_family_db import _drop_requests
from test_torch_pipeline import (CAP, TOL, W, _by_stage_np, _caches, _jax,
                                 _np, _torch)
from test_torch_ring_families import (JPCFG, KV_LEN, PCFG, TIMEOUT_S,
                                      _executor, _jax_serve, _pair, _serve,
                                      _stats, flush_against_jax)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "gemma-7b",
                                  "qwen2.5-32b"])
def test_async_matches_jax_async_engine(arch):
    """The JAX ``AsyncPipelineExecutor`` engine and the port's (2 stages, 2
    slots, 4 requests arriving at 0, 1, 4, 6) commit the same tokens with
    the same GenStats, acceptance and entry messages."""
    b = _pair(arch)
    (t, _), (d, _) = b["target"], b["draft"]
    rng = np.random.default_rng(11)
    reqs = [Request(i, rng.integers(0, 100, size=int(rng.integers(3, 8))),
                    n, arrival_t=at)
            for i, (n, at) in enumerate(((4, 0), (5, 1), (3, 4), (4, 6)))]
    _, jres, jex = _jax_serve(JaxAsyncPipelineExecutor, arch, reqs, JPCFG,
                              2, n_stages=2, timeout_s=TIMEOUT_S)
    ex = _executor("async", t, d, PCFG, 2)
    eng, res = _serve(ex, t, d, PCFG, reqs)
    for uid in jres:
        np.testing.assert_array_equal(res[uid].tokens, jres[uid].tokens)
        assert _stats(res[uid].stats) == _stats(jres[uid].stats), uid
    assert ex.calls["entry_msgs"] == jex.calls["entry_msgs"]


DROP_PCFG = PipeDecConfig(3, 8, 4)
DROP_MAX_LEN = 128


def _drop_reqs():
    return [Request(uid, p, n, arrival_t=at)
            for uid, p, n, at in _drop_requests()]


@functools.lru_cache(maxsize=None)
def _jax_drop_tokens():
    tokens, _, _ = _jax_serve(JaxLocalFusedExecutor, "qwen2-moe-a2.7b",
                              _drop_reqs(), JaxPipeDecConfig(3, 8, 4), 4,
                              max_len=DROP_MAX_LEN, capacity_factor=0.25)
    return tokens


@pytest.mark.parametrize("stages", [2, 3])
def test_capacity_drops_flush_with_empty_row_matches_jax(stages):
    """Qwen-MoE at capacity factor 0.25: an empty row ahead of three live
    ones (an idle slot 0) routes its identical tokens first, so through
    every layer its value decides which of the live rows' expert copies
    drop.  The flush computes it there as the JAX ``tree_verify_step``
    does (``pipeline.computed_rows``, ``empty=``): every row's logits and
    tree rows within 1e-5."""
    t, jt = _pair("qwen2-moe-a2.7b", 0.25)["target"]
    flush_against_jax(t, jt, stages, np.array([0, 6, 11, 9]), seed=stages)


def _kill_in_flight(t, seed, kill):
    """Exit activations of one entry of four live rows through the 2-stage
    lockstep tick, ``kill`` [B] applied before stage 1."""
    cfg = t.cfg
    rng = np.random.default_rng(seed)
    mlen = np.array([6, 11, 9, 7])
    kv_np = _caches(rng, cfg, 4, KV_LEN, cfg.num_layers)
    tkv_np = _caches(rng, cfg, 4, CAP + W, cfg.num_layers)
    wi = rng.integers(0, CAP - W, size=4)
    pos = mlen[:, None] + rng.integers(0, 3, size=(4, W))
    mask = rng.random((4, W, CAP + W)) < 0.4
    mask[np.arange(4), :, wi] = True
    tokens = rng.integers(0, cfg.vocab_size, size=(4, W))
    pcfg = pl.PipelineConfig(2, W, CAP, KV_LEN)
    tick = pl.make_pipedec_tick(cfg, pcfg)
    layers, valid = pl.stage_params(t.model, 2)
    kv = pl.split_stages(_torch(kv_np), 2)
    tkv = pl.split_stages(_torch(tkv_np), 2)
    entry = {"act": embed(t.model.embed.table, torch.tensor(tokens)),
             "positions": torch.tensor(pos), "mask": torch.tensor(mask),
             "model_len": torch.tensor(mlen, dtype=torch.int32),
             "lens": mlen, "write_idx": wi, "valid": np.ones(4, bool)}
    ring, _ = tick(layers, valid, kv, tkv, pl.init_ring(pcfg, 4), entry)
    _, out = tick(layers, valid, kv, tkv, ring, kill=kill)
    np.testing.assert_array_equal(out["valid"], ~kill)
    return _np(out["act"])


@pytest.mark.parametrize("seed", [0, 1])
def test_kill_in_flight_leaves_live_rows_under_drops(seed):
    """Qwen-MoE at capacity factor 0.25: an entry whose row 1 is killed
    between stage 0 and stage 1 exits its live rows bit for bit as with
    no kill.  The rows routed together decide each other's drops, so the
    ring computes a killed row as the local verify computed it, and the
    live rows do not hang on where a kill caught their layer (on the async
    executor, on the actors' timing)."""
    t, _ = _pair("qwen2-moe-a2.7b", 0.25)["target"]
    kill = np.array([False, True, False, False])
    got = _kill_in_flight(t, seed, kill)
    want = _kill_in_flight(t, seed, np.zeros(4, bool))
    np.testing.assert_array_equal(got[~kill], want[~kill])


@pytest.mark.parametrize("kind,paged", [("flush", False), ("flush", True),
                                        ("async", False)])
def test_capacity_drops_match_jax_local_engine(kind, paged):
    """Qwen-MoE at capacity factor 0.25 on F2's workload (5 requests of
    20-39 tokens on 4 slots, arrivals 0, 0, 0, 1, 3, PipeDecConfig(3, 8,
    4), 3 stages with the last one padding): a bucket's rows share every
    expert's capacity, so its empty rows must be computed through every
    layer with the reference's value, as the local verify computes them.
    Tokens equal the JAX local engine's."""
    b = _pair("qwen2-moe-a2.7b", 0.25)
    (t, _), (d, _) = b["target"], b["draft"]
    ex = _executor(kind, t, d, DROP_PCFG, 4, paged=paged,
                   max_len=DROP_MAX_LEN)
    _, res = _serve(ex, t, d, DROP_PCFG, _drop_reqs(), max_len=DROP_MAX_LEN)
    want = _jax_drop_tokens()
    assert set(res) == set(want)
    for uid in want:
        np.testing.assert_array_equal(res[uid].tokens, want[uid],
                                      err_msg=f"uid {uid}")


def test_capacity_drops_overlapped_ring_parts_only_through_its_lane():
    """The overlapped ring at capacity factor 0.25 on the same workload.
    With its prefill lane off (admission through the separate prefill)
    it gives the JAX local engine's tokens, through dozens of kills.  With
    the lane on it does not: the lane routes the joining slots' padded
    64-token chunks through the MoE router together, so pad tokens and
    other prompts share each expert's capacity with a prompt that the
    local engine prefills alone.  That is the reference's own lane (its
    overlapped ring prefills in the same padded batch, and
    ``test_lane_batch_matches_jax_stage_prefill`` holds the port's lane
    to its ``stage_prefill``); this pins where the port's ring parts from
    the local engine under drops."""
    b = _pair("qwen2-moe-a2.7b", 0.25)
    (t, _), (d, _) = b["target"], b["draft"]
    want = _jax_drop_tokens()
    same = {}
    for lane in (True, False):
        ex = _executor("overlapped", t, d, DROP_PCFG, 4,
                       max_len=DROP_MAX_LEN)
        if not lane:
            ex.prefill_cap = 0
            ex._reset_prefill()
        eng, res = _serve(ex, t, d, DROP_PCFG, _drop_reqs(),
                          max_len=DROP_MAX_LEN)
        assert ex.calls["prefill_in_ring"] == (len(want) if lane else 0)
        assert ex.calls["kill"] > len(want)         # misses and retires
        same[lane] = [np.array_equal(res[u].tokens, want[u]) for u in want]
    assert all(same[False])
    assert not all(same[True])


@pytest.mark.parametrize("capacity_factor", [0.25, None])
def test_lane_batch_matches_jax_stage_prefill(capacity_factor):
    """The second witness for the lane-on result above (the JAX overlapped
    ring cannot run under this jax: its mesh pins fail, ROADMAP section
    3).  The lane batch of that workload's first tick (the three prompts
    arriving at 0, each zero-padded to the 64-token lane, slot 3 all token
    0 and off) through the port's ``stage_prefill`` and the JAX one: equal
    within 1e-5, so the port's lane computes the reference's.  At capacity
    factor 0.25 the reference's lane gives each prompt's last position
    other logits than the reference's ``prefill`` of that prompt alone
    (the local engine's admission) by more than 0.05; dropless, the same
    within 1e-4."""
    t, jt = _pair("qwen2-moe-a2.7b", capacity_factor)["target"]
    cfg, jcfg = t.cfg, jt.cfg
    n = cfg.num_layers
    prompts = [p for _, p, _, at in _drop_requests() if at == 0]
    tokens = np.zeros((4, PREFILL_LANE), np.int64)
    for r, p in enumerate(prompts):
        tokens[r, :len(p)] = p
    on = np.arange(4) < len(prompts)
    off = np.zeros(4, np.int64)
    x = _np(embed(t.model.embed.table, torch.tensor(tokens)))
    kv_np = _caches(np.random.default_rng(0), cfg, 4, DROP_MAX_LEN, n)
    shape = (1, DROP_PCFG.width, DROP_PCFG.capacity, DROP_MAX_LEN)
    _, _, j_prefill = jpl.make_stage_fns(jcfg, jpl.PipelineConfig(*shape))
    _, _, prefill = pl.make_stage_fns(cfg, pl.PipelineConfig(*shape))
    jlayers, jvalid = jpl.stage_params(jcfg, jt.params, 1)
    tlayers, tvalid = pl.stage_params(t.model, 1)
    new_kv, xj = j_prefill([jax.tree.map(lambda a: a[0], lp)
                            for lp in jlayers], jvalid[0],
                           _jax(_by_stage_np(kv_np, 0, n)), jnp.asarray(x),
                           jnp.asarray(on), jnp.asarray(off))
    kv_t = pl.split_stages(_torch(kv_np), 1)[0]
    xt = prefill(tlayers[0], tvalid[0], kv_t, torch.tensor(x), on, off)
    np.testing.assert_allclose(_np(xt)[on], np.asarray(xj)[on], rtol=0,
                               atol=TOL)
    for i in range(n):
        for k in "kv":
            np.testing.assert_allclose(_np(kv_t[i][k])[on],
                                       np.asarray(new_kv[i][k])[on],
                                       rtol=0, atol=TOL)
    for r, p in enumerate(prompts):
        lane = jtf._logits(jt.params, jcfg, xj[r, len(p) - 1][None])
        alone, _ = jt.prefill(jnp.asarray(p, jnp.int32)[None],
                              jt.init_cache(1, DROP_MAX_LEN))
        diff = float(np.abs(np.asarray(lane) - np.asarray(alone)).max())
        if capacity_factor is None:
            assert diff < 1e-4, (r, diff)
        else:
            assert diff > 0.05, (r, diff)
