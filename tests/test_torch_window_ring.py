"""The window override on the port's stage ring, at smoke size on bridged
weights, on the CPU with the kernels' plain versions: Qwen 2.5 (QKV bias)
and Gemma (GeGLU), a 4-key window against prompts and prefixes past it.

Held here:
  * the flush (``make_pipeline_verify(window_override=)``) over a live
    row, an empty row and another live row against the JAX
    ``tree_verify_step(window_override=)``: logits and every layer's tree
    rows within 1e-5;
  * the reference-side limit: the JAX ring's stage functions build their
    layers' context with no override, so the reference's ring verifies
    with the config's window (its stage output equals ``tree_verify_step``
    without the override and differs from it with one).  The port's ring
    takes the bundle's override, as its local engines do, so it is held
    to the JAX step function and not to the JAX stage functions;
  * single == local == flush == overlapped == async in tokens and
    GenStats for bundles with the override, dense and paged, and the
    overlapped ring's prefill lane off (``prefill_cap`` 0, every request
    prefilled by a separate dispatch), as the reference turns it off.
"""
import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import pipeline as jpl
from repro.models import transformer as jtf
from repro_torch.core.pipedec import PipeDecEngine
from repro_torch.core.speculative import ModelBundle
from repro_torch.launch import pipeline as pl
from repro_torch.models import transformer as tf
from repro_torch.models.layers import embed
from repro_torch.serving import Request
from test_torch_pipeline import CAP, TOL, W, _caches, _torch
from test_torch_ring_families import (MAX_LEN, PCFG, _db, _executor, _pair,
                                      _serve, _stats)

WO = 4
KV_LEN = 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree_layer(cfg, mlen, seed):
    """Random caches and one tree layer a row over ``mlen`` committed rows
    (0: an empty row, not pending, an all-false mask)."""
    b = len(mlen)
    rng = np.random.default_rng(seed)
    kv_np = _caches(rng, cfg, b, KV_LEN, cfg.num_layers)
    tkv_np = _caches(rng, cfg, b, CAP + W, cfg.num_layers)
    live = mlen > 0
    wi = np.where(live, rng.integers(0, CAP - W, size=b), CAP)
    pos = np.where(live[:, None],
                   mlen[:, None] + rng.integers(0, 3, size=(b, W)), 0)
    mask = rng.random((b, W, CAP + W)) < 0.4
    mask[np.arange(b), :, wi] = True
    mask &= live[:, None, None]
    tokens = rng.integers(0, cfg.vocab_size, size=(b, W))
    return kv_np, tkv_np, live, wi, pos, mask, tokens


def _jax_verify(jt, layer, mlen, window_override):
    """(logits, tree caches) of the JAX ``tree_verify_step`` over
    ``layer`` (``_tree_layer``) with ``window_override``."""
    kv_np, tkv_np, _, wi, pos, mask, tokens = layer
    stack = [{k: jnp.asarray(np.stack([c[k] for c in caches]))
              for k in "kv"} for caches in (kv_np, tkv_np)]
    return jtf.tree_verify_step(
        jt.params, jt.cfg, jnp.asarray(tokens, jnp.int32),
        jnp.asarray(pos, jnp.int32), jnp.asarray(mask),
        {"stack": [stack[0]]}, jnp.asarray(mlen, jnp.int32),
        {"stack": [stack[1]]}, jnp.asarray(wi, jnp.int32),
        window_override=window_override)


@pytest.mark.parametrize("arch,stages", [("qwen2.5-32b", 2),
                                         ("gemma-7b", 2), ("gemma-7b", 3)])
def test_flush_matches_jax_tree_verify_with_override(arch, stages):
    """The flush with the bundle's override (3 stages of 2 layers: the
    last holds only padding) against the JAX ``tree_verify_step`` with the
    same override over every row; without the override the logits
    differ, so the window bites at these lengths."""
    t, jt = _pair(arch)["target"]
    cfg = t.cfg
    mlen = np.array([9, 0, 14])
    layer = _tree_layer(cfg, mlen, seed=stages)
    kv_np, tkv_np, live, wi, pos, mask, tokens = layer
    want, jtree = _jax_verify(jt, layer, mlen, WO)
    kv_t, tkv_t = _torch(kv_np), _torch(tkv_np)
    calls = collections.Counter()
    verify = pl.make_pipeline_verify(
        cfg, pl.PipelineConfig(stages, W, CAP, KV_LEN), calls=calls,
        window_override=WO)
    layers, valid = pl.stage_params(t.model, stages)
    entry = {"act": embed(t.model.embed.table, torch.tensor(tokens)),
             "positions": torch.tensor(pos), "mask": torch.tensor(mask),
             "model_len": torch.tensor(mlen, dtype=torch.int32),
             "lens": mlen, "write_idx": wi, "valid": live}
    act, exit_valid = verify(layers, valid, pl.split_stages(kv_t, stages),
                             pl.split_stages(tkv_t, stages), entry)
    np.testing.assert_array_equal(exit_valid, live)
    got = tf._logits(t.model, act).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=TOL)
    for i in range(cfg.num_layers):
        for k in "kv":
            np.testing.assert_allclose(
                tkv_t[i][k].numpy(), np.asarray(jtree["stack"][0][k][i]),
                rtol=0, atol=TOL)
    assert calls["stage_layers"] == cfg.num_layers
    free, _ = _jax_verify(jt, layer, mlen, -1)
    assert np.abs(np.asarray(free) - got)[live].max() > 1e-3


def test_reference_ring_verifies_with_the_config_window():
    """The reference-side limit, pinned: the JAX ring's ``stage_apply``
    on one stage of every layer gives the JAX ``tree_verify_step``
    without the override (its stage functions build their context with
    none), not the one with it; the port's stage function with the
    override gives the latter."""
    (t, jt) = _pair("qwen2.5-32b")["target"]
    cfg, jcfg = t.cfg, jt.cfg
    mlen = np.array([9, 12])
    layer = _tree_layer(cfg, mlen, seed=7)
    kv_np, tkv_np, live, wi, pos, mask, tokens = layer
    with_wo, _ = _jax_verify(jt, layer, mlen, WO)
    without, _ = _jax_verify(jt, layer, mlen, -1)
    j_apply, _, _ = jpl.make_stage_fns(
        jcfg, jpl.PipelineConfig(1, W, CAP, KV_LEN))
    jlayers, jvalid = jpl.stage_params(jcfg, jt.params, 1)
    sp = [jax.tree.map(lambda v: v[0], lp) for lp in jlayers]
    x = jtf.embed(jt.params["embed"], jnp.asarray(tokens, jnp.int32))
    xj, _ = j_apply(sp, jvalid[0],
                    [{k: jnp.asarray(c[k]) for k in "kv"} for c in kv_np],
                    [{k: jnp.asarray(c[k]) for k in "kv"} for c in tkv_np],
                    x, jnp.asarray(pos), jnp.asarray(mask), jnp.asarray(wi),
                    jnp.asarray(mlen), jnp.asarray(live))
    ring_logits = np.asarray(jtf._logits(jt.params, jcfg, xj))
    np.testing.assert_allclose(ring_logits, np.asarray(without), rtol=0,
                               atol=TOL)
    assert np.abs(ring_logits - np.asarray(with_wo)).max() > 1e-3
    apply, _, _ = pl.make_stage_fns(cfg, pl.PipelineConfig(1, W, CAP,
                                                           KV_LEN),
                                    window_override=WO)
    layers, valid = pl.stage_params(t.model, 1)
    xt = apply(layers[0], valid[0], _torch(kv_np), _torch(tkv_np),
               embed(t.model.embed.table, torch.tensor(tokens)),
               torch.tensor(pos), torch.tensor(mask), wi,
               torch.tensor(mlen, dtype=torch.int32), live)
    np.testing.assert_allclose(tf._logits(t.model, xt).numpy(),
                               np.asarray(with_wo), rtol=0, atol=TOL)


def _requests():
    """3 requests on 2 slots, arrivals 0, 0, 3, prompts of 6-10 tokens:
    past the 4-key window."""
    rng = np.random.default_rng(4)
    return [Request(i, rng.integers(0, 100, size=int(rng.integers(6, 11))),
                    n, arrival_t=t)
            for i, (n, t) in enumerate(((6, 0), (5, 0), (6, 3)))]


@pytest.mark.parametrize("paged", [False, True])
def test_tower_with_override(paged):
    """Qwen 2.5's smoke pair, both bundles with a 4-key override, on the
    2-stage ring: every request's tokens and GenStats are the
    single-request engine's on the local, flush, overlapped and (dense)
    async executors; the flush's DBStats equal the local run's; the
    overlapped ring's lane is off and each request is prefilled by one
    separate dispatch; the ring applies its layers once per flush."""
    b = _pair("qwen2.5-32b")
    t = ModelBundle(b["target"][0].model, window_override=WO)
    d = ModelBundle(b["draft"][0].model, window_override=WO)
    reqs = _requests()
    single = PipeDecEngine(t, d, PCFG, max_len=MAX_LEN)
    want = {r.uid: single.generate(r.prompt, r.max_new_tokens)
            for r in reqs}
    free = PipeDecEngine(ModelBundle(t.model), ModelBundle(d.model), PCFG,
                         max_len=MAX_LEN)
    assert any(not np.array_equal(free.generate(r.prompt,
                                                r.max_new_tokens)[0],
                                  want[r.uid][0]) for r in reqs)
    kinds = ("local", "flush", "overlapped") + (() if paged else ("async",))
    runs = {}
    for kind in kinds:
        ex = _executor(kind, t, d, PCFG, 2, paged=paged)
        eng, res = _serve(ex, t, d, PCFG, reqs)
        runs[kind] = eng, ex
        for uid, (tokens, stats) in want.items():
            np.testing.assert_array_equal(res[uid].tokens, tokens,
                                          err_msg=f"{kind} uid {uid}")
            assert _stats(res[uid].stats) == _stats(stats), (kind, uid)
    assert _db(runs["flush"][0].stats) == _db(runs["local"][0].stats)
    eng, ex = runs["overlapped"]
    assert ex.prefill_cap == 0
    assert ex.calls["prefill_in_ring"] == 0
    assert eng.stats.separate_prefill_dispatches == len(reqs)
    eng, ex = runs["flush"]
    assert ex.calls["stage_layers"] == t.cfg.num_layers * \
        ex.calls["pipeline_verify"]
