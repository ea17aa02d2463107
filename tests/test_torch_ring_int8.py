"""int8 bundles (``ModelBundle.quantize()``) on the port's stage ring: the
stage functions against the JAX package's ``make_stage_fns`` on quantized
bridged weights, and the int8 flush, overlapped and async executors
against the int8 local executor.

Tolerances.  The two packages quantize the same fp32 weights to the same
int8 bits, but K/V rows are quantized at run time from activations whose
fp32 sums run in another order, so a value at a rounding tie may land one
int8 step apart (amax/127 of its row): activations are held within 1e-3
(``tests/test_torch_quant_model.py``'s int8 tolerance), cached int8 values
within one step and their row scales within 1e-4 relative.  A ctrl
message copies and permutes rows, so on the same input rows it is exact.
Within the port the flush computes what the local executor computes, so
there tokens, GenStats and the logits of every committed token are held
bit for bit, dense and paged; the overlapped ring prefills through its
lane's chunk attention over the cache instead of a prefill over the
prompt's rows, so there tokens and GenStats are held exactly and logits
are not compared.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.speculative import ModelBundle as JaxBundle
from repro.launch import pipeline as jpl
from repro.models.config import ModelConfig as JaxModelConfig
from repro_torch.checkpoint import from_jax_params
from repro_torch.core import pipedec as pipedec_mod
from repro_torch.core.pipedec import PipeDecConfig, PipeDecEngine
from repro_torch.core.speculative import ModelBundle
from repro_torch.launch import pipeline as pl
from repro_torch.models.config import ModelConfig
from repro_torch.serving import (AsyncPipelineExecutor, LocalFusedExecutor,
                                 OverlappedShardedExecutor, Request,
                                 ShardedPipelineExecutor, SpecPipeDBEngine)

W, CAP, MAX_LEN, PCAP = 4, 16, 32, 8   # width, tree nodes, rows, lane
ACT_TOL = 1e-3
SCALE_RTOL = 1e-4
DB_MAX_LEN = 160
STATS = ("timesteps", "commits", "hits", "misses", "entries",
         "commits_per_step")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jcfg(layers: int) -> JaxModelConfig:
    return JaxModelConfig(name=f"t{layers}", family="dense",
                          num_layers=layers, d_model=64, num_heads=4,
                          num_kv_heads=2, d_ff=128, vocab_size=128)


def _port_cfg(jcfg) -> ModelConfig:
    return ModelConfig(**{f.name: getattr(jcfg, f.name)
                          for f in dataclasses.fields(ModelConfig)})


@pytest.fixture(scope="module")
def models():
    """{layers: (JAX int8 bundle, port int8 bundle)}, each quantized by
    its own package from the same numpy weights."""
    from test_torch_model import numpy_params
    out = {}
    for n in (3, 4):
        jcfg = _jcfg(n)
        params = numpy_params(jcfg, n)
        jb = JaxBundle(jax.tree.map(jnp.asarray, params), jcfg).quantize()
        tb = ModelBundle(from_jax_params(_port_cfg(jcfg), params,
                                         device="cpu")).quantize()
        out[n] = (jb, tb)
    return out


def _np(t):
    return np.asarray(t.detach().cpu() if isinstance(t, torch.Tensor) else t)


def _int8_caches(rng, cfg, batch, rows, n):
    """``n`` per-layer int8 caches (numpy): int8 K/V and positive fp32 row
    scales."""
    shape = (batch, rows, cfg.num_kv_heads, cfg.resolved_head_dim)
    out = []
    for _ in range(n):
        c = {k: rng.integers(-127, 128, size=shape).astype(np.int8)
             for k in "kv"}
        for k in "kv":
            c[k + "_scale"] = (0.01 + 0.05 * rng.random(shape[:3])).astype(
                np.float32)
        out.append(c)
    return out


def _torch(caches):
    return [{k: torch.tensor(v) for k, v in c.items()} for c in caches]


def _jax(caches):
    return [{k: jnp.asarray(v) for k, v in c.items()} for c in caches]


def _by_stage_np(caches, s, lps):
    out = []
    for i in range(lps):
        j = s * lps + i
        out.append(caches[j] if j < len(caches) else
                   {k: np.zeros_like(v) for k, v in caches[0].items()})
    return out


def _rows_close(got, want, untouched=None):
    """Port int8 cache rows against JAX's: int8 values within one step,
    scales within SCALE_RTOL; row ``untouched[1]`` of ``got`` equal to
    ``untouched[0]`` bit for bit."""
    for k in ("k", "v"):
        g, w = _np(got[k]).astype(int), np.asarray(want[k]).astype(int)
        assert np.abs(g - w).max() <= 1, k
        np.testing.assert_allclose(_np(got[k + "_scale"]),
                                   np.asarray(want[k + "_scale"]),
                                   rtol=SCALE_RTOL, atol=0)
    if untouched is not None:
        ref, row = untouched
        for k, v in ref.items():
            np.testing.assert_array_equal(_np(got[k])[row], v[row])


@pytest.mark.parametrize("layers,stages", [(4, 2), (3, 4)])
def test_int8_stage_fns_match_jax(models, layers, stages):
    """Stage by stage over a 3-slot batch whose middle slot is invalid:
    the int8 ``stage_apply`` (int8 projections, int8 tree verify over
    int8 caches with their scales) and ``stage_prefill`` (quantize on
    write, dequantize on read) against the JAX ones, and ``stage_ctrl``
    exact; the invalid slot's rows, scales included, stay untouched.  In
    (3, 4) the last stage holds only padding and passes everything
    through."""
    jb, tb = models[layers]
    jcfg, cfg = jb.cfg, tb.cfg
    assert jcfg.quant == cfg.quant == "int8"
    pcfg = pl.PipelineConfig(stages, W, CAP, MAX_LEN)
    jpcfg = jpl.PipelineConfig(stages, W, CAP, MAX_LEN)
    j_apply, j_ctrl, j_prefill = jpl.make_stage_fns(jcfg, jpcfg)
    apply, ctrl, prefill = pl.make_stage_fns(cfg, pcfg)
    jlayers, jvalid = jpl.stage_params(jcfg, jb.params, stages)
    tlayers, tvalid = pl.stage_params(tb.model, stages)
    lps, _ = pl.stage_layout(cfg, stages)
    np.testing.assert_array_equal(tvalid, np.asarray(jvalid))

    rng = np.random.default_rng(layers * 10 + stages)
    kv_np = _int8_caches(rng, cfg, 3, MAX_LEN, layers)
    tkv_np = _int8_caches(rng, cfg, 3, CAP + W, layers)
    kvs_t = pl.split_stages(_torch(kv_np), stages)
    tkvs_t = pl.split_stages(_torch(tkv_np), stages)
    mlen = np.array([5, 9, 7])
    wi = np.array([3, CAP, 6])
    pos = mlen[:, None] + rng.integers(0, 3, size=(3, W))
    mask = rng.random((3, W, CAP + W)) < 0.4
    mask[np.arange(3), :, wi] = True
    x = rng.normal(size=(3, W, cfg.d_model)).astype(np.float32)
    on = np.array([True, False, True])
    xj, xt = jnp.asarray(x), torch.tensor(x)
    for s in range(stages):
        sp = [jax.tree.map(lambda t, s=s: t[s], lp) for lp in jlayers]
        kvj, tkvj = (_jax(_by_stage_np(c, s, lps)) for c in (kv_np, tkv_np))
        xj, new_tkv = j_apply(sp, jvalid[s], kvj, tkvj, xj, jnp.asarray(pos),
                              jnp.asarray(mask), jnp.asarray(wi),
                              jnp.asarray(mlen), jnp.asarray(on))
        xt = apply(tlayers[s], tvalid[s], kvs_t[s], tkvs_t[s], xt,
                   torch.tensor(pos), torch.tensor(mask), wi,
                   torch.tensor(mlen, dtype=torch.int32), on)
        np.testing.assert_allclose(_np(xt), np.asarray(xj), rtol=0,
                                   atol=ACT_TOL)
        np.testing.assert_array_equal(_np(xt[1]), x[1])   # passed through
        for i in range(lps):
            if tvalid[s, i]:
                _rows_close(tkvs_t[s][i], new_tkv[i],
                            (tkv_np[s * lps + i], 1))

    # ctrl on the same int8 rows: commit row 0 where on, then compact (a
    # real prune, the identity, a reversal); scales move with their rows
    commit_len = np.array([5, 9, 30])
    imap = np.tile(np.arange(CAP), (3, 1))
    imap[0] = -1
    imap[0][[1, 4, 5, 9]] = np.arange(4)
    imap[2] = np.arange(CAP)[::-1]
    kvs_t = pl.split_stages(_torch(kv_np), stages)
    tkvs_t = pl.split_stages(_torch(tkv_np), stages)
    for s in range(stages):
        kvj, tkvj = (_jax(_by_stage_np(c, s, lps)) for c in (kv_np, tkv_np))
        kvj, tkvj = j_ctrl(kvj, tkvj, jnp.asarray(on),
                           jnp.asarray(commit_len), jnp.asarray(imap))
        ctrl(kvs_t[s], tkvs_t[s], on, commit_len, imap)
        for i in range(lps):
            if tvalid[s, i]:
                for k in ("k", "v", "k_scale", "v_scale"):
                    np.testing.assert_array_equal(_np(kvs_t[s][i][k]),
                                                  np.asarray(kvj[i][k]))
                    np.testing.assert_array_equal(_np(tkvs_t[s][i][k]),
                                                  np.asarray(tkvj[i][k]))

    # the prefill lane in chunk mode: slot 2's chunk overruns the end
    off = np.array([0, 0, MAX_LEN - 4])
    xp = rng.normal(size=(3, PCAP, cfg.d_model)).astype(np.float32)
    kvs_t = pl.split_stages(_torch(kv_np), stages)
    xj, xt = jnp.asarray(xp), torch.tensor(xp)
    for s in range(stages):
        sp = [jax.tree.map(lambda t, s=s: t[s], lp) for lp in jlayers]
        kvj = _jax(_by_stage_np(kv_np, s, lps))
        new_kv, xj = j_prefill(sp, jvalid[s], kvj, xj, jnp.asarray(on),
                               jnp.asarray(off))
        xt = prefill(tlayers[s], tvalid[s], kvs_t[s], xt, on, off)
        np.testing.assert_allclose(_np(xt), np.asarray(xj), rtol=0,
                                   atol=ACT_TOL)
        for i in range(lps):
            if tvalid[s, i]:
                _rows_close(kvs_t[s][i], new_kv[i], (kv_np[s * lps + i], 1))


# --------------------------------------------------------------------------
# the int8 executors against the int8 local executor
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def qpair(models, tiny_draft):
    """The quantized 4-layer target and 1-layer draft (port)."""
    from test_torch_model import numpy_params
    draft = ModelBundle(from_jax_params(_port_cfg(tiny_draft),
                                        numpy_params(tiny_draft, 9),
                                        device="cpu")).quantize()
    return models[4][1], draft


def _pcfg(stages):
    return PipeDecConfig(n_stages=stages, width=4, branch=2)


def _requests():
    rng = np.random.default_rng(21)
    lens = [5, 90, 7, 4]            # one prompt streams through the lane
    return [Request(i, rng.integers(0, 100, size=n), m, arrival_t=a)
            for i, (n, m, a) in enumerate(zip(lens, [5, 4, 6, 3],
                                              [0, 1, 1, 4]))]


def _executor(kind, target, draft, pcfg, paged=False):
    kw = dict(slots=2, max_len=DB_MAX_LEN,
              tree_capacity=pcfg.tree_buffer_capacity,
              capacity=pcfg.capacity)
    if kind == "local":
        return LocalFusedExecutor(target, draft, paged=paged, **kw)
    if kind == "async":
        return AsyncPipelineExecutor(target, draft, n_stages=pcfg.n_stages,
                                     timeout_s=60.0, **kw)
    cls = {"flush": ShardedPipelineExecutor,
           "overlapped": OverlappedShardedExecutor}[kind]
    return cls(target, draft, n_stages=pcfg.n_stages, paged=paged, **kw)


def _run(ex, target, draft, pcfg, monkeypatch):
    """Serve the requests; returns (engine, results, the logits every
    committed token was selected from, in order)."""
    seen = []
    real = pipedec_mod.select_token

    def select(logits, sp, gen=None):
        seen.append(logits.clone())
        return real(logits, sp, gen)
    monkeypatch.setattr(pipedec_mod, "select_token", select)
    eng = SpecPipeDBEngine(target, draft, pcfg, max_len=DB_MAX_LEN,
                           max_slots=2, executor=ex)
    for r in _requests():
        eng.submit(r)
    try:
        res = eng.run()
    finally:
        monkeypatch.setattr(pipedec_mod, "select_token", real)
        if isinstance(ex, AsyncPipelineExecutor):
            ex.shutdown()
    return eng, res, seen


@pytest.mark.parametrize("paged", [False, True])
def test_int8_flush_bitmatches_local(qpair, monkeypatch, paged):
    """The int8 flush ring (4 stages, int8 caches densified around the
    ring when paged) against the int8 local executor on the same arena
    kind: tokens, GenStats, DBStats and the logits of every committed
    token bit for bit, and the single-request engine's tokens."""
    target, draft = qpair
    pcfg = _pcfg(4)
    local, lres, lseen = _run(_executor("local", target, draft, pcfg, paged),
                              target, draft, pcfg, monkeypatch)
    ex = _executor("flush", target, draft, pcfg, paged)
    eng, res, seen = _run(ex, target, draft, pcfg, monkeypatch)
    single = PipeDecEngine(target, draft, pcfg, max_len=DB_MAX_LEN)
    for r in _requests():
        np.testing.assert_array_equal(res[r.uid].tokens, lres[r.uid].tokens)
        np.testing.assert_array_equal(
            res[r.uid].tokens, single.generate(r.prompt, r.max_new_tokens)[0])
        assert {k: getattr(res[r.uid].stats, k) for k in STATS} == \
            {k: getattr(lres[r.uid].stats, k) for k in STATS}
    assert (eng.stats.timesteps, eng.stats.verify_dispatches,
            eng.stats.accepted, eng.stats.proposed) == \
        (local.stats.timesteps, local.stats.verify_dispatches,
         local.stats.accepted, local.stats.proposed)
    assert len(seen) == len(lseen)
    assert all(torch.equal(a, b) for a, b in zip(seen, lseen))
    assert ex.calls["pipeline_verify"] == sum(eng.stats.verify_dispatches)
    assert ex.calls["stage_layers"] == 4 * ex.calls["pipeline_verify"]
    assert ex.t_cache[0]["k"].dtype == torch.int8


@pytest.mark.parametrize("kind", ["overlapped", "async"])
def test_int8_overlapped_and_async_match_local(qpair, monkeypatch, kind):
    """The int8 overlapped ring (prefill in its lane, the 90-token prompt
    in two chunks) and the int8 async executor serve the int8 local
    executor's tokens and GenStats on 4 stages."""
    target, draft = qpair
    pcfg = _pcfg(4)
    _, lres, _ = _run(_executor("local", target, draft, pcfg), target,
                      draft, pcfg, monkeypatch)
    ex = _executor(kind, target, draft, pcfg)
    eng, res, _ = _run(ex, target, draft, pcfg, monkeypatch)
    for r in _requests():
        np.testing.assert_array_equal(res[r.uid].tokens, lres[r.uid].tokens)
        assert {k: getattr(res[r.uid].stats, k) for k in STATS} == \
            {k: getattr(lres[r.uid].stats, k) for k in STATS}
    if kind == "overlapped":
        assert ex.calls["prefill_chunks"] > len(lres)
        assert eng.stats.separate_prefill_dispatches == 0
    else:
        assert ex.calls["stage_steps"] == ex.calls["entry_msgs"] * 4


@pytest.mark.parametrize("quant", [False, True])
def test_chunk_prefill_streamed_equals_one_chunk(quant):
    """The lane's chunk attention over the cache (the flash kernel's plain
    version, int8 K/V in its int8 mode): a 24-row prompt streamed in three
    8-token chunks gives the logits and caches the rows of one 24-token
    chunk, fp32 and int8, and a chunk wholly past the cache's end writes
    nothing and still attends over the cached rows."""
    from repro_torch.models import transformer as tf
    from test_torch_model import numpy_params
    jcfg = _jcfg(3)
    model = ModelBundle(from_jax_params(_port_cfg(jcfg), numpy_params(jcfg, 3),
                                        device="cpu"))
    if quant:
        model = model.quantize()
    cfg, rows = model.cfg, 24
    tokens = np.random.default_rng(7).integers(0, cfg.vocab_size,
                                               size=(2, rows + 5))
    one = tf.init_cache(cfg, 2, rows, device="cpu")
    want, _ = tf.prefill_chunk(model.model, tokens[:, :rows], one, 0)
    streamed = tf.init_cache(cfg, 2, rows, device="cpu")
    got = torch.cat([tf.prefill_chunk(model.model, tokens[:, i:i + 8],
                                      streamed, i)[0]
                     for i in range(0, rows, 8)], dim=1)
    torch.testing.assert_close(got, want, rtol=0, atol=ACT_TOL)
    for s_, o in zip(streamed, one):
        for name in s_:
            if name.endswith("_scale"):
                torch.testing.assert_close(s_[name], o[name],
                                           rtol=SCALE_RTOL, atol=0)
            elif quant:                 # one int8 step at a rounding tie
                assert int((s_[name].int() - o[name].int()).abs().max()) <= 1
            else:
                torch.testing.assert_close(s_[name], o[name], rtol=0,
                                           atol=1e-6)
    before = [{n: b.clone() for n, b in layer.items()} for layer in streamed]
    past, _ = tf.prefill_chunk(model.model, tokens[:, rows:], streamed, rows)
    assert past.shape == (2, 5, cfg.vocab_size)
    assert torch.isfinite(past).all()
    for s_, b in zip(streamed, before):
        for name in s_:
            assert torch.equal(s_[name], b[name])


def test_chunk_prefill_refuses_a_paged_cache():
    """The lane attends over a dense cache only: the ring densifies a
    paged arena around its ticks, and a paged leaf is refused."""
    from repro_torch.models import paging
    from repro_torch.models import transformer as tf
    from test_torch_model import numpy_params
    jcfg = _jcfg(3)
    model = ModelBundle(from_jax_params(_port_cfg(jcfg), numpy_params(jcfg, 3),
                                        device="cpu"))
    page, rows = 4, 24
    paged = [{name: paging.make_paged(buf, np.arange(
        1, 1 + 2 * rows // page).reshape(2, rows // page), page)
        for name, buf in layer.items()}
        for layer in tf.init_cache(model.cfg, 2, rows, device="cpu")]
    with pytest.raises(ValueError, match="dense cache"):
        tf.prefill_chunk(model.model, np.zeros((2, 8), np.int64), paged, 0)