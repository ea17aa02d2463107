"""The port's stage ring (``repro_torch.launch.pipeline``) against the JAX
package's ``repro.launch.pipeline``, on bridged weights.

The JAX stage functions (``make_stage_fns``) are pure functions, so they
are called stage by stage on ``stage_params`` slices with no mesh; the JAX
1-stage tick and ``tf.prefill`` give the references for the tick and the
prefill lane.  Within the port the ring is held to its own single-device
functions bit for bit: the flush equals ``tree_verify_step``, a ctrl
message equals the central commit and remap, and a prompt streamed in
chunks equals one chunk pass.

Tolerances: activations, cache rows and logits against JAX within 1e-5
(fp32 sums taken in another order by the two packages); ctrl exact (a
commit copies rows and a remap permutes them).
"""
import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import pipeline as jpl
from repro.models import attention as jattn
from repro.models import transformer as jtf
from repro.models.config import ModelConfig as JaxModelConfig
from repro.models.layers import embed as jembed
from repro_torch.checkpoint import from_jax_params
from repro_torch.launch import pipeline as pl
from repro_torch.models import attention as attn
from repro_torch.models import paging
from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import embed

W, CAP, MAX_LEN, PCAP = 4, 16, 32, 8   # width, tree nodes, rows, lane
TOL = 1e-5


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


@pytest.fixture(scope="module")
def models():
    """{layers: (JAX cfg, JAX params, port model)} on the same weights."""
    from test_torch_model import numpy_params
    out = {}
    for n in (3, 4):
        jcfg = _jcfg(n)
        params = numpy_params(jcfg, n)
        cfg = ModelConfig(**{f.name: getattr(jcfg, f.name)
                             for f in dataclasses.fields(ModelConfig)})
        out[n] = (jcfg, jax.tree.map(jnp.asarray, params),
                  from_jax_params(cfg, params, device="cpu"))
    return out


def _np(t):
    return np.asarray(t.detach().cpu() if isinstance(t, torch.Tensor) else t)


def _caches(rng, cfg, batch, rows, n):
    """``n`` per-layer {"k", "v"} caches of random rows (numpy)."""
    shape = (batch, rows, cfg.num_kv_heads, cfg.resolved_head_dim)
    return [{k: rng.normal(size=shape).astype(np.float32) for k in "kv"}
            for _ in range(n)]


def _torch(caches):
    return [{k: torch.tensor(v) for k, v in c.items()} for c in caches]


def _jax(caches):
    return [{k: jnp.asarray(v) for k, v in c.items()} for c in caches]


def _by_stage_np(caches, s, lps):
    """Stage ``s``'s layers of per-layer numpy caches, zeros for padding
    (the JAX layout)."""
    out = []
    for i in range(lps):
        j = s * lps + i
        out.append(caches[j] if j < len(caches) else
                   {k: np.zeros_like(v) for k, v in caches[0].items()})
    return out


def _tree_inputs(rng, cfg, batch):
    """A tree layer per row: activations, positions, ancestor masks, write
    offsets and committed lengths (row 1 sits on the buffer's last
    layer)."""
    mlen = np.array([5, 9, 7][:batch])
    wi = np.array([3, CAP, 6][:batch])
    pos = mlen[:, None] + rng.integers(0, 3, size=(batch, W))
    mask = rng.random((batch, W, CAP + W)) < 0.4
    mask[np.arange(batch), :, wi] = True
    x = rng.normal(size=(batch, W, cfg.d_model)).astype(np.float32)
    return x, pos, mask, wi, mlen


# --------------------------------------------------------------------------
# the stage functions against JAX make_stage_fns
# --------------------------------------------------------------------------
@pytest.mark.parametrize("layers,stages", [(4, 2), (4, 4), (3, 2), (3, 4)])
def test_stage_fns_match_jax(models, layers, stages):
    """Stage by stage over a 3-slot batch whose middle slot is invalid
    (killed): ``stage_apply``, ``stage_ctrl`` and ``stage_prefill`` equal
    the JAX ones on bridged weights, activations and tree rows within
    1e-5, ctrl exact; the invalid slot's rows stay untouched.  (3, 2) is
    the padded layout: the last stage holds one layer and one pad; in
    (3, 4) the last stage holds only a pad and passes everything
    through."""
    jcfg, jparams, model = models[layers]
    cfg = model.cfg
    pcfg = pl.PipelineConfig(stages, W, CAP, MAX_LEN)
    jpcfg = jpl.PipelineConfig(stages, W, CAP, MAX_LEN)
    j_apply, j_ctrl, j_prefill = jpl.make_stage_fns(jcfg, jpcfg)
    apply, ctrl, prefill = pl.make_stage_fns(cfg, pcfg)
    jlayers, jvalid = jpl.stage_params(jcfg, jparams, stages)
    tlayers, tvalid = pl.stage_params(model, stages)
    lps, padded = pl.stage_layout(cfg, stages)
    assert (lps, padded) == jpl.stage_layout(jcfg, stages)
    np.testing.assert_array_equal(tvalid, np.asarray(jvalid))
    for s in range(stages):            # the stage holds the model's layers
        for i, lay in enumerate(tlayers[s]):
            assert lay is (model.layers[s * lps + i] if tvalid[s, i]
                           else None)

    rng = np.random.default_rng(layers * 10 + stages)
    kv_np = _caches(rng, cfg, 3, MAX_LEN, layers)
    tkv_np = _caches(rng, cfg, 3, CAP + W, layers)
    kv_t, tkv_t = _torch(kv_np), _torch(tkv_np)
    kvs_t, tkvs_t = pl.split_stages(kv_t, stages), pl.split_stages(tkv_t,
                                                                   stages)
    x, pos, mask, wi, mlen = _tree_inputs(rng, cfg, 3)
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
                                   atol=TOL)
        np.testing.assert_array_equal(_np(xt[1]), x[1])   # passed through
        for i in range(lps):
            if not tvalid[s, i]:
                continue
            for k in "kv":
                got = _np(tkvs_t[s][i][k])
                np.testing.assert_allclose(got, np.asarray(new_tkv[i][k]),
                                           rtol=0, atol=TOL)
                np.testing.assert_array_equal(
                    got[1], tkv_np[s * lps + i][k][1])

    # ctrl: commit row 0 where on, then compact (a real prune, identity,
    # a reversal): exact
    commit_len = np.array([5, 9, 30])
    imap = np.tile(np.arange(CAP), (3, 1))
    imap[0] = -1
    imap[0][[1, 4, 5, 9]] = np.arange(4)
    imap[2] = np.arange(CAP)[::-1]
    kv_t, tkv_t = _torch(kv_np), _torch(tkv_np)
    kvs_t, tkvs_t = pl.split_stages(kv_t, stages), pl.split_stages(tkv_t,
                                                                   stages)
    for s in range(stages):
        kvj, tkvj = (_jax(_by_stage_np(c, s, lps)) for c in (kv_np, tkv_np))
        kvj, tkvj = j_ctrl(kvj, tkvj, jnp.asarray(on),
                           jnp.asarray(commit_len), jnp.asarray(imap))
        ctrl(kvs_t[s], tkvs_t[s], on, commit_len, imap)
        for i in range(lps):
            if tvalid[s, i]:
                for k in "kv":
                    np.testing.assert_array_equal(_np(kvs_t[s][i][k]),
                                                  np.asarray(kvj[i][k]))
                    np.testing.assert_array_equal(_np(tkvs_t[s][i][k]),
                                                  np.asarray(tkvj[i][k]))

    # prefill lane, chunk mode: slot 2's chunk overruns the cache's end
    # (rows past it are dropped)
    off = np.array([0, 0, MAX_LEN - 4])
    xp = rng.normal(size=(3, PCAP, cfg.d_model)).astype(np.float32)
    kv_t = _torch(kv_np)
    kvs_t = pl.split_stages(kv_t, stages)
    xj, xt = jnp.asarray(xp), torch.tensor(xp)
    for s in range(stages):
        sp = [jax.tree.map(lambda t, s=s: t[s], lp) for lp in jlayers]
        kvj = _jax(_by_stage_np(kv_np, s, lps))
        new_kv, xj = j_prefill(sp, jvalid[s], kvj, xj, jnp.asarray(on),
                               jnp.asarray(off))
        xt = prefill(tlayers[s], tvalid[s], kvs_t[s], xt, on, off)
        np.testing.assert_allclose(_np(xt), np.asarray(xj), rtol=0,
                                   atol=TOL)
        for i in range(lps):
            if tvalid[s, i]:
                for k in "kv":
                    got = _np(kvs_t[s][i][k])
                    np.testing.assert_allclose(got, np.asarray(new_kv[i][k]),
                                               rtol=0, atol=TOL)
                    np.testing.assert_array_equal(
                        got[1], kv_np[s * lps + i][k][1])


@pytest.mark.parametrize("paged", [False, True])
def test_cache_write_rows_on_and_drop_match_jax(paged):
    """The row-masked write with drop semantics at the buffer's end equals
    the JAX ``_cache_write_rows_at``, dense and paged."""
    rng = np.random.default_rng(0)
    buf = rng.normal(size=(3, 12, 2, 4)).astype(np.float32)
    upd = rng.normal(size=(3, 5, 2, 4)).astype(np.float32)
    starts, on = np.array([0, 4, 9]), np.array([True, False, True])
    want = jattn._cache_write_rows_at({"k": jnp.asarray(buf)},
                                      {"k": jnp.asarray(upd)}, starts, on=on)
    leaf = torch.tensor(buf)
    if paged:
        leaf = paging.make_paged(leaf, np.arange(1, 10).reshape(3, 3), 4)
    attn.cache_write_rows({"k": leaf}, {"k": torch.tensor(upd)},
                          starts.tolist(), on=on, drop=True)
    got = paging.to_dense(leaf) if paged else leaf
    np.testing.assert_array_equal(got.numpy(), np.asarray(want["k"]))


# --------------------------------------------------------------------------
# the tick
# --------------------------------------------------------------------------
def _root_entry(model, batch=2, version=0):
    """A prefilled model cache and a root layer per slot (slot 1 ignored
    when marked invalid)."""
    cfg = model.cfg
    prompt = np.array([[5, 3, 2, 7]] * batch)
    cache = tf.init_cache(cfg, batch, MAX_LEN, device="cpu")
    logits, _ = tf.prefill(model, prompt, cache)
    root = int(torch.argmax(logits[0]))
    tokens = np.zeros((batch, W), np.int64)
    tokens[:, 0] = root
    mask = np.zeros((batch, W, CAP + W), bool)
    mask[:, 0, 0] = True
    pos = np.zeros((batch, W), np.int64)
    pos[:, 0] = 4
    entry = {"act": embed(model.embed.table, torch.tensor(tokens)),
             "positions": torch.tensor(pos), "mask": torch.tensor(mask),
             "model_len": torch.full((batch,), 4, dtype=torch.int32),
             "write_idx": np.zeros(batch, np.int64),
             "valid": np.ones(batch, bool),
             "version": np.full(batch, version)}
    return cache, tokens, pos, mask, entry


def _clone(cache):
    return [{k: v.clone() for k, v in c.items()} for c in cache]


def test_tick_matches_jax_one_stage_tick(models):
    """One 1-stage tick ingests, processes and exits a root layer (ingest
    first): exit activations and tree rows within 1e-5 of the JAX tick on
    the same caches, the version rides to the exit, and the invalid slot's
    tree rows stay untouched."""
    jcfg, jparams, model = models[3]
    cache, tokens, pos, mask, entry = _root_entry(model, version=7)
    entry["valid"] = np.array([True, False])
    pcfg = pl.PipelineConfig(1, W, CAP, MAX_LEN)
    jpcfg = jpl.PipelineConfig(1, W, CAP, MAX_LEN)
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    sp, valid = jpl.stage_params(jcfg, jparams, 1)
    jkv = [{k: jnp.asarray(_np(c[k]))[None] for k in "kv"} for c in cache]
    _, jtkv = jpl.init_stage_caches(jcfg, jpcfg, batch=2)
    jentry = {"act": jembed(jparams["embed"], jnp.asarray(tokens)),
              "positions": jnp.asarray(pos), "mask": jnp.asarray(mask),
              "write_idx": jnp.zeros(2, jnp.int32),
              "model_len": jnp.full(2, 4, jnp.int32),
              "valid": jnp.asarray([True, False]),
              "version": jnp.full(2, 7, jnp.int32)}
    with mesh:
        _, jtkv_new, _, jex = jax.jit(jpl.make_pipedec_tick(
            jcfg, jpcfg, mesh))(sp, valid, jkv, jtkv,
                                jpl.init_ring(jcfg, jpcfg, batch=2), jentry)

    tree = tf.init_tree_caches(model.cfg, 2, CAP + W, device="cpu")
    layers, tvalid = pl.stage_params(model, 1)
    tick = pl.make_pipedec_tick(model.cfg, pcfg)
    ring, ex = tick(layers, tvalid, pl.split_stages(cache, 1),
                    pl.split_stages(tree, 1), pl.init_ring(pcfg, 2), entry)
    np.testing.assert_array_equal(ex["valid"], [True, False])
    np.testing.assert_array_equal(ex["valid"], np.asarray(jex["valid"]))
    assert ex["version"][0] == int(jex["version"][0]) == 7
    np.testing.assert_allclose(_np(ex["act"][0]), np.asarray(jex["act"][0]),
                               rtol=0, atol=TOL)
    for c, jc in zip(tree, jtkv_new):
        for k in "kv":
            np.testing.assert_allclose(_np(c[k]), np.asarray(jc[k][0]),
                                       rtol=0, atol=TOL)
            assert not c[k][1].any()
    assert all(not e.valid.any() for e in ring)   # the layer left the ring


def _check_flush(model, stages, monkeypatch):
    """``make_pipeline_verify`` over ``stages`` stages against
    ``tree_verify_step`` (see the tests below)."""
    ticks = collections.Counter()
    real = pl.make_pipedec_tick

    def counting(*a, **k):
        tick = real(*a, **k)

        def wrapped(*args, **kw):
            ticks["n"] += 1
            return tick(*args, **kw)
        return wrapped
    monkeypatch.setattr(pl, "make_pipedec_tick", counting)
    cache, tokens, pos, mask, entry = _root_entry(model)
    entry["valid"] = np.array([True, False])
    pcfg = pl.PipelineConfig(stages, W, CAP, MAX_LEN)
    calls = collections.Counter()
    verify = pl.make_pipeline_verify(model.cfg, pcfg, calls=calls)
    tree = tf.init_tree_caches(model.cfg, 2, CAP + W, device="cpu")
    layers, valid = pl.stage_params(model, stages)
    act, ok = verify(layers, valid, pl.split_stages(cache, stages),
                     pl.split_stages(tree, stages), entry)
    assert ticks["n"] == stages and list(ok) == [True, False]
    # a stage holding only padding is skipped
    assert calls["stage_apply"] == int(valid.any(axis=1).sum())
    assert calls["stage_layers"] == model.cfg.num_layers

    ref_tree = tf.init_tree_caches(model.cfg, 1, CAP + W, device="cpu")
    want, _ = tf.tree_verify_step(model, tokens[:1], pos[:1], mask[:1],
                                  tf.slice_cache_rows(cache, 0, 1), 4,
                                  ref_tree, 0)
    assert torch.equal(tf._logits(model, act)[0], want[0])
    for c, r in zip(tree, ref_tree):
        for k in "kv":
            assert torch.equal(c[k][:1], r[k]) and c[k][0].any()
            assert not c[k][1].any()


@pytest.mark.parametrize("stages", [1, 2, 4])
def test_flush_equals_tree_verify_in_exactly_n_stages_ticks(
        models, stages, monkeypatch):
    """``make_pipeline_verify`` runs exactly ``n_stages`` ticks and gives
    the single-device ``tree_verify_step``'s logits and tree rows bit for
    bit; the invalid slot rides along and leaves its tree rows untouched,
    while the live slot writes its layer."""
    _check_flush(models[4][2], stages, monkeypatch)


@pytest.mark.parametrize("layers,stages", [(3, 4), (4, 3)])
def test_flush_through_all_padding_stage(models, layers, stages,
                                         monkeypatch):
    """Layouts whose last stage holds only padding (3 layers on 4 stages:
    one layer a stage and a pad; 4 on 3: two a stage, the last two pads):
    the flush still runs ``n_stages`` ticks, skips that stage and equals
    ``tree_verify_step`` bit for bit."""
    _check_flush(models[layers][2], stages, monkeypatch)


def test_tick_version_and_kill_in_flight(models):
    """4 stages, 3 slots: a layer entering at tick 0 exits at tick 3 with
    its version; killing the middle slot at tick 2 makes it exit invalid,
    its tree rows at the stages it had not reached stay untouched, and the
    live slots on both sides get the bits of a run without the kill."""
    _, _, model = models[4]
    pcfg = pl.PipelineConfig(4, W, CAP, MAX_LEN)
    layers, valid = pl.stage_params(model, 4)
    runs = {}
    for killed in (False, True):
        cache, _, _, _, entry = _root_entry(model, batch=3, version=2)
        tree = tf.init_tree_caches(model.cfg, 3, CAP + W, device="cpu")
        kvs, tkvs = pl.split_stages(cache, 4), pl.split_stages(tree, 4)
        tick = pl.make_pipedec_tick(model.cfg, pcfg)
        ring, ent, exits = pl.init_ring(pcfg, 3), entry, []
        for t in range(4):
            kill = np.array([False, True, False]) if killed and t == 2 \
                else None
            ring, ex = tick(layers, valid, kvs, tkvs, ring, ent, kill=kill)
            exits.append(ex)
            ent = None
        runs[killed] = exits[-1], tree
        assert not any(e["valid"].any() for e in exits[:3])
        np.testing.assert_array_equal(exits[-1]["version"], [2, 2, 2])
    (ex0, tree0), (ex1, tree1) = runs[False], runs[True]
    np.testing.assert_array_equal(ex1["valid"], [True, False, True])
    assert torch.equal(ex1["act"][[0, 2]], ex0["act"][[0, 2]])
    for i, (c0, c1) in enumerate(zip(tree0, tree1)):
        for k in "kv":
            assert torch.equal(c1[k][[0, 2]], c0[k][[0, 2]])
            # stages 0 and 1 ran before the kill; 2 and 3 never wrote
            assert bool(c1[k][1].any()) == (i < 2)


def test_tick_ctrl_matches_central_commit_and_remap(models):
    """2 stages: a ctrl message (commit row 0 at model_len 4, a prune
    keeping rows 2 and 3) entering at tick 1 reaches stage 0 at tick 1 and stage
    1 at tick 2, and then every cache equals the central
    ``commit_tree_nodes`` + ``remap_tree_cache_rows`` bit for bit; an
    identity message with the gate open changes nothing."""
    _, _, model = models[4]
    pcfg = pl.PipelineConfig(2, W, CAP, MAX_LEN)
    layers, valid = pl.stage_params(model, 2)
    cache, _, _, _, entry = _root_entry(model, batch=1)
    tree = tf.init_tree_caches(model.cfg, 1, CAP + W, device="cpu")
    kvs, tkvs = pl.split_stages(cache, 2), pl.split_stages(tree, 2)
    tick = pl.make_pipedec_tick(model.cfg, pcfg)
    identity = np.arange(CAP)[None]
    no_ctrl = {"commit": [False], "commit_len": [0], "index_map": identity,
               "clear": [False], "active": True}
    ring = pl.init_ring(pcfg, 1)
    for ent in (entry, None):          # the root layer crosses both stages
        before = _clone(cache)
        ring, _ = tick(layers, valid, kvs, tkvs, ring, ent, ctrl=no_ctrl)
        assert all(torch.equal(a[k], b[k]) for a, b in zip(cache, before)
                   for k in "kv")
    imap = np.full((1, CAP), -1)
    imap[0, 2:4] = [0, 1]          # the rows move: old 2, 3 -> new 0, 1
    want_kv, want_tree = _clone(cache), _clone(tree)
    tf.commit_tree_nodes(want_kv, want_tree, [0], [4], [True])
    tf.remap_tree_cache_rows(want_tree, imap)
    msg = {"commit": [True], "commit_len": [4], "index_map": imap,
           "clear": [False], "active": True}
    ring, _ = tick(layers, valid, kvs, tkvs, ring, None, ctrl=msg)
    # stage 0's layers (0, 1) have it, stage 1's (2, 3) not yet
    for i, (c, w, t, wt) in enumerate(zip(cache, want_kv, tree, want_tree)):
        for k in "kv":
            assert torch.equal(c[k], w[k]) == (i < 2)
            assert torch.equal(t[k], wt[k]) == (i < 2)
    ring, _ = tick(layers, valid, kvs, tkvs, ring, None, ctrl=no_ctrl)
    for c, w, t, wt in zip(cache, want_kv, tree, want_tree):
        for k in "kv":
            assert torch.equal(c[k], w[k]) and torch.equal(t[k], wt[k])


def test_tick_ctrl_gate_skips_inactive_message(models):
    """With ``active`` False even a real commit and prune message leaves
    every cache bit-untouched: the stage skips it."""
    _, _, model = models[4]
    pcfg = pl.PipelineConfig(1, W, CAP, MAX_LEN)
    layers, valid = pl.stage_params(model, 1)
    cache, _, _, _, entry = _root_entry(model, batch=1)
    tree = tf.init_tree_caches(model.cfg, 1, CAP + W, device="cpu")
    kvs, tkvs = pl.split_stages(cache, 1), pl.split_stages(tree, 1)
    calls = collections.Counter()
    tick = pl.make_pipedec_tick(model.cfg, pcfg, calls=calls)
    ring, _ = tick(layers, valid, kvs, tkvs, pl.init_ring(pcfg, 1), entry)
    before, tbefore = _clone(cache), _clone(tree)
    imap = np.full((1, CAP), -1)
    imap[0, 0] = 0
    tick(layers, valid, kvs, tkvs, ring, None,
         ctrl={"commit": [True], "commit_len": [4], "index_map": imap,
               "clear": [False], "active": False})
    assert calls["stage_ctrl"] == 0
    for a, b, t, tb in zip(cache, before, tree, tbefore):
        for k in "kv":
            assert torch.equal(a[k], b[k]) and torch.equal(t[k], tb[k])


def test_prefill_lane_matches_jax_prefill(models):
    """2 stages: a 5-token prompt entering the lane at tick 0 exits at tick
    1 with last-position logits and model-cache rows within 1e-5 of the
    JAX ``tf.prefill``; the off slot stays untouched and the tree exit
    stays dead."""
    jcfg, jparams, model = models[4]
    prompt = np.array([5, 3, 2, 7, 11])
    pcfg = pl.PipelineConfig(2, W, CAP, MAX_LEN)
    layers, valid = pl.stage_params(model, 2)
    cache = tf.init_cache(model.cfg, 2, MAX_LEN, device="cpu")
    tree = tf.init_tree_caches(model.cfg, 2, CAP + W, device="cpu")
    kvs, tkvs = pl.split_stages(cache, 2), pl.split_stages(tree, 2)
    tick = pl.make_pipedec_tick(model.cfg, pcfg)
    tok = np.zeros((2, PCAP), np.int64)
    tok[0, :5] = prompt
    pentry = {"act": embed(model.embed.table, torch.tensor(tok)),
              "len": [5, 0], "on": [True, False], "off": [0, 0]}
    ring, ex = tick(layers, valid, kvs, tkvs, pl.init_ring(pcfg, 2), None,
                    pentry=pentry)
    assert not ex["p_valid"].any()
    ring, ex = tick(layers, valid, kvs, tkvs, ring, None)
    np.testing.assert_array_equal(ex["p_valid"], [True, False])
    assert not ex["valid"].any()
    jlogits, jcache = jtf.prefill(jparams, jcfg, jnp.asarray(prompt)[None],
                                  jtf.init_cache(jcfg, 1, MAX_LEN))
    np.testing.assert_allclose(_np(tf._logits(model, ex["p_last"][:1])),
                               np.asarray(jlogits), rtol=0, atol=TOL)
    stacked = jcache["stack"][0]
    for i, c in enumerate(cache):
        for k in "kv":
            np.testing.assert_allclose(_np(c[k][0, :5]),
                                       np.asarray(stacked[k][i, 0, :5]),
                                       rtol=0, atol=TOL)
            assert not c[k][1].any()


def _lane_run(model, prompt, cap):
    """Stream ``prompt`` through a 2-stage ring's ``cap``-token lane, one
    chunk per tick; returns (model cache, each tick's exit)."""
    pcfg = pl.PipelineConfig(2, W, CAP, MAX_LEN)
    layers, valid = pl.stage_params(model, 2)
    cache = tf.init_cache(model.cfg, 1, MAX_LEN, device="cpu")
    tree = tf.init_tree_caches(model.cfg, 1, CAP + W, device="cpu")
    kvs, tkvs = pl.split_stages(cache, 2), pl.split_stages(tree, 2)
    tick = pl.make_pipedec_tick(model.cfg, pcfg)
    ring, exits = pl.init_ring(pcfg, 1), []
    for off in [*range(0, len(prompt), cap), None]:
        pentry = None
        if off is not None:
            chunk = np.zeros((1, cap), np.int64)
            seg = prompt[off:off + cap]
            chunk[0, :len(seg)] = seg
            pentry = {"act": embed(model.embed.table, torch.tensor(chunk)),
                      "len": [len(seg)], "on": [True], "off": [off]}
        ring, ex = tick(layers, valid, kvs, tkvs, ring, None, pentry=pentry)
        exits.append(ex)
    return cache, exits


def test_streamed_prompt_equals_one_chunk(models):
    """An 11-token prompt streamed through a 4-token lane over 3
    consecutive ticks (2 stages) caches the rows of one ``prefill_chunk``
    pass over the whole prompt bit for bit, and its last chunk exits with
    the hidden state that one 12-token chunk through the ring exits
    with."""
    _, _, model = models[4]
    prompt = np.random.default_rng(5).integers(0, 128, size=11)
    cache, exits = _lane_run(model, prompt, 4)
    assert [bool(e["p_valid"][0]) for e in exits] == [False, True, True,
                                                      True]
    one_cache, one_exits = _lane_run(model, prompt, 12)
    assert torch.equal(exits[-1]["p_last"], one_exits[-1]["p_last"])
    one = tf.init_cache(model.cfg, 1, MAX_LEN, device="cpu")
    tf.prefill_chunk(model, prompt[None], one, 0)
    for c, o, r in zip(cache, one, one_cache):
        for k in "kv":
            assert torch.equal(c[k][:, :11], o[k][:, :11])
            assert torch.equal(r[k][:, :11], o[k][:, :11])
