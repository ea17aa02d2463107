"""The attention and modality families on the port's stage ring: Qwen 2.5
and 1.5 (QKV bias), Gemma (GeGLU, head_dim 256), Qwen-MoE (QKV bias and
MoE), InternVL2 (a vision prefix) and Whisper (cross-attention), at smoke
size on bridged weights, on the CPU with the kernels' plain versions.

Held here:
  * the stage functions against the JAX ``make_stage_fns`` called stage
    by stage with no mesh (activations and tree rows within 1e-5, ctrl
    exact), over a batch with a live row, a killed row and an empty row
    (no committed prefix, an all-false mask: the reference's uniform joint
    softmax, which the port gives through ``empty=``);
  * Whisper's flush against the JAX ``tree_verify_step(enc_out=...)``
    through the whole stack within 1e-5: the JAX stage functions leave
    out the cross sub-layer, so they cannot be its yardstick;
  * the serving CLI on the ring for the families, and its refusals.

The tower is in ``test_torch_ring_families_tower.py``, the async
executor against the JAX one and MoE capacity drops in
``test_torch_ring_families_engines.py``; both take their bundles and
serving helpers from here.
"""
import collections
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jreg
from repro.core.pipedec import PipeDecConfig as JaxPipeDecConfig
from repro.core.speculative import ModelBundle as JaxBundle
from repro.launch import pipeline as jpl
from repro.models import encdec as jenc
from repro.models import transformer as jtf
from repro.models.config import ModelConfig as JaxModelConfig
from repro.serving import Request as JaxRequest
from repro.serving import SpecPipeDBEngine as JaxSpecPipeDBEngine
from repro_torch import configs as reg
from repro_torch.checkpoint import from_jax_params
from repro_torch.core.baselines import generate_autoregressive
from repro_torch.core.pipedec import PipeDecConfig
from repro_torch.core.speculative import ModelBundle
from repro_torch.launch import pipeline as pl
from repro_torch.launch import serve
from repro_torch.models import encdec
from repro_torch.models import transformer as tf
from repro_torch.models.layers import embed
from repro_torch.serving import (AsyncPipelineExecutor, LocalFusedExecutor,
                                 OverlappedShardedExecutor, Request,
                                 ShardedPipelineExecutor, SpecPipeDBEngine)
from test_torch_families import family_params, port_cfg
from test_torch_modality import modal_inputs
from test_torch_moe import draft_for
from test_torch_pipeline import (CAP, PCAP, TOL, W, _by_stage_np, _caches,
                                 _jax, _np, _torch)

TEXT = ("qwen2.5-32b", "qwen1.5-32b", "gemma-7b", "qwen2-moe-a2.7b")
MODAL = ("internvl2-26b", "whisper-base")
KV_LEN = 32           # model-cache rows of the stage-function cases
MAX_LEN = 64          # the engines' cache rows
TIMEOUT_S = 60.0
PCFG = PipeDecConfig(n_stages=2, width=4, branch=2)
JPCFG = JaxPipeDecConfig(n_stages=2, width=4, branch=2)
STATS = ("timesteps", "commits", "hits", "misses", "entries",
         "commits_per_step")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jcfg(arch, *, layers=None, capacity_factor=None):
    """The arch's JAX smoke config, MoE at dropless capacity unless
    ``capacity_factor`` is given, cut or grown to ``layers``."""
    jcfg = jreg.get_config(arch, smoke=True)
    if jcfg.moe is not None:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, capacity_factor=capacity_factor
            or float(jcfg.moe.num_experts)))
    if layers is not None:
        jcfg = dataclasses.replace(jcfg, num_layers=layers)
    return jcfg


@functools.lru_cache(maxsize=None)
def _pair(arch, capacity_factor=None):
    """{"target"|"draft": (port bundle, JAX bundle)} on the same weights
    (noisy QKV biases and norms): the target carries its vision prefix or
    encoder output, the one-layer dense draft neither."""
    jcfg = _jcfg(arch, capacity_factor=capacity_factor)
    params = family_params(jcfg, seed=2)
    cfg = port_cfg(jcfg)
    model = from_jax_params(cfg, params, device="cpu")
    jp = jax.tree.map(jnp.asarray, params)
    kw, jkw = {}, {}
    if cfg.is_encdec:
        x = modal_inputs(cfg, seed=1)
        jkw = {"enc_out": jenc.encode(jp["encoder"], jcfg, jnp.asarray(x))}
        kw = {"enc_out": encdec.encode(model.encoder, cfg, x)}
    elif cfg.prefix_tokens:
        x = modal_inputs(cfg, seed=1)
        jkw, kw = {"prefix_embeds": jnp.asarray(x)}, {"prefix_embeds": x}
    dcfg = draft_for(cfg.vocab_size)
    jdcfg = JaxModelConfig(**dataclasses.asdict(dcfg))
    dparams = jax.device_get(jtf.init_model(jax.random.PRNGKey(5), jdcfg))
    return {"target": (ModelBundle(model, **kw), JaxBundle(jp, jcfg, **jkw)),
            "draft": (ModelBundle(from_jax_params(dcfg, dparams,
                                                  device="cpu")),
                      JaxBundle(jax.tree.map(jnp.asarray, dparams), jdcfg))}


def _stats(st):
    return {k: getattr(st, k) for k in STATS}


def _db(st):
    return (st.timesteps, st.occupancy, st.verify_dispatches, st.accepted,
            st.proposed, st.total_commits)


# --------------------------------------------------------------------------
# the stage functions
# --------------------------------------------------------------------------
def _tree_rows(rng, cfg, batch=3):
    """Row 0 live, row 1 killed (invalid), row 2 empty: no committed
    prefix, an all-false mask, its write in the slack region."""
    mlen = np.array([5, 9, 0])
    wi = np.array([3, CAP, CAP])
    pos = mlen[:, None] + rng.integers(0, 3, size=(batch, W))
    pos[2] = 0
    mask = rng.random((batch, W, CAP + W)) < 0.4
    mask[np.arange(batch), :, wi] = True
    mask[2] = False
    x = rng.normal(size=(batch, W, cfg.d_model)).astype(np.float32)
    return x, pos, mask, wi, mlen


@pytest.mark.parametrize("layers,stages", [(2, 2), (3, 2)])
@pytest.mark.parametrize("arch", TEXT)
def test_stage_fns_match_jax(arch, layers, stages):
    """``stage_apply`` (with ``empty=`` for the empty row), ``stage_ctrl``
    and ``stage_prefill`` equal the JAX ones stage by stage: activations
    and tree rows within 1e-5, ctrl exact, the killed row's activations
    and rows untouched.  (3, 2) pads the last stage."""
    jcfg = _jcfg(arch, layers=layers)
    params = family_params(jcfg, seed=layers)
    cfg = port_cfg(jcfg)
    model = from_jax_params(cfg, params, device="cpu")
    jparams = jax.tree.map(jnp.asarray, params)
    pcfg = pl.PipelineConfig(stages, W, CAP, KV_LEN)
    j_apply, j_ctrl, j_prefill = jpl.make_stage_fns(
        jcfg, jpl.PipelineConfig(stages, W, CAP, KV_LEN))
    apply, ctrl, prefill = pl.make_stage_fns(cfg, pcfg)
    jlayers, jvalid = jpl.stage_params(jcfg, jparams, stages)
    tlayers, tvalid = pl.stage_params(model, stages)
    lps, _ = pl.stage_layout(cfg, stages)
    assert pl.stage_layout(cfg, stages) == jpl.stage_layout(jcfg, stages)
    np.testing.assert_array_equal(tvalid, np.asarray(jvalid))

    rng = np.random.default_rng(layers * 10 + stages)
    kv_np = _caches(rng, cfg, 3, KV_LEN, layers)
    tkv_np = _caches(rng, cfg, 3, CAP + W, layers)
    kvs_t = pl.split_stages(_torch(kv_np), stages)
    tkvs_t = pl.split_stages(_torch(tkv_np), stages)
    x, pos, mask, wi, mlen = _tree_rows(rng, cfg)
    on = np.array([True, False, True])
    mask_t = torch.tensor(mask)
    xj, xt = jnp.asarray(x), torch.tensor(x)
    for s in range(stages):
        sp = [jax.tree.map(lambda t, s=s: t[s], lp) for lp in jlayers]
        kvj, tkvj = (_jax(_by_stage_np(c, s, lps)) for c in (kv_np, tkv_np))
        xj, new_tkv = j_apply(sp, jvalid[s], kvj, tkvj, xj, jnp.asarray(pos),
                              jnp.asarray(mask), jnp.asarray(wi),
                              jnp.asarray(mlen), jnp.asarray(on))
        empty = pl.empty_rows(cfg, mlen, mask_t, kvs_t[s], tkvs_t[s], wi)
        assert empty is not None and empty.slots.tolist() == [2]
        xt = apply(tlayers[s], tvalid[s], kvs_t[s], tkvs_t[s], xt,
                   torch.tensor(pos), mask_t, wi,
                   torch.tensor(mlen, dtype=torch.int32), on, empty=empty)
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

    # ctrl: commit row 0 where on, then compact; exact
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
                for k in "kv":
                    np.testing.assert_array_equal(_np(kvs_t[s][i][k]),
                                                  np.asarray(kvj[i][k]))
                    np.testing.assert_array_equal(_np(tkvs_t[s][i][k]),
                                                  np.asarray(tkvj[i][k]))

    # the prefill lane, chunk mode; slot 2's chunk overruns the cache
    off = np.array([0, 0, KV_LEN - 4])
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
                                   atol=TOL)
        for i in range(lps):
            if tvalid[s, i]:
                for k in "kv":
                    got = _np(kvs_t[s][i][k])
                    np.testing.assert_allclose(got, np.asarray(new_kv[i][k]),
                                               rtol=0, atol=TOL)
                    np.testing.assert_array_equal(
                        got[1], kv_np[s * lps + i][k][1])


def flush_against_jax(t, jt, stages, mlen, seed):
    """The flush of port bundle ``t`` (``make_pipeline_verify`` with its
    cross K/V cut by stage) over one tree layer a row, the rows with
    ``mlen`` 0 empty (not pending, no committed prefix, an all-false mask,
    computed beside the others as the local verify computes them): logits
    and every layer's written tree rows within 1e-5 of the JAX
    ``tree_verify_step`` of JAX bundle ``jt`` (with its encoder output)
    over every row."""
    cfg, jcfg = t.cfg, jt.cfg
    n, b = cfg.num_layers, len(mlen)
    rng = np.random.default_rng(seed)
    kv_np = _caches(rng, cfg, b, KV_LEN, n)
    tkv_np = _caches(rng, cfg, b, CAP + W, n)
    live = mlen > 0
    wi = np.where(live, rng.integers(0, CAP - W, size=b), CAP)
    pos = np.where(live[:, None],
                   mlen[:, None] + rng.integers(0, 3, size=(b, W)), 0)
    mask = rng.random((b, W, CAP + W)) < 0.4
    mask[np.arange(b), :, wi] = True
    mask &= live[:, None, None]
    tokens = rng.integers(0, cfg.vocab_size, size=(b, W))
    stack = [{k: jnp.asarray(np.stack([c[k] for c in caches]))
              for k in "kv"} for caches in (kv_np, tkv_np)]
    want, jtree = jtf.tree_verify_step(
        jt.params, jcfg, jnp.asarray(tokens, jnp.int32),
        jnp.asarray(pos, jnp.int32), jnp.asarray(mask), {"stack": [stack[0]]},
        jnp.asarray(mlen, jnp.int32), {"stack": [stack[1]]},
        jnp.asarray(wi, jnp.int32), enc_out=jt.enc_out)

    kv_t, tkv_t = _torch(kv_np), _torch(tkv_np)
    calls = collections.Counter()
    verify = pl.make_pipeline_verify(
        cfg, pl.PipelineConfig(stages, W, CAP, KV_LEN), calls=calls,
        cross_kv=t.cross_kv)
    layers, valid = pl.stage_params(t.model, stages)
    entry = {"act": embed(t.model.embed.table, torch.tensor(tokens)),
             "positions": torch.tensor(pos), "mask": torch.tensor(mask),
             "model_len": torch.tensor(mlen, dtype=torch.int32),
             "lens": mlen, "write_idx": wi, "valid": live}
    act, exit_valid = verify(layers, valid, pl.split_stages(kv_t, stages),
                             pl.split_stages(tkv_t, stages), entry)
    np.testing.assert_array_equal(exit_valid, live)
    np.testing.assert_allclose(tf._logits(t.model, act).numpy(),
                               np.asarray(want), rtol=0, atol=TOL)
    for i in range(n):
        for k in "kv":
            np.testing.assert_allclose(
                tkv_t[i][k].numpy(), np.asarray(jtree["stack"][0][k][i]),
                rtol=0, atol=TOL)
    assert calls["stage_layers"] == n


@pytest.mark.parametrize("stages", [2, 3])
def test_whisper_flush_matches_jax_tree_verify_with_cross(stages):
    """Whisper's flush over a live row, an empty row and another live row
    (on 3 stages the last holds only padding) against the JAX
    ``tree_verify_step`` with the encoder output."""
    t, jt = _pair("whisper-base")["target"]
    flush_against_jax(t, jt, stages, np.array([6, 0, 11]), seed=stages)


# --------------------------------------------------------------------------
# serving helpers (also used by the tower and engines files)
# --------------------------------------------------------------------------
def _requests():
    rng = np.random.default_rng(3)
    return [Request(i, rng.integers(0, 100, size=int(rng.integers(3, 9))),
                    n, arrival_t=t)
            for i, (n, t) in enumerate(((5, 0), (4, 0), (6, 3)))]


def _executor(kind, target, draft, pcfg, slots, *, paged=False,
              max_len=MAX_LEN):
    kw = dict(slots=slots, max_len=max_len,
              tree_capacity=pcfg.tree_buffer_capacity,
              capacity=pcfg.capacity)
    if kind == "local":
        return LocalFusedExecutor(target, draft, paged=paged, page=16, **kw)
    if kind == "async":
        return AsyncPipelineExecutor(target, draft, n_stages=pcfg.n_stages,
                                     timeout_s=TIMEOUT_S, **kw)
    cls = (OverlappedShardedExecutor if kind == "overlapped"
           else ShardedPipelineExecutor)
    return cls(target, draft, n_stages=pcfg.n_stages, paged=paged, page=16,
               **kw)


def _serve(ex, target, draft, pcfg, reqs, *, max_len=MAX_LEN):
    eng = SpecPipeDBEngine(target, draft, pcfg, max_len=max_len,
                           max_slots=ex.slots, executor=ex)
    for r in reqs:
        eng.submit(Request(r.uid, r.prompt, r.max_new_tokens,
                           arrival_t=r.arrival_t))
    try:
        return eng, eng.run()
    finally:
        if isinstance(ex, AsyncPipelineExecutor):
            ex.shutdown()


def _jax_serve(executor_cls, arch, reqs, jpcfg, slots, *, max_len=MAX_LEN,
               capacity_factor=None, **kw):
    """Tokens of the JAX engine on ``executor_cls`` over ``reqs``."""
    b = _pair(arch, capacity_factor)
    (_, jt), (_, jd) = b["target"], b["draft"]
    jex = executor_cls(jt, jd, slots=slots, max_len=max_len,
                       tree_capacity=jpcfg.tree_buffer_capacity,
                       capacity=jpcfg.capacity, **kw)
    jeng = JaxSpecPipeDBEngine(jt, jd, jpcfg, max_len=max_len,
                               max_slots=slots, executor=jex)
    for r in reqs:
        jeng.submit(JaxRequest(r.uid, np.asarray(r.prompt, np.int32),
                               r.max_new_tokens, arrival_t=r.arrival_t))
    try:
        res = jeng.run()
    finally:
        if hasattr(jex, "shutdown"):
            jex.shutdown()
    return {uid: np.asarray(r.tokens) for uid, r in res.items()}, res, jex


# --------------------------------------------------------------------------
# the serving CLI
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch,flags", [
    ("gemma-7b", ["--executor", "sharded"]),
    ("qwen2-moe-a2.7b", ["--executor", "sharded", "--overlap", "--paged"]),
    ("qwen1.5-32b", ["--executor", "async"]),
    ("whisper-base", ["--executor", "sharded", "--overlap"])])
def test_cli_serves_families_on_the_ring(arch, flags, capsys):
    """``--target-arch <family> --mode pipedec-db --executor sharded
    [--overlap] | async [--paged]`` serves the family at smoke size on the
    2-stage ring; tokens equal autoregressive decoding."""
    engine, results = serve.main(["--mode", "pipedec-db", "--device", "cpu",
                                  "--target-arch", arch, "--requests", "2",
                                  "--new-tokens", "4", "--stages", "2",
                                  "--slots", "2", *flags])
    assert engine.target.cfg == reg.get_config(arch, smoke=True)
    capsys.readouterr()
    rng = np.random.default_rng(0)
    for uid in range(2):
        prompt = rng.integers(0, engine.target.cfg.vocab_size, size=8)
        np.testing.assert_array_equal(
            results[uid].tokens,
            generate_autoregressive(engine.target, prompt, 4))


@pytest.mark.parametrize("arch,reason", [
    ("moonshot-v1-16b-a3b", "uniform layer stack"),
    ("deepseek-v2-236b", "uniform layer stack"),
    ("mamba2-130m", "attention stacks")])
def test_cli_ring_refuses_what_the_reference_refuses(arch, reason):
    with pytest.raises(NotImplementedError, match=reason):
        serve.main(["--mode", "pipedec-db", "--device", "cpu",
                    "--target-arch", arch, "--requests", "1",
                    "--new-tokens", "2", "--stages", "2",
                    "--executor", "sharded"])
