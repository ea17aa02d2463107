"""The window override through ``ModelBundle``, ``quantize()`` and every
engine that drives a bundle, against the JAX package's engines on
bundles with the same ``window_override``, at smoke size on bridged
weights: autoregressive decoding, PipeDec, STPP, chain speculation and
SpecPipe-DB (dense and paged), with Qwen 2.5's smoke target (QKV bias)
and the one-layer dense draft, both with a 4-key window, on prompts past
it.

Tolerances: logits within 1e-4; int8 logits within 1e-3 (the int8
parity tolerance of ``test_torch_quant_model.py``); greedy tokens and
stats equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jreg
from repro.core.baselines import STPPConfig as JaxSTPPConfig
from repro.core.baselines import STPPEngine as JaxSTPPEngine
from repro.core.baselines import \
    generate_autoregressive as jax_generate_autoregressive
from repro.core.chain import ChainConfig as JaxChainConfig
from repro.core.chain import ChainSpecEngine as JaxChainSpecEngine
from repro.core.pipedec import PipeDecConfig as JaxPipeDecConfig
from repro.core.pipedec import PipeDecEngine as JaxPipeDecEngine
from repro.core.speculative import ModelBundle as JaxBundle
from repro.models import transformer as jtf
from repro.models.config import ModelConfig as JaxModelConfig
from repro.serving import LocalFusedExecutor as JaxLocalFusedExecutor
from repro.serving import Request as JaxRequest
from repro.serving import SpecPipeDBEngine as JaxSpecPipeDBEngine
from repro_torch.checkpoint import from_jax_params
from repro_torch.core.baselines import (STPPConfig, STPPEngine,
                                        generate_autoregressive)
from repro_torch.core.chain import ChainConfig, ChainSpecEngine
from repro_torch.core.pipedec import PipeDecConfig, PipeDecEngine
from repro_torch.core.speculative import ModelBundle
from repro_torch.models import transformer as tf
from repro_torch.serving import LocalFusedExecutor, Request, SpecPipeDBEngine
from test_torch_families import family_params, port_cfg
from test_torch_moe import draft_for
from test_torch_window import MAX_LEN, _cl

TOL_INT8 = 1e-3
GEN = ("timesteps", "commits", "hits", "misses", "entries",
       "commits_per_step")
WO = 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    """{"target", "draft"}: (port bundle, JAX bundle) on the same weights,
    both with a 4-key window override: Qwen 2.5's smoke target (QKV
    bias) and the one-layer dense draft."""
    jcfg = jreg.get_config("qwen2.5-32b", smoke=True)
    params = family_params(jcfg, seed=0)
    cfg = port_cfg(jcfg)
    dcfg = draft_for(cfg.vocab_size)
    jdcfg = JaxModelConfig(**dataclasses.asdict(dcfg))
    dparams = jax.device_get(jtf.init_model(jax.random.PRNGKey(5), jdcfg))
    return {"target": (ModelBundle(from_jax_params(cfg, params,
                                                   device="cpu"),
                                   window_override=WO),
                       JaxBundle(jax.tree.map(jnp.asarray, params), jcfg,
                                 window_override=WO)),
            "draft": (ModelBundle(from_jax_params(dcfg, dparams,
                                                  device="cpu"),
                                  window_override=WO),
                      JaxBundle(jax.tree.map(jnp.asarray, dparams), jdcfg,
                                window_override=WO))}


def _stats(st, keys):
    return {k: getattr(st, k) for k in keys}


PROMPT = np.array([7, 3, 11, 2, 9, 4, 1], np.int64)


def test_bundle_steps_take_the_override(pair):
    """The bundle's prefill, decode and forward equal the model functions
    with its override, and differ from the config's window."""
    t, jt = pair["target"]
    plain = ModelBundle(t.model)
    with torch.no_grad():
        got = t.forward(PROMPT[None])
        want = tf.forward(t.model, PROMPT[None], window_override=WO)
        assert torch.equal(got, want)
        assert not torch.allclose(got, plain.forward(PROMPT[None]))
    jl, _ = jt.prefill(jnp.asarray(PROMPT[None].astype(np.int32)),
                       jtf.init_cache(jt.cfg, 1, MAX_LEN))
    tl, _ = t.prefill(PROMPT[None], t.init_cache(1, MAX_LEN))
    _cl(tl, jl)
    assert t.calls["forward"] == 1


def test_autoregressive_pipedec_stpp_chain_match_jax(pair):
    """Greedy tokens (and PipeDec's, STPP's and chain's stats) against the
    JAX engines on bundles with the same override; the speculative ones
    lossless against autoregressive decoding."""
    (t, jt), (d, jd) = pair["target"], pair["draft"]
    jprompt = PROMPT.astype(np.int32)
    ar = generate_autoregressive(t, PROMPT, 10, max_len=MAX_LEN)
    np.testing.assert_array_equal(
        ar, jax_generate_autoregressive(jt, jprompt, 10, max_len=MAX_LEN))
    out, st = PipeDecEngine(t, d, PipeDecConfig(3, 4, 2),
                            max_len=MAX_LEN).generate(PROMPT, 10)
    jout, jst = JaxPipeDecEngine(jt, jd, JaxPipeDecConfig(3, 4, 2),
                                 max_len=MAX_LEN).generate(jprompt, 10)
    np.testing.assert_array_equal(out, jout)
    np.testing.assert_array_equal(out, ar)
    assert _stats(st, GEN) == _stats(jst, GEN)
    sout, sst = STPPEngine(t, d, STPPConfig(3, 4, 2),
                           max_len=MAX_LEN).generate(PROMPT, 10)
    jsout, jsst = JaxSTPPEngine(jt, jd, JaxSTPPConfig(3, 4, 2),
                                max_len=MAX_LEN).generate(jprompt, 10)
    np.testing.assert_array_equal(sout, jsout)
    np.testing.assert_array_equal(sout, ar)
    assert _stats(sst, ("rounds", "commits", "draft_steps")) == _stats(
        jsst, ("rounds", "commits", "draft_steps"))
    cout, cst = ChainSpecEngine(t, d, ChainConfig(n_stages=3),
                                max_len=MAX_LEN).generate(PROMPT, 10)
    jcout, jcst = JaxChainSpecEngine(jt, jd, JaxChainConfig(n_stages=3),
                                     max_len=MAX_LEN).generate(jprompt, 10)
    np.testing.assert_array_equal(cout, jcout)
    np.testing.assert_array_equal(cout, ar)
    assert _stats(cst, GEN) == _stats(jcst, GEN)
    # the override changes what is decoded here: the config's window
    # (none) gives other tokens
    free = generate_autoregressive(ModelBundle(t.model), PROMPT, 10,
                                   max_len=MAX_LEN)
    assert not np.array_equal(free, ar)


def _requests():
    rng = np.random.default_rng(3)
    return [(i, rng.integers(0, 100, size=int(rng.integers(6, 11))), n, t)
            for i, (n, t) in enumerate(((6, 0), (5, 0), (6, 3)))]


@pytest.mark.parametrize("paged", [False, True])
def test_db_matches_jax_engine(pair, paged):
    """SpecPipe-DB, 3 requests on 2 slots (arrivals 0, 0, 3), prompts of
    6-10 tokens past the 4-key window: tokens, per-request stats and the
    executor's counts against the JAX engine on the same bundles, dense
    and paged, lossless against autoregressive decoding."""
    (t, jt), (d, jd) = pair["target"], pair["draft"]
    pcfg, jpcfg = PipeDecConfig(3, 4, 2), JaxPipeDecConfig(3, 4, 2)
    ex = LocalFusedExecutor(t, d, slots=2, max_len=MAX_LEN,
                            tree_capacity=pcfg.tree_buffer_capacity,
                            capacity=pcfg.capacity, paged=paged, page=16)
    eng = SpecPipeDBEngine(t, d, pcfg, max_len=MAX_LEN, max_slots=2,
                           executor=ex)
    jex = JaxLocalFusedExecutor(jt, jd, slots=2, max_len=MAX_LEN,
                                tree_capacity=jpcfg.tree_buffer_capacity,
                                capacity=jpcfg.capacity, paged=paged,
                                page=16)
    jeng = JaxSpecPipeDBEngine(jt, jd, jpcfg, max_len=MAX_LEN, max_slots=2,
                               executor=jex)
    for uid, prompt, n, at in _requests():
        eng.submit(Request(uid, prompt, n, arrival_t=at))
        jeng.submit(JaxRequest(uid, prompt.astype(np.int32), n,
                               arrival_t=at))
    res, jres = eng.run(), jeng.run()
    assert set(res) == set(jres) == {0, 1, 2}
    for uid, prompt, n, _ in _requests():
        np.testing.assert_array_equal(res[uid].tokens, jres[uid].tokens)
        np.testing.assert_array_equal(
            res[uid].tokens, generate_autoregressive(t, prompt, n,
                                                     max_len=MAX_LEN))
        assert _stats(res[uid].stats, GEN) == _stats(jres[uid].stats, GEN)
    for key in ("verify_rows", "commit_rows", "remap_rows"):
        assert ex.calls[key] == jex.calls[key], key


def test_quantize_keeps_the_override(pair):
    """``quantize()`` carries the override; the int8 bundle's prefill and
    decode logits against the JAX int8 bundle's, which carries it too."""
    t, jt = pair["target"]
    qt, jqt = t.quantize(), jt.quantize()
    assert qt.window_override == jqt.window_override == WO
    tokens = PROMPT[None]
    jl, jc = jqt.prefill(jnp.asarray(tokens.astype(np.int32)),
                         jqt.init_cache(1, MAX_LEN))
    tl, tc = qt.prefill(tokens, qt.init_cache(1, MAX_LEN))
    _cl(tl, jl, TOL_INT8)
    free, _ = ModelBundle(qt.model).prefill(tokens,
                                            qt.init_cache(1, MAX_LEN))
    assert not torch.allclose(free, tl)
    jl, _ = jqt.decode(jnp.asarray([5], np.int32), jc, len(PROMPT))
    tl, _ = qt.decode(np.array([5]), tc, len(PROMPT))
    _cl(tl, jl, TOL_INT8)
