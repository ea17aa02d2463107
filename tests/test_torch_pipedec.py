"""The port's PipeDec engine: greedy tokens and GenStats equal to the JAX
package's engine on the smoke pair (bridged weights), and equal to the
port's own autoregressive decoding (losslessness)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.pipedec import PipeDecConfig as JaxPipeDecConfig
from repro.core.pipedec import PipeDecEngine as JaxPipeDecEngine
from repro.core.speculative import ModelBundle as JaxBundle
from repro.models.config import ModelConfig as JaxModelConfig
from repro_torch.checkpoint import from_jax_params
from repro_torch.configs import pipedec_pair
from repro_torch.core.baselines import generate_autoregressive
from repro_torch.core.pipedec import (PipeDecConfig, PipeDecEngine,
                                      remap_flight_indices)
from repro_torch.core.speculative import ModelBundle, SamplingParams
from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig

STATS = ("timesteps", "commits", "hits", "misses", "entries",
         "commits_per_step")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(cfg, seed):
    """JAX-layout weights drawn with numpy (see test_torch_model)."""
    from test_torch_model import numpy_params
    return numpy_params(cfg, seed)


def _jax_bundle(cfg, params):
    jcfg = JaxModelConfig(**{f.name: getattr(cfg, f.name)
                             for f in dataclasses.fields(cfg)})
    return JaxBundle(jax.tree.map(jnp.asarray, params), jcfg)


@pytest.fixture(scope="module")
def tiny():
    cfg = ModelConfig(name="t-dense", family="dense", num_layers=3,
                      d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
                      vocab_size=128)
    dcfg = ModelConfig(name="t-draft", family="dense", num_layers=1,
                       d_model=32, num_heads=2, num_kv_heads=1, d_ff=64,
                       vocab_size=128)
    return (ModelBundle(tf.init_model(cfg, seed=0, device="cpu")),
            ModelBundle(tf.init_model(dcfg, seed=9, device="cpu")))


def test_pipedec_matches_jax_engine():
    """Smoke pair, same weights in both packages: the same tokens and the
    same hit/miss/commit/timestep counts, with a real draft (mostly
    misses) and with the target as its own draft (all hits)."""
    tcfg, dcfg = pipedec_pair.TARGET_SMOKE, pipedec_pair.DRAFT_SMOKE
    tp, dp = _params(tcfg, 0), _params(dcfg, 1)
    target = ModelBundle(from_jax_params(tcfg, tp, device="cpu"))
    draft = ModelBundle(from_jax_params(dcfg, dp, device="cpu"))
    jtarget, jdraft = _jax_bundle(tcfg, tp), _jax_bundle(dcfg, dp)
    prompt = np.random.default_rng(0).integers(0, tcfg.vocab_size, 8)
    ar = generate_autoregressive(target, prompt, 12)
    for (t, d), (jt, jd) in (((target, draft), (jtarget, jdraft)),
                             ((target, target), (jtarget, jtarget))):
        out, st = PipeDecEngine(t, d, PipeDecConfig(3, 4, 2)).generate(
            prompt, 12)
        jout, jst = JaxPipeDecEngine(jt, jd, JaxPipeDecConfig(3, 4, 2)
                                     ).generate(prompt, 12)
        np.testing.assert_array_equal(out, jout)
        np.testing.assert_array_equal(out, ar)
        assert {k: getattr(st, k) for k in STATS} == \
            {k: getattr(jst, k) for k in STATS}
    assert st.hits == 12 and st.misses == 0      # the self-draft run


@pytest.mark.parametrize("stages", [1, 2, 4])
def test_pipedec_lossless_greedy(tiny, stages):
    target, draft = tiny
    prompt = np.array([1, 5, 9, 3])
    ar = generate_autoregressive(target, prompt, 16)
    out, stats = PipeDecEngine(target, draft, PipeDecConfig(
        n_stages=stages, width=4, branch=2)).generate(prompt, 16)
    np.testing.assert_array_equal(ar, out)
    assert stats.commits >= 16


def test_self_draft_perfect_acceptance(tiny):
    """Draft == target: every prediction hits, and the pipeline commits
    about one token per timestep once full (the JAX package's pin)."""
    target, _ = tiny
    eng = PipeDecEngine(target, target,
                        PipeDecConfig(n_stages=4, width=8, branch=4))
    out, stats = eng.generate(np.array([3, 3, 8]), 40)
    assert stats.acceptance == 1.0
    assert stats.tokens_per_timestep > 0.75
    np.testing.assert_array_equal(
        out, generate_autoregressive(target, np.array([3, 3, 8]), 40))


@pytest.mark.parametrize("stages", [2, 5])
def test_pipeline_fill_latency(tiny, stages):
    """An entry at timestep t exits at t + n_stages - 1: the first commit
    lands at local timestep n_stages."""
    target, draft = tiny
    _, stats = PipeDecEngine(target, draft, PipeDecConfig(
        n_stages=stages, width=2, branch=1)).generate(np.array([0, 1, 2]), 4)
    assert stats.commits_per_step[:stages - 1] == [0] * (stages - 1)
    assert stats.commits_per_step[stages - 1] == 1


def test_stochastic_decoding_runs(tiny):
    """Sampling draws from the target only with a torch.Generator; the run
    stays well formed and a seed replays it."""
    target, draft = tiny
    sp = SamplingParams(temperature=0.6, top_p=0.9, top_k=80)
    eng = PipeDecEngine(target, draft, PipeDecConfig(n_stages=3, width=4,
                                                     branch=2, sampling=sp))
    out, stats = eng.generate(np.array([4, 4, 2]), 12, seed=123)
    again, _ = eng.generate(np.array([4, 4, 2]), 12, seed=123)
    assert len(out) == 13 and stats.commits >= 12
    assert ((out >= 0) & (out < target.cfg.vocab_size)).all()
    np.testing.assert_array_equal(out, again)


def test_remap_flight_indices_int32():
    imap = np.array([-1, 0, 1, -1, 2], np.int32)
    got = remap_flight_indices(np.array([4, -1, 0, 2], np.int32), imap)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, [2, -1, -1, 1])


def test_verify_calls_are_counted(tiny):
    target, draft = tiny
    target.calls.clear()
    draft.calls.clear()
    _, stats = PipeDecEngine(target, draft, PipeDecConfig(
        n_stages=2, width=2, branch=2)).generate(np.array([7, 7]), 5)
    assert target.calls["tree_verify"] == draft.calls["tree_verify"] == \
        stats.entries
    assert target.calls["commit"] == stats.commits
    assert target.calls["prefill"] == draft.calls["prefill"] == 1
