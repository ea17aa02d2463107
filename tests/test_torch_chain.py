"""The port's chain-mode speculative decoding (PipeDec with a width-1
tree) against the JAX package's ``ChainSpecEngine`` on the same dense
weights (numpy, carried across by the weight bridge): the same tokens and
``GenStats``, and the same tokens as autoregressive decoding.  The port
rolls back by cache length, where the JAX engine keeps a cache per chain
position; equal stats at every stage count show the two agree."""
import numpy as np
import pytest
import torch

from repro.core.chain import ChainConfig as JaxChainConfig
from repro.core.chain import ChainSpecEngine as JaxChainSpecEngine
from repro_torch.core.baselines import generate_autoregressive
from repro_torch.core.chain import ChainConfig, ChainSpecEngine
from repro_torch.core.speculative import SamplingParams

STATS = ("timesteps", "commits", "hits", "misses", "entries",
         "commits_per_step")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def bundles():
    """{"target"|"draft": (port, jax)} on the same numpy weights."""
    from test_torch_baselines import DRAFT, TARGET, _pair
    return {"target": _pair(TARGET, 0), "draft": _pair(DRAFT, 9)}


def _stats(st):
    return {k: getattr(st, k) for k in STATS}


@pytest.mark.parametrize("stages", [1, 2, 4, 8])
def test_chain_matches_jax_engine(bundles, stages):
    (t, jt), (d, jd) = bundles["target"], bundles["draft"]
    prompt = np.array([9, 1, 4, 4])
    out, st = ChainSpecEngine(t, d, ChainConfig(n_stages=stages),
                              max_len=64).generate(prompt, 12)
    jout, jst = JaxChainSpecEngine(jt, jd, JaxChainConfig(n_stages=stages),
                                   max_len=64).generate(
        prompt.astype(np.int32), 12)
    np.testing.assert_array_equal(out, jout)
    np.testing.assert_array_equal(
        out, generate_autoregressive(t, prompt, 12, max_len=64))
    assert _stats(st) == _stats(jst)
    assert st.commits >= 12


def test_chain_self_draft_never_misses(bundles):
    """Draft == target: every chain token hits, the JAX engine's stats on
    the same weights, and the pipeline stays nearly full."""
    t, jt = bundles["target"]
    prompt = np.array([5, 5, 2])
    out, st = ChainSpecEngine(t, t, ChainConfig(n_stages=4),
                              max_len=64).generate(prompt, 16)
    jout, jst = JaxChainSpecEngine(jt, jt, JaxChainConfig(n_stages=4),
                                   max_len=64).generate(
        prompt.astype(np.int32), 16)
    np.testing.assert_array_equal(out, jout)
    assert _stats(st) == _stats(jst)
    assert st.misses == 0 and st.acceptance == 1.0
    assert st.tokens_per_timestep > 0.7


def test_chain_int8_and_sampling(bundles):
    """int8 pair: tokens equal the port's int8 autoregressive decoding and
    the JAX int8 engine's; a seeded stochastic run replays."""
    (t, jt), (d, jd) = bundles["target"], bundles["draft"]
    qt, qd = t.quantize(), d.quantize()
    prompt = np.array([3, 1, 4, 1, 5])
    out, st = ChainSpecEngine(qt, qd, ChainConfig(n_stages=3),
                              max_len=64).generate(prompt, 10)
    jout, jst = JaxChainSpecEngine(jt.quantize(), jd.quantize(),
                                   JaxChainConfig(n_stages=3),
                                   max_len=64).generate(
        prompt.astype(np.int32), 10)
    np.testing.assert_array_equal(out, jout)
    np.testing.assert_array_equal(
        out, generate_autoregressive(qt, prompt, 10, max_len=64))
    assert _stats(st) == _stats(jst)

    sp = SamplingParams(temperature=0.7, top_k=30)
    eng = ChainSpecEngine(t, d, ChainConfig(n_stages=2, sampling=sp),
                          max_len=64)
    runs = [eng.generate(prompt, 8, torch.Generator().manual_seed(3))[0]
            for _ in range(2)]
    np.testing.assert_array_equal(*runs)
    assert len(runs[0]) == 9
