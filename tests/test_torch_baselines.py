"""The port's STPP baseline (static-tree speculative decoding) against the
JAX package's ``STPPEngine`` on the same weights (numpy, carried across
by the weight bridge): the same tokens and every ``STPPStats`` field, and
the same tokens as the port's own autoregressive decoding; in fp32 and
in int8 (``quantize()`` on both sides)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.baselines import STPPConfig as JaxSTPPConfig
from repro.core.baselines import STPPEngine as JaxSTPPEngine
from repro.core.speculative import ModelBundle as JaxBundle
from repro.models.config import ModelConfig as JaxModelConfig
from repro_torch.checkpoint import from_jax_params
from repro_torch.core.baselines import (STPPConfig, STPPEngine, STPPStats,
                                        generate_autoregressive)
from repro_torch.core.speculative import ModelBundle, SamplingParams
from repro_torch.models.config import ModelConfig

STATS = ("rounds", "commits", "draft_steps", "accepted_per_round")
TARGET = ModelConfig(name="t-dense", family="dense", num_layers=3,
                     d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
                     vocab_size=128)
DRAFT = ModelConfig(name="t-draft", family="dense", num_layers=1,
                    d_model=32, num_heads=2, num_kv_heads=1, d_ff=64,
                    vocab_size=128)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(cfg, seed):
    """(port bundle, JAX bundle) on the same numpy weights."""
    from test_torch_model import numpy_params
    params = numpy_params(cfg, seed)
    jcfg = JaxModelConfig(**{f.name: getattr(cfg, f.name)
                             for f in dataclasses.fields(cfg)})
    return (ModelBundle(from_jax_params(cfg, params, device="cpu")),
            JaxBundle(jax.tree.map(jnp.asarray, params), jcfg))


@pytest.fixture(scope="module")
def bundles():
    """{"target"|"draft": (port, jax)}."""
    return {"target": _pair(TARGET, 0), "draft": _pair(DRAFT, 9)}


def _stats(st):
    return {k: getattr(st, k) for k in STATS}


def _check(target, draft, jtarget, jdraft, depth, width, branch, prompt,
           new):
    """Port and JAX STPP on the same pair: equal tokens and stats, and
    tokens equal to the port's autoregressive decoding.  Returns the
    port's stats."""
    out, st = STPPEngine(target, draft, STPPConfig(depth, width, branch)
                         ).generate(prompt, new)
    jout, jst = JaxSTPPEngine(jtarget, jdraft,
                              JaxSTPPConfig(depth, width, branch)).generate(
        prompt.astype(np.int32), new)
    np.testing.assert_array_equal(out, jout)
    np.testing.assert_array_equal(
        out, generate_autoregressive(target, prompt, new))
    assert _stats(st) == _stats(jst)
    assert st.mean_accepted == jst.mean_accepted
    return st


def test_stpp_matches_jax_engine(bundles):
    """A random draft (mostly misses): depth 3, width 4, branch 2."""
    (t, jt), (d, jd) = bundles["target"], bundles["draft"]
    st = _check(t, d, jt, jd, 3, 4, 2, np.array([2, 7, 7, 1]), 12)
    assert st.rounds >= 1 and st.commits == 12
    assert st.draft_steps == 3 * st.rounds


def test_stpp_self_draft_matches_jax_engine(bundles):
    """Draft == target, depth 3, width 8, branch 4, 40 tokens: the
    per-round acceptance equals the JAX engine's own on these weights,
    and every round but the last accepts a token (the target's greedy
    child of the root is among the branch-4 candidates)."""
    t, jt = bundles["target"]
    st = _check(t, t, jt, jt, 3, 8, 4, np.array([3, 3, 8]), 40)
    assert all(a >= 1 for a in st.accepted_per_round[:-1])
    assert st.mean_accepted > 1.0


def test_stpp_int8_matches_jax_engine(bundles):
    """int8 pair (``quantize()`` on both sides): the same tokens and stats
    as the JAX package's int8 engine, and the same tokens as the port's
    own int8 autoregressive decoding; random draft and self-draft."""
    (t, jt), (d, jd) = bundles["target"], bundles["draft"]
    qt, qd, jqt, jqd = t.quantize(), d.quantize(), jt.quantize(), \
        jd.quantize()
    prompt = np.array([5, 1, 9, 2])
    _check(qt, qd, jqt, jqd, 3, 4, 2, prompt, 10)
    st = _check(qt, qt, jqt, jqt, 3, 8, 4, prompt, 12)
    assert st.mean_accepted > 1.0


def test_stpp_calls_and_sampling(bundles):
    """One target tree verify and ``depth`` draft tree verifies per round,
    one commit per committed token; a stochastic run draws from the
    target only and a seeded generator replays it."""
    (t, _), (d, _) = bundles["target"], bundles["draft"]
    t.calls.clear()
    d.calls.clear()
    out, st = STPPEngine(t, d, STPPConfig(2, 4, 2)).generate(
        np.array([1, 2, 3]), 8)
    assert t.calls["tree_verify"] == st.rounds
    assert d.calls["tree_verify"] == st.draft_steps == 2 * st.rounds
    assert t.calls["commit"] == d.calls["commit"] == st.commits == 8
    assert t.calls["prefill"] == d.calls["prefill"] == 1
    assert isinstance(st, STPPStats) and len(out) == 9

    sp = SamplingParams(temperature=0.8, top_k=40, top_p=0.9)
    eng = STPPEngine(t, d, STPPConfig(2, 4, 2, sampling=sp))
    runs = [eng.generate(np.array([4, 4, 2]), 10,
                         generator=torch.Generator().manual_seed(7))[0]
            for _ in range(2)]
    np.testing.assert_array_equal(*runs)
    assert len(runs[0]) == 11 and ((runs[0] >= 0) & (runs[0] < 128)).all()
