"""The tower on the port's stage ring for the attention and modality
families (Qwen 2.5 and 1.5, Gemma, Qwen-MoE at dropless capacity,
InternVL2 with its vision prefix, Whisper with its encoder output), at
smoke size on bridged weights, on the CPU with the kernels' plain
versions: single == local == flush == overlapped == async in tokens and
GenStats, dense and paged (the async executor has no paged arena), the
tokens equal to the JAX ``SpecPipeDBEngine`` on ``LocalFusedExecutor``,
and the overlapped ring's prefill lane off for a prefix or an encoder
output.  The bundles and serving helpers are
``test_torch_ring_families``'s.
"""
import functools

import numpy as np
import pytest
import torch

from repro.serving import LocalFusedExecutor as JaxLocalFusedExecutor
from repro_torch.core.pipedec import PipeDecEngine
from repro_torch.serving.executor import PREFILL_LANE
from test_torch_ring_families import (JPCFG, MAX_LEN, MODAL, PCFG, TEXT, _db,
                                      _executor, _jax_serve, _pair,
                                      _requests, _serve, _stats)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _jax_local_tokens(arch):
    tokens, _, _ = _jax_serve(JaxLocalFusedExecutor, arch, _requests(),
                              JPCFG, 2)
    return tokens


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("arch", TEXT + MODAL)
def test_tower_single_local_flush_overlapped_async(arch, paged):
    """3 requests on 2 slots, arrivals 0, 0, 3, the 2-stage ring: every
    request's tokens and GenStats are the single-request engine's on the
    local, flush, overlapped and (dense) async executors, and its tokens
    the JAX local engine's; the flush's DBStats equal the local run's, the
    others' acceptance too.  A vision prefix or an encoder output turns
    the overlapped ring's prefill lane off (``prefill_cap`` 0, no prefill
    in the ring, one separate prefill a request); text families keep the
    64-token lane and prefill every request in the ring."""
    b = _pair(arch)
    (t, _), (d, _) = b["target"], b["draft"]
    reqs = _requests()
    single = PipeDecEngine(t, d, PCFG, max_len=MAX_LEN)
    want = {r.uid: single.generate(r.prompt, r.max_new_tokens)
            for r in reqs}
    jtokens = _jax_local_tokens(arch)
    kinds = ("local", "flush", "overlapped") + (() if paged else ("async",))
    runs = {}
    for kind in kinds:
        ex = _executor(kind, t, d, PCFG, 2, paged=paged)
        eng, res = _serve(ex, t, d, PCFG, reqs)
        runs[kind] = eng, ex
        for uid, (tokens, stats) in want.items():
            np.testing.assert_array_equal(res[uid].tokens, tokens,
                                          err_msg=f"{kind} uid {uid}")
            np.testing.assert_array_equal(res[uid].tokens, jtokens[uid])
            assert _stats(res[uid].stats) == _stats(stats), (kind, uid)
    local = runs["local"][0].stats
    assert _db(runs["flush"][0].stats) == _db(local)
    for kind in kinds[2:]:
        st = runs[kind][0].stats
        assert (st.accepted, st.proposed) == (local.accepted, local.proposed)
    eng, ex = runs["overlapped"]
    if arch in MODAL:
        assert ex.prefill_cap == 0
        assert ex.calls["prefill_in_ring"] == 0
        assert eng.stats.separate_prefill_dispatches == len(reqs)
    else:
        assert ex.prefill_cap == min(PREFILL_LANE, MAX_LEN)
        assert ex.calls["prefill_in_ring"] == len(reqs)
        assert eng.stats.separate_prefill_dispatches == 0
    assert eng.stats.tick_dispatches == [1] * eng.stats.timesteps
    eng, ex = runs["flush"]
    assert ex.calls["stage_layers"] == t.cfg.num_layers * \
        ex.calls["pipeline_verify"]
