"""SpecPipe-DB over the MoE and MLA families: the port's
``SpecPipeDBEngine`` on the local executor, dense and paged arenas, for
the DeepSeek-V2 and Moonlight smoke models against the JAX
``SpecPipeDBEngine`` (tokens, per-request ``GenStats``, occupancy, the
executor's counts, page counters) and against autoregressive decoding, at
dropless MoE capacity (``test_torch_moe.bundles``).
"""
import numpy as np
import pytest
import torch

from repro.core.pipedec import PipeDecConfig as JaxPipeDecConfig
from repro.serving import LocalFusedExecutor as JaxLocalFusedExecutor
from repro.serving import Request as JaxRequest
from repro.serving import SpecPipeDBEngine as JaxSpecPipeDBEngine
from repro_torch.core.baselines import generate_autoregressive
from repro_torch.core.pipedec import PipeDecConfig
from repro_torch.serving import (LocalFusedExecutor, Request,
                                 SpecPipeDBEngine)
from test_torch_moe import bundles

STATS = ("timesteps", "commits", "hits", "misses", "entries",
         "commits_per_step")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _requests(seed):
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(0, 100, size=int(rng.integers(3, 9))), n, t)
            for i, (n, t) in enumerate(((5, 0), (4, 0), (6, 3)))]


@pytest.mark.parametrize("arch,paged,self_draft", [
    ("deepseek-v2-236b", False, False), ("deepseek-v2-236b", True, False),
    ("moonshot-v1-16b-a3b", False, False),
    ("moonshot-v1-16b-a3b", True, False),
    ("deepseek-v2-236b", True, True)])
def test_db_matches_jax_engine(arch, paged, self_draft):
    """3 requests on 2 slots with a staggered arrival: tokens, per-request
    GenStats, the occupancy trace and the executor's counts equal the JAX
    engine's, on the dense and the paged arena (MLA's compressed rows
    paged like K/V).  With the target as its own draft every prediction
    hits, so the batched commit and prune remap move MLA rows."""
    b = bundles(arch, 1)
    (target, jtarget), (draft, jdraft) = b["target"], (
        b["target"] if self_draft else b["draft"])
    pcfg, jpcfg = PipeDecConfig(3, 4, 2), JaxPipeDecConfig(3, 4, 2)
    ex = LocalFusedExecutor(target, draft, slots=2, max_len=128,
                            tree_capacity=pcfg.tree_buffer_capacity,
                            capacity=pcfg.capacity, paged=paged, page=16)
    eng = SpecPipeDBEngine(target, draft, pcfg, max_len=128, max_slots=2,
                           executor=ex)
    jex = JaxLocalFusedExecutor(jtarget, jdraft, slots=2, max_len=128,
                                tree_capacity=jpcfg.tree_buffer_capacity,
                                capacity=jpcfg.capacity, paged=paged,
                                page=16)
    jeng = JaxSpecPipeDBEngine(jtarget, jdraft, jpcfg, max_len=128,
                               max_slots=2, executor=jex)
    for uid, prompt, n, t in _requests(3):
        eng.submit(Request(uid, prompt, n, arrival_t=t))
        jeng.submit(JaxRequest(uid, prompt.astype(np.int32), n,
                               arrival_t=t))
    res, jres = eng.run(), jeng.run()
    assert set(res) == set(jres) == {0, 1, 2}
    for uid, prompt, n, _ in _requests(3):
        np.testing.assert_array_equal(res[uid].tokens, jres[uid].tokens)
        np.testing.assert_array_equal(
            res[uid].tokens, generate_autoregressive(target, prompt, n,
                                                     max_len=128))
        assert {k: getattr(res[uid].stats, k) for k in STATS} == \
            {k: getattr(jres[uid].stats, k) for k in STATS}
    assert eng.stats.occupancy == jeng.stats.occupancy
    for key in ("verify_rows", "commit_rows", "remap_rows"):
        assert ex.calls[key] == jex.calls[key], key
    if paged:
        assert eng.stats.page_counters == jeng.stats.page_counters
    if self_draft:
        assert eng.stats.acceptance_rate == 1.0 and ex.calls["remap_rows"]
