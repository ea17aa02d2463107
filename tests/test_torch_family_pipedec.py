"""PipeDec over the attention families: tokens and ``GenStats`` of the
port's engine against the JAX ``PipeDecEngine`` on the same weights (the
draft and capacity rule of the JAX package's own family test,
``tests/test_chain_and_families.py``: a one-layer dense draft, dropless
MoE capacity), and against the port's autoregressive decoding.
"""
import numpy as np
import pytest
import torch

from repro.core.pipedec import PipeDecConfig as JaxPipeDecConfig
from repro.core.pipedec import PipeDecEngine as JaxPipeDecEngine
from repro_torch.core.baselines import generate_autoregressive
from repro_torch.core.pipedec import PipeDecConfig, PipeDecEngine
from test_torch_moe import bundles

STATS = ("timesteps", "commits", "hits", "misses", "entries",
         "commits_per_step")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", ["qwen2.5-32b", "qwen1.5-32b", "gemma-7b",
                                  "moonshot-v1-16b-a3b", "qwen2-moe-a2.7b",
                                  "deepseek-v2-236b"])
def test_pipedec_matches_jax_engine_per_family(arch):
    b = bundles(arch, 0)
    (target, jtarget), (draft, jdraft) = b["target"], b["draft"]
    prompt = np.array([7, 3, 11, 2], np.int64)
    out, st = PipeDecEngine(target, draft, PipeDecConfig(3, 4, 2),
                            max_len=64).generate(prompt, 10)
    jout, jst = JaxPipeDecEngine(jtarget, jdraft, JaxPipeDecConfig(3, 4, 2),
                                 max_len=64).generate(
        prompt.astype(np.int32), 10)
    np.testing.assert_array_equal(out, jout)
    np.testing.assert_array_equal(
        out, generate_autoregressive(target, prompt, 10, max_len=64))
    assert {k: getattr(st, k) for k in STATS} == \
        {k: getattr(jst, k) for k in STATS}
