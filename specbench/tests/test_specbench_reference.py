"""The plain reference against the program's CPU path at the two smoke
configurations (the MoE at dropless capacity), on weights the harness drew:
the logits of a whole-sequence forward, and of a prefill."""
import numpy as np
import pytest
import torch

from specbench.lib import weights
from specbench.tests import smoke


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("kind", ["qwen2", "qwen2_moe"])
def test_reference_matches_the_program(kind):
    from repro_torch.models import transformer as tf
    cfg = smoke.config(kind)
    ref, _ = weights.family(cfg)
    w = weights.make(ref.weight_spec(cfg), 2 ** 31 + 3, "cpu")
    bundle = weights.port_model(cfg, w)
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg["vocab_size"], 40))
    want = ref.logits(w, cfg, toks)
    with torch.no_grad():
        got = tf.forward(bundle.model, toks[None])[0]
        cache = bundle.init_cache(1, 64)
        last, _ = bundle.prefill(toks[None], cache)
    scale = want.abs().max()
    assert float((got - want).abs().max()) <= 1e-5 * scale
    assert float((last[0] - want[-1]).abs().max()) <= 1e-5 * scale


def test_moe_reference_reads_the_departures():
    """With the published block (no renormalisation, a gated shared
    expert) the reference computes something else than the program."""
    cfg = smoke.config("qwen2_moe")
    published = {**cfg, "norm_topk_prob": False, "departures": {}}
    ref, _ = weights.family(cfg)
    w = weights.make(ref.weight_spec(published), 5, "cpu")
    toks = torch.arange(12)
    served = ref.logits(w, cfg, toks)
    pub = ref.logits(w, published, toks)
    assert float((served - pub).abs().max()) > 1e-3
    _, port = weights.family(cfg)
    with pytest.raises(ValueError):
        port.model_config(published)
