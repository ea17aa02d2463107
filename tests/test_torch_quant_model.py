"""The port's int8 serving path against the JAX package's, on the smoke
pair with the same weights in both packages (numpy, carried across by the
weight bridge): ``ModelBundle.quantize()``, the int8 KV cache, the logits
of prefill, decode and tree verification, PipeDec tokens and stats, and
the serving CLI with ``--quant int8``.

Tolerances.  Weight quantization from the same fp32 weights is exact.
The K/V rows are quantized at run time from activations that the two
packages compute with fp32 sums in another order; where a value lies
within an ulp of a rounding boundary its int8 value can differ by one
step (amax/127 of that row), which moves a logit by up to about 1e-3 at
these widths.  So int8 logits are held to 1e-3 absolute, not the fp32
path's 1e-4, and cached int8 values to one step.  (On these seeded inputs
no int8 value differs and the logits agree within 1e-6.)  Greedy tokens
and PipeDec stats must be equal.
"""
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
from repro_torch.core.pipedec import PipeDecConfig, PipeDecEngine
from repro_torch.core.speculative import (QUANT_WEIGHTS, ModelBundle,
                                          remap_tree_caches)
from repro_torch.kernels import quant
from repro_torch.launch import serve
from repro_torch.models import transformer as tf
from repro_torch.models.layers import QuantWeight

LOGIT_ATOL = 1e-3
STATS = ("timesteps", "commits", "hits", "misses", "entries",
         "commits_per_step")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_cfg(cfg):
    return JaxModelConfig(**{f.name: getattr(cfg, f.name)
                             for f in dataclasses.fields(cfg)})


def _pair(cfg, seed):
    """(port fp32 bundle, JAX fp32 bundle) on the same numpy weights."""
    from test_torch_model import numpy_params
    params = numpy_params(cfg, seed)
    return (ModelBundle(from_jax_params(cfg, params, device="cpu")),
            JaxBundle(jax.tree.map(jnp.asarray, params), _jax_cfg(cfg)))


@pytest.fixture(scope="module")
def smoke():
    """fp32 and int8 bundles of the smoke pair in both packages:
    {"target"|"draft": (port, jax, port int8, jax int8)}."""
    out = {}
    for name, cfg, seed in (("target", pipedec_pair.TARGET_SMOKE, 0),
                            ("draft", pipedec_pair.DRAFT_SMOKE, 1)):
        port, jx = _pair(cfg, seed)
        out[name] = (port, jx, port.quantize(), jx.quantize())
    return out


def test_quantize_is_bit_equal_to_jax(smoke):
    """The port's quantize() == the JAX package's quantize() carried
    across by the bridge, buffer for buffer; fp32 leaves are shared, not
    changed; the fp32 bundle is untouched."""
    port, jx, qport, qjax = smoke["target"]
    cfg = port.cfg
    before = {k: v.clone() for k, v in port.model.state_dict().items()}
    bridged = from_jax_params(dataclasses.replace(cfg, quant="int8"),
                              jax.device_get(qjax.params), device="cpu")
    got, want = qport.model.state_dict(), bridged.state_dict()
    assert got.keys() == want.keys()
    for key in got:
        assert got[key].dtype == want[key].dtype, key
        assert torch.equal(got[key], want[key]), key
    n_quant = sum(isinstance(m, QuantWeight) for m in qport.model.modules())
    assert n_quant == len(QUANT_WEIGHTS) * cfg.num_layers
    assert qport.cfg.quant == "int8" and port.cfg.quant == ""
    assert qport.model.embed.table is port.model.embed.table
    for key, val in port.model.state_dict().items():
        assert torch.equal(val, before[key]), key
    assert not any(isinstance(m, QuantWeight) for m in port.model.modules())
    with pytest.raises(ValueError, match="already"):
        qport.quantize()


def test_bridge_refuses_mixed_precision(smoke):
    port, jx, _, qjax = smoke["draft"]
    with pytest.raises(ValueError, match="int8 leaf"):
        from_jax_params(port.cfg, jax.device_get(qjax.params), device="cpu")
    with pytest.raises(ValueError, match="fp32 leaf"):
        from_jax_params(dataclasses.replace(port.cfg, quant="int8"),
                        jax.device_get(jx.params), device="cpu")
    with pytest.raises(ValueError, match="not drawn"):
        tf.init_model(dataclasses.replace(port.cfg, quant="int8"),
                      device="cpu")


def test_int8_cache_layout_commit_and_remap(smoke):
    """int8 K/V with fp32 per-row scales; commit_tree_node copies int8
    rows and their scales as they are; remap_tree_caches moves the scale
    leaves with the K/V rows."""
    _, _, qport, qjax = smoke["draft"]
    cfg = qport.cfg
    cache = qport.init_cache(2, 16)
    want = qjax.init_cache(2, 16)["stack"][0]
    assert sorted(cache[0]) == sorted(want) == ["k", "k_scale", "v",
                                                "v_scale"]
    for name, buf in cache[0].items():
        assert buf.dtype == getattr(torch, str(want[name].dtype))
        assert tuple(buf.shape) == want[name].shape[1:]
    tree = qport.init_tree_caches(1, 9)
    rng = np.random.default_rng(0)
    for layer in tree:                      # fill the tree rows
        for name in ("k", "v"):
            layer[name].copy_(torch.tensor(rng.integers(
                -127, 128, layer[name].shape), dtype=torch.int8))
            layer[name + "_scale"].copy_(torch.tensor(
                rng.random(layer[name + "_scale"].shape), dtype=torch.float32))
    cache = qport.init_cache(1, 16)
    tf.commit_tree_node(cache, tree, 3, 5)
    for lc, lt in zip(cache, tree):
        for name in lc:
            assert torch.equal(lc[name][:, 5], lt[name][:, 3]), name
            assert not lc[name][:, 6].any()
    old = [{k: v.clone() for k, v in layer.items()} for layer in tree]
    index_map = torch.tensor([-1, 0, -1, 1, 2, -1], dtype=torch.int32)
    remap_tree_caches(tree, index_map, capacity=6)
    for lo, ln in zip(old, tree):
        for name in ln:                     # new row j holds old row g[j]
            for new_row, old_row in ((0, 1), (1, 3), (2, 4)):
                assert torch.equal(ln[name][:, new_row], lo[name][:, old_row])
    assert cfg.quant == "int8"


def _q8_steps_apart(port_cache, jax_cache):
    """Max difference, in int8 steps, of cached K/V between packages."""
    worst = 0
    for name in ("k", "v"):
        got = np.stack([c[name].numpy() for c in port_cache]).astype(int)
        want = np.asarray(jax_cache["stack"][0][name]).astype(int)
        worst = max(worst, int(np.abs(got - want).max()))
    return worst


def _close(got, want, atol=LOGIT_ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


@pytest.mark.parametrize("which", ["target", "draft"])
def test_int8_logits_match_jax(smoke, which):
    """Prefill, decode and tree-verify logits of the int8 bundle against
    the JAX package's int8 bundle."""
    _, _, qb, jb = smoke[which]
    cfg = qb.cfg
    rng = np.random.default_rng(1)
    b, s, max_len, n, tcap = 2, 7, 20, 4, 13
    tokens = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    jl, jc = jb.prefill(jnp.asarray(tokens), jb.init_cache(b, max_len))
    tl, tc = qb.prefill(tokens, qb.init_cache(b, max_len))
    _close(tl, jl)
    for step in range(2):
        tok = rng.integers(0, cfg.vocab_size, (b,)).astype(np.int32)
        jl, jc = jb.decode(jnp.asarray(tok), jc, s + step)
        tl, tc = qb.decode(tok, tc, s + step)
        _close(tl, jl)
    assert _q8_steps_apart(tc, jc) <= 1
    cache_len = np.array([s + 2, s], np.int32)
    jtc, ttc = jb.init_tree_caches(b, tcap), qb.init_tree_caches(b, tcap)
    for write_at in ([0, 0], [4, 1]):
        nt = rng.integers(0, cfg.vocab_size, (b, n)).astype(np.int32)
        pos = (cache_len[:, None] + rng.integers(0, 3, (b, n))).astype(
            np.int32)
        mask = rng.random((b, n, tcap)) < 0.5
        mask[:, :, 0] = True
        jl, jtc = jb.tree_verify(jnp.asarray(nt), jnp.asarray(pos),
                                 jnp.asarray(mask), jc,
                                 jnp.asarray(cache_len), jtc,
                                 jnp.asarray(write_at, np.int32))
        tl, ttc = qb.tree_verify(nt, pos, mask, tc, cache_len, ttc, write_at)
        _close(tl, jl)
    assert _q8_steps_apart(ttc, jtc) <= 1


def test_int8_prefill_attends_its_round_trip(smoke):
    """Prefill of an int8 model == prefill with the cache's dequantized
    K/V: a prompt row's logits equal the decode step that reads that row
    back from the int8 cache."""
    _, _, qb, _ = smoke["draft"]
    tokens = np.random.default_rng(2).integers(0, 512, (1, 6))
    full, _ = qb.prefill(tokens, qb.init_cache(1, 8))
    _, cache = qb.prefill(tokens[:, :5], qb.init_cache(1, 8))
    last, _ = qb.decode(tokens[:, 5], cache, 5)
    torch.testing.assert_close(full, last, rtol=0, atol=1e-5)


def test_int8_pipedec_matches_jax_and_autoregressive(smoke):
    """Greedy int8 PipeDec: the same tokens and stats as the JAX package's
    int8 engine, and the same tokens as the port's own int8
    autoregressive decoding; with a real draft and with self-draft."""
    qt, jqt = smoke["target"][2:]
    qd, jqd = smoke["draft"][2:]
    prompt = np.random.default_rng(0).integers(0, 512, 8)
    ar = generate_autoregressive(qt, prompt, 12)
    for (t, d), (jt, jd) in (((qt, qd), (jqt, jqd)),
                             ((qt, qt), (jqt, jqt))):
        out, st = PipeDecEngine(t, d, PipeDecConfig(3, 4, 2)).generate(
            prompt, 12)
        jout, jst = JaxPipeDecEngine(jt, jd, JaxPipeDecConfig(3, 4, 2)
                                     ).generate(prompt, 12)
        np.testing.assert_array_equal(out, jout)
        np.testing.assert_array_equal(out, ar)
        assert {k: getattr(st, k) for k in STATS} == \
            {k: getattr(jst, k) for k in STATS}
    assert st.hits == 12 and st.misses == 0      # the self-draft run


@pytest.mark.parametrize("mode", ["pp", "pipedec"])
def test_cli_int8_on_cpu(mode, capsys):
    engine, results = serve.main(["--mode", mode, "--device", "cpu",
                                  "--quant", "int8", "--requests", "2",
                                  "--new-tokens", "4", "--stages", "2"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(results) == 2 and len(lines) == 2
    bundles = [engine.target] + ([engine.draft] if mode == "pipedec" else [])
    assert all(b.cfg.quant == "int8" for b in bundles)
    assert quant.is_quantized(engine.target.model.layers[0].ffn.w_up)
    rng = np.random.default_rng(0)          # the CLI's prompts, in order
    for uid in range(2):
        prompt = rng.integers(0, engine.target.cfg.vocab_size, size=8)
        np.testing.assert_array_equal(
            results[uid].tokens,
            generate_autoregressive(engine.target, prompt, 4))
