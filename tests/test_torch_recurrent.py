"""The recurrent families in the port against the JAX package on bridged
weights: Mamba-2 and RecurrentGemma at their smoke sizes, and the
attention+SSD hybrid (pattern "sa") of the reference's recycled-slot test.

The JAX parameter pytree comes from the JAX package's ``init_model`` (its
layout: ``reps`` stacked units of the sub-layer kinds, then a ``tail``),
with numpy noise on the leaves it draws as constants (norm scales, conv
and dt biases, A_log, D); inputs are drawn with numpy from a seed.  Both
packages then run the training forward, prefill and decode (prompts past
RecurrentGemma's 16-token smoke window, so the local layers' window
masks keys), chain-mode speculation and pp serving on the same inputs.
Tolerance: logits within 1e-4, tokens and every ``GenStats`` field equal.
Also here: the per-layer order against the reference's ``layout``, the
bridge both ways, a recycled arena slot equal to a fresh one (dense and
paged), and the refusals: the tree paths (PipeDec, STPP, SpecPipe-DB,
chunked prefill) name chain-mode, int8 and the ring refuse; the trainer
takes one step.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jreg
from repro.core.chain import ChainConfig as JaxChainConfig
from repro.core.chain import ChainSpecEngine as JaxChainSpecEngine
from repro.core.speculative import ModelBundle as JaxBundle
from repro.models import transformer as jtf
from repro.models.config import ModelConfig as JaxModelConfig
from repro.serving.engine import ServingEngine as JaxServingEngine
from repro_torch.checkpoint import from_jax_params, to_jax_params
from repro_torch.checkpoint.bridge import load_jax_params
from repro_torch.core.baselines import (STPPConfig, STPPEngine,
                                        generate_autoregressive)
from repro_torch.core.chain import ChainConfig, ChainSpecEngine
from repro_torch.core.pipedec import PipeDecConfig, PipeDecEngine
from repro_torch.core.speculative import ModelBundle
from repro_torch.launch import pipeline, serve, steps
from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import trainable
from repro_torch.optim import adamw_init
from repro_torch.serving import Request, ServingEngine
from repro_torch.serving.dynbatch import SpecPipeDBEngine
from repro_torch.serving.scheduler import KVArena, PagedKVArena

LOGIT_ATOL = 1e-4
ARCHS = ("mamba2-130m", "recurrentgemma-9b", "hybrid-ssm")
STATS = ("timesteps", "commits", "hits", "misses", "entries",
         "commits_per_step")
MAX_LEN = 96
CHAIN = "chain-mode"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_cfg(jcfg) -> ModelConfig:
    return ModelConfig(**{f.name: getattr(jcfg, f.name)
                          for f in dataclasses.fields(jcfg)})


def jax_cfg(arch: str):
    """A JAX config: a smoke config of the registry, or (``hybrid-ssm``)
    the reference's attention+SSD hybrid of its recycled-slot test."""
    if arch == "hybrid-ssm":
        from repro.models.config import RGLRUConfig, SSMConfig
        return JaxModelConfig(
            name="t-hyb-ssm", family="hybrid", num_layers=2, d_model=64,
            num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=128,
            ssm=SSMConfig(d_state=16, head_dim=16, chunk=8),
            rglru=RGLRUConfig(pattern="sa", window=0))
    return jreg.get_config(arch, smoke=True)


def noisy_params(jcfg, seed: int):
    """The JAX package's pytree as numpy, with N(0, 0.1) noise on the
    leaves it draws as constants."""
    params = jax.device_get(jtf.init_model(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)
    names = ("scale", "conv_b", "dt_bias", "A_log", "D")

    def f(path, x):
        x = np.asarray(x)
        if getattr(path[-1], "key", None) in names:
            return (x + 0.1 * rng.normal(size=x.shape)).astype(np.float32)
        return x
    return jax.tree_util.tree_map_with_path(f, params)


def _draft_cfg(vocab: int) -> ModelConfig:
    """The reference family tests' dense 1-layer draft."""
    return ModelConfig(name="fam-draft", family="dense", num_layers=1,
                       d_model=64, num_heads=2, num_kv_heads=1, d_ff=128,
                       vocab_size=vocab)


def _pair(cfg, params, jcfg=None):
    """(port bundle, JAX bundle) on the same numpy weights."""
    jcfg = jcfg or JaxModelConfig(**dataclasses.asdict(cfg))
    return (ModelBundle(from_jax_params(cfg, params, device="cpu")),
            JaxBundle(jax.tree.map(jnp.asarray, params), jcfg))


@pytest.fixture(scope="module", params=ARCHS)
def family(request):
    """{"cfg", "params", "target": (port, jax), "draft": (port, jax)}."""
    jcfg = jax_cfg(request.param)
    cfg = port_cfg(jcfg)
    params = noisy_params(jcfg, 3)
    dcfg = _draft_cfg(cfg.vocab_size)
    dparams = jax.device_get(jtf.init_model(jax.random.PRNGKey(5),
                                            JaxModelConfig(**dataclasses
                                                           .asdict(dcfg))))
    return {"cfg": cfg, "jcfg": jcfg, "params": params,
            "target": _pair(cfg, params, jcfg), "draft": _pair(dcfg, dparams)}


def _prompt(cfg, n: int = 24, seed: int = 0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, n)


def _close(got, want, atol=LOGIT_ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


def _stats(st):
    return {k: getattr(st, k) for k in STATS}


def jax_layers(jcfg, cache) -> list:
    """A JAX cache (``prefix``, stacked ``stack`` or per-unit ``units``,
    ``tail``) as one entry per layer, the port's order."""
    n_prefix, reps, tail = jtf.layout(jcfg)
    u = len(jtf.unit_kinds(jcfg))
    out = [cache["prefix"][i][0] for i in range(n_prefix)]
    if "units" in cache:
        out += [cache["units"][r][k] for r in range(reps) for k in range(u)]
    elif reps:
        out += [jax.tree.map(lambda x, r=r: x[r], cache["stack"][k])
                for r in range(reps) for k in range(u)]
    return out + list(cache.get("tail", []))[:len(tail)]


@pytest.mark.parametrize("arch", ARCHS + ("tiny-hybrid",))
def test_layer_order_matches_reference_layout(arch):
    """The port's per-layer kinds equal the reference's prefix, ``reps``
    units of ``unit_kinds`` and ``tail``, at smoke and published sizes;
    RecurrentGemma is 12 "rra" units and an "rr" tail; a ``local`` layer
    takes the rglru window, every other kind ``sliding_window``."""
    if arch == "tiny-hybrid":
        from repro.models.config import RGLRUConfig
        cfgs = [JaxModelConfig(name="t-hyb", family="hybrid", num_layers=5,
                               d_model=64, num_heads=4, num_kv_heads=1,
                               d_ff=128, vocab_size=128,
                               rglru=RGLRUConfig(lru_width=64, window=8,
                                                 pattern="rra"))]
    elif arch == "hybrid-ssm":
        cfgs = [jax_cfg(arch)]
    else:
        cfgs = [jreg.get_config(arch), jreg.get_config(arch, smoke=True)]
    for jcfg in cfgs:
        n_prefix, reps, tail = jtf.layout(jcfg)
        want = ["attn"] * n_prefix + list(jtf.unit_kinds(jcfg)) * reps \
            + list(tail)
        cfg = port_cfg(jcfg)
        assert tf.layer_kinds(cfg) == want, jcfg.name
        ctx = jtf.Ctx(mode="decode", positions=None)
        assert tf.layer_windows(cfg) == [jtf._window(jcfg, k, ctx)
                                         for k in want]
    full = port_cfg(jreg.get_config("recurrentgemma-9b"))
    assert tf.layer_kinds(full) == ["rglru", "rglru", "local"] * 12 + [
        "rglru", "rglru"]
    assert set(tf.layer_windows(full)) == {0, 2048}


def test_bridge_round_trip(family):
    """JAX pytree -> port -> JAX bit for bit (``stack`` per unit kind and
    the ``tail``), every mixer leaf mapped; a pytree with its tail
    dropped is refused."""
    params = family["params"]
    back = to_jax_params(family["target"][0].model)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(params)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, b)
    if "tail" in params:
        broken = {k: v for k, v in params.items() if k != "tail"}
        with pytest.raises(ValueError, match="tail"):
            load_jax_params(tf.Transformer(family["cfg"], "cpu"), broken)


def test_forward_prefill_decode_logits_match_jax(family):
    """Training-forward logits, prefill logits and state, and decode
    logits continuing it, within 1e-4 of JAX; prompts of 24 > the smoke
    window 16."""
    cfg, jcfg = family["cfg"], family["jcfg"]
    (t, jt) = family["target"]
    rng = np.random.default_rng(1)
    b, s = 2, 24
    tokens = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    jlog = jtf.forward(jt.params, jcfg, jnp.asarray(tokens))
    jlog = jlog[0] if isinstance(jlog, tuple) else jlog
    _close(tf.forward(t.model, tokens), jlog)
    jl, jc = jt.prefill(jnp.asarray(tokens), jt.init_cache(b, MAX_LEN))
    tl, tc = t.prefill(tokens, t.init_cache(b, MAX_LEN))
    _close(tl, jl)
    for step in range(4):
        tok = rng.integers(0, cfg.vocab_size, (b,)).astype(np.int32)
        jl, jc = jt.decode(jnp.asarray(tok), jc, s + step)
        tl, tc = t.decode(tok, tc, s + step)
        _close(tl, jl)
    # every recurrent layer's state after the steps, against JAX's
    jlayers = jax_layers(jcfg, jc)
    n_rec = 0
    for i, kind in enumerate(tf.layer_kinds(cfg)):
        if kind in tf.RECURRENT_KINDS:
            assert set(tc[i]) == set(jlayers[i])
            for k in tc[i]:
                _close(tc[i][k], jlayers[i][k])
            n_rec += 1
    assert n_rec


@pytest.mark.parametrize("stages", [1, 3, 8])
def test_chain_matches_jax_engine(family, stages):
    """Chain tokens and every GenStats field against the JAX engine on
    the same pair, and the tokens of autoregressive decoding."""
    (t, jt), (d, jd) = family["target"], family["draft"]
    prompt = _prompt(family["cfg"])
    eng = ChainSpecEngine(t, d, ChainConfig(n_stages=stages),
                          max_len=MAX_LEN)
    out, st = eng.generate(prompt, 12)
    jout, jst = JaxChainSpecEngine(jt, jd, JaxChainConfig(n_stages=stages),
                                   max_len=MAX_LEN).generate(
        prompt.astype(np.int32), 12)
    np.testing.assert_array_equal(out, jout)
    np.testing.assert_array_equal(
        out, generate_autoregressive(t, prompt, 12, max_len=MAX_LEN))
    assert _stats(st) == _stats(jst)
    # one copy of every recurrent leaf per chain position, target only
    # (the dense draft makes none): the initial copy, one per entry and
    # one per restore
    n_leaves = sum(len(c) for kind, c in zip(
        tf.layer_kinds(t.cfg), t.init_cache(1, 1))
        if kind in tf.RECURRENT_KINDS)
    assert eng.snapshot_copies == n_leaves * (1 + st.entries + st.misses)


def test_chain_self_draft(family):
    """The target as its own draft (the reference's pin): acceptance 1.0,
    no miss, more than 0.7 tokens a timestep at 4 stages over 16 tokens,
    the JAX engine's stats."""
    t, jt = family["target"]
    prompt = np.array([5, 5, 2])
    out, st = ChainSpecEngine(t, t, ChainConfig(n_stages=4),
                              max_len=MAX_LEN).generate(prompt, 16)
    jout, jst = JaxChainSpecEngine(jt, jt, JaxChainConfig(n_stages=4),
                                   max_len=MAX_LEN).generate(
        prompt.astype(np.int32), 16)
    np.testing.assert_array_equal(out, jout)
    assert _stats(st) == _stats(jst)
    assert st.acceptance == 1.0 and st.misses == 0
    assert st.tokens_per_timestep > 0.7


def test_pp_matches_jax_serving_engine(family):
    """pp mode, two batches of two 24-token requests and one of 30, with
    per-request budgets: the JAX ServingEngine's tokens."""
    (t, jt) = family["target"]
    cfg = family["cfg"]
    reqs = [(0, _prompt(cfg, 24, 1), 6), (1, _prompt(cfg, 24, 2), 4),
            (2, _prompt(cfg, 30, 3), 5), (3, _prompt(cfg, 24, 4), 3)]
    port = ServingEngine(t, mode="pp", max_batch=2, max_len=MAX_LEN)
    ref = JaxServingEngine(jt, mode="pp", max_batch=2, max_len=MAX_LEN)
    from repro.serving.engine import Request as JaxRequest
    for uid, p, n in reqs:
        port.submit(Request(uid, p, n))
        ref.submit(JaxRequest(uid, p.astype(np.int32), n))
    got, want = port.run(), ref.run()
    for uid, _, _ in reqs:
        np.testing.assert_array_equal(got[uid].tokens,
                                      np.asarray(want[uid].tokens))


@pytest.mark.parametrize("paged", [False, True])
def test_recycled_slot_equals_fresh(family, paged):
    """A slot recycled from an earlier request prefills what a fresh
    cache prefills: equal logits and equal recurrent state (the prefill
    starts from zero, not the old occupant's state), dense and paged."""
    (t, _), (d, _) = family["target"], family["draft"]
    eng = PipeDecEngine(t, d, PipeDecConfig(n_stages=3, width=4, branch=2),
                        max_len=MAX_LEN)
    arena = (PagedKVArena if paged else KVArena)(
        t, d, slots=1, max_len=MAX_LEN,
        tree_capacity=eng.tree_buffer_capacity)
    p_a, p_b = _prompt(t.cfg, 20, 5), _prompt(t.cfg, 7, 6)

    def occupy(prompt):
        slot = arena.alloc()
        if paged:
            arena.bind(slot, Request(0, prompt, 4))
        return slot
    slot = occupy(p_a)
    st_a = eng.init_state(p_a, 4, caches=arena.caches(slot))
    arena.store(slot, st_a.caches())
    arena.free(slot)
    slot2 = occupy(p_b)
    assert slot2 == slot
    st_b = eng.init_state(p_b, 4, caches=arena.caches(slot2))
    ref = eng.init_state(p_b, 4)
    assert st_b.committed == ref.committed
    rec_cache = arena.caches(slot2)[0]
    fresh = t.init_cache(1, MAX_LEN)
    lg_rec, rec_cache = t.prefill(p_b[None], rec_cache)
    lg_fresh, fresh = t.prefill(p_b[None], fresh)
    assert torch.equal(lg_rec, lg_fresh)
    for kind, a, b in zip(tf.layer_kinds(t.cfg), rec_cache, fresh):
        if kind in tf.RECURRENT_KINDS:
            for k in a:
                assert torch.equal(a[k], b[k]), (kind, k)
    assert arena.stacked[2].count(None) == sum(
        k in tf.RECURRENT_KINDS for k in tf.layer_kinds(t.cfg))


def test_tree_paths_refuse_naming_chain_mode(family):
    """PipeDec and STPP raise at their first tree verify (PipeDec's
    ``init_state`` still prefills), ServingEngine's tree modes and
    SpecPipe-DB up front, and chunked prefill, all naming chain-mode."""
    (t, _), (d, _) = family["target"], family["draft"]
    prompt = _prompt(t.cfg, 10)
    eng = PipeDecEngine(t, d, PipeDecConfig(n_stages=3, width=4, branch=2),
                        max_len=MAX_LEN)
    st = eng.init_state(prompt, 4)
    assert len(st.committed) == 1
    with pytest.raises(NotImplementedError, match=CHAIN):
        eng.generate(prompt, 4)
    with pytest.raises(NotImplementedError, match=CHAIN):
        STPPEngine(t, d, STPPConfig(depth=2, width=4, branch=2),
                   max_len=MAX_LEN).generate(prompt, 4)
    for mode in ("pipedec", "pipedec-db"):
        with pytest.raises(NotImplementedError, match=CHAIN):
            ServingEngine(t, d, mode=mode, max_len=MAX_LEN)
    with pytest.raises(NotImplementedError, match=CHAIN):
        SpecPipeDBEngine(t, d, PipeDecConfig(n_stages=3, width=4, branch=2),
                         max_len=MAX_LEN, max_slots=2)
    with pytest.raises(NotImplementedError, match=CHAIN):
        t.prefill_chunk(prompt[None, :4], t.init_cache(1, MAX_LEN), 0)


def test_int8_ring_and_trainer_refuse(family):
    """quantize() refuses through check_supported's int8 branch; the ring
    names the reference's reason (pipeline stages support attention
    stacks) and chain-mode.  The trainer no longer refuses: one CPU step
    of ``make_train_step`` moves every weight with a finite loss."""
    t, _ = family["target"]
    cfg = family["cfg"]
    with pytest.raises(NotImplementedError, match="dense attention"):
        t.quantize()
    with pytest.raises(NotImplementedError, match="dense attention"):
        tf.check_supported(dataclasses.replace(cfg, quant="int8"))
    with pytest.raises(NotImplementedError,
                       match=f"attention stacks.*{CHAIN}"):
        pipeline.check_ring_supported(cfg)
    model = from_jax_params(cfg, family["params"], device="cpu")
    before = [p.clone() for p in model.parameters()]
    opt = adamw_init(trainable(model))
    tokens = _prompt(cfg, 12)[None].repeat(2, 0)
    opt, metrics = steps.make_train_step(cfg)(
        model, opt, {"tokens": tokens, "labels": np.roll(tokens, -1, 1)})
    assert np.isfinite(float(metrics["loss"]))
    assert all(not torch.equal(a, b)
               for a, b in zip(before, model.parameters()))


@pytest.mark.parametrize("arch", ["mamba2-130m", "recurrentgemma-9b"])
def test_cli_serves_pp_and_refuses_pipedec(arch):
    """``--mode pp`` serves the family on the CPU, each request's tokens
    those of autoregressive decoding; ``--mode pipedec`` stops on the
    chain-mode refusal."""
    engine, results = serve.main(["--target-arch", arch, "--mode", "pp",
                                  "--device", "cpu", "--requests", "2",
                                  "--new-tokens", "5"])
    rng = np.random.default_rng(0)
    for uid in range(2):
        prompt = rng.integers(0, engine.target.cfg.vocab_size, size=8)
        np.testing.assert_array_equal(
            results[uid].tokens,
            generate_autoregressive(engine.target, prompt, 5))
    with pytest.raises(NotImplementedError, match=CHAIN):
        serve.main(["--target-arch", arch, "--mode", "pipedec",
                    "--device", "cpu", "--requests", "1"])
