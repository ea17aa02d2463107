"""The modality families served by the port's engines against the JAX
package's, at smoke size on bridged weights: InternVL2 with a vision
prefix and Whisper with an encoder output, each bundle carrying its
modality input as the reference's ``ModelBundle`` does (the numpy prefix
and frames of ``test_torch_modality.modal_inputs``; each package encodes
the frames with its own encoder).  The draft is the JAX family test's
one-layer dense model, which sees no prefix and no encoder output; the
committed length counts the target's prefix for both models, the
reference's rule.

Held here: autoregressive, PipeDec ``(3, 4, 2)`` and STPP tokens and
stats against the JAX engines (and PipeDec against autoregressive
decoding); self-draft PipeDec hits every prediction; SpecPipe-DB tokens,
stats, occupancy and the executor's call counts against the JAX
``SpecPipeDBEngine`` (2 slots, 3 requests, arrivals 0, 0, 3), dense and
paged; the ring executors built for the modality bundles (the
overlapped ring with its prefill lane off); one train step of each
family, with its prefix or frames, and the trainer's refusal of its int8
form; the serving CLI with the two ids, text-only.
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
from repro.core.pipedec import PipeDecConfig as JaxPipeDecConfig
from repro.core.pipedec import PipeDecEngine as JaxPipeDecEngine
from repro.core.speculative import ModelBundle as JaxBundle
from repro.models import encdec as jenc
from repro.models import transformer as jtf
from repro.models.config import ModelConfig as JaxModelConfig
from repro.serving import LocalFusedExecutor as JaxLocalFusedExecutor
from repro.serving import Request as JaxRequest
from repro.serving import SpecPipeDBEngine as JaxSpecPipeDBEngine
from repro_torch import configs as reg
from repro_torch.checkpoint import from_jax_params
from repro_torch.core.baselines import (STPPConfig, STPPEngine,
                                        generate_autoregressive)
from repro_torch.core.pipedec import PipeDecConfig, PipeDecEngine
from repro_torch.core.speculative import ModelBundle
from repro_torch.launch import pipeline, serve, steps, train
from repro_torch.models import encdec
from repro_torch.models import transformer as tf
from repro_torch.models.layers import trainable
from repro_torch.optim import adamw_init
from repro_torch.serving import (AsyncPipelineExecutor, LocalFusedExecutor,
                                 OverlappedShardedExecutor, Request,
                                 ShardedPipelineExecutor, SpecPipeDBEngine)
from test_torch_families import family_params, port_cfg
from test_torch_modality import modal_inputs
from test_torch_moe import draft_for

ARCHS = ("whisper-base", "internvl2-26b")
GEN = ("timesteps", "commits", "hits", "misses", "entries",
       "commits_per_step")
STPP = ("rounds", "commits", "draft_steps", "accepted_per_round")
MAX_LEN = 64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """{"target", "draft"}: (port bundle, JAX bundle) on the same weights;
    the target carries its prefix or encoder output."""
    jcfg = jreg.get_config(request.param, smoke=True)
    params = family_params(jcfg, seed=0)
    cfg = port_cfg(jcfg)
    model = from_jax_params(cfg, params, device="cpu")
    x = modal_inputs(cfg, seed=1)
    jp = jax.tree.map(jnp.asarray, params)
    if cfg.is_encdec:
        jkw = {"enc_out": jenc.encode(jp["encoder"], jcfg, jnp.asarray(x))}
        kw = {"enc_out": encdec.encode(model.encoder, cfg, x)}
    else:
        jkw, kw = {"prefix_embeds": jnp.asarray(x)}, {"prefix_embeds": x}
    dcfg = draft_for(cfg.vocab_size)
    jdcfg = JaxModelConfig(**dataclasses.asdict(dcfg))
    dparams = jax.device_get(jtf.init_model(jax.random.PRNGKey(5), jdcfg))
    return {"target": (ModelBundle(model, **kw), JaxBundle(jp, jcfg, **jkw)),
            "draft": (ModelBundle(from_jax_params(dcfg, dparams,
                                                  device="cpu")),
                      JaxBundle(jax.tree.map(jnp.asarray, dparams), jdcfg))}


def _stats(st, keys):
    return {k: getattr(st, k) for k in keys}


def test_autoregressive_pipedec_stpp_match_jax(pair):
    (t, jt), (d, jd) = pair["target"], pair["draft"]
    prompt = np.array([7, 3, 11, 2], np.int64)
    jprompt = prompt.astype(np.int32)
    ar = generate_autoregressive(t, prompt, 10, max_len=MAX_LEN)
    np.testing.assert_array_equal(
        ar, jax_generate_autoregressive(jt, jprompt, 10, max_len=MAX_LEN))
    out, st = PipeDecEngine(t, d, PipeDecConfig(3, 4, 2),
                            max_len=MAX_LEN).generate(prompt, 10)
    jout, jst = JaxPipeDecEngine(jt, jd, JaxPipeDecConfig(3, 4, 2),
                                 max_len=MAX_LEN).generate(jprompt, 10)
    np.testing.assert_array_equal(out, jout)
    np.testing.assert_array_equal(out, ar)
    assert _stats(st, GEN) == _stats(jst, GEN)
    sout, sst = STPPEngine(t, d, STPPConfig(3, 4, 2),
                           max_len=MAX_LEN).generate(prompt, 10)
    jsout, jsst = JaxSTPPEngine(jt, jd, JaxSTPPConfig(3, 4, 2),
                                max_len=MAX_LEN).generate(jprompt, 10)
    np.testing.assert_array_equal(sout, jsout)
    np.testing.assert_array_equal(sout, ar)
    assert _stats(sst, STPP) == _stats(jsst, STPP)


def test_self_draft_hits_every_prediction(pair):
    """The target as its own draft (prefix and encoder output included):
    every prediction hits, and the tokens are autoregressive decoding's."""
    t, _ = pair["target"]
    prompt = np.array([4, 9, 1], np.int64)
    out, st = PipeDecEngine(t, t, PipeDecConfig(3, 4, 2),
                            max_len=MAX_LEN).generate(prompt, 12)
    np.testing.assert_array_equal(
        out, generate_autoregressive(t, prompt, 12, max_len=MAX_LEN))
    assert st.misses == 0 and st.hits > 0


def _requests():
    rng = np.random.default_rng(3)
    return [(i, rng.integers(0, 100, size=int(rng.integers(3, 9))), n, t)
            for i, (n, t) in enumerate(((5, 0), (4, 0), (6, 3)))]


@pytest.mark.parametrize("paged", [False, True])
def test_db_matches_jax_engine(pair, paged):
    """3 requests on 2 slots, arrivals 0, 0, 3: one prefix or encoder
    output serves both slots and the fused verify's bucket rows.  Tokens,
    per-request GenStats, occupancy and the executor's counts equal the
    JAX engine's; the page counters too without a prefix (the port's
    paged horizon counts the prefix rows, the reference's does not)."""
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
    assert eng.stats.occupancy == jeng.stats.occupancy
    for key in ("verify_rows", "commit_rows", "remap_rows"):
        assert ex.calls[key] == jex.calls[key], key
    if paged and t.prefix_embeds is None:
        assert eng.stats.page_counters == jeng.stats.page_counters


def test_paged_horizon_covers_a_long_prefix():
    """A 64-row vision prefix before 6-token prompts with budgets of 12:
    each request writes 82 model rows or more (prefix, prompt, its tokens
    and a final tree's commits).  The reference's paged horizon leaves the
    prefix out (``min(max_len, prompt + budget + tree capacity)``), so it
    backs fewer blocks than the request writes and the rows past them land
    in the shared null block; the port's counts the prefix, and its paged
    arena gives the dense arena's tokens and autoregressive decoding's."""
    jcfg = jreg.get_config("internvl2-26b", smoke=True)
    params = family_params(jcfg, seed=0)
    cfg = port_cfg(jcfg)
    prefix = (0.02 * np.random.default_rng(4).normal(
        size=(1, 64, cfg.d_model))).astype(np.float32)
    t = ModelBundle(from_jax_params(cfg, params, device="cpu"),
                    prefix_embeds=prefix)
    jt = JaxBundle(jax.tree.map(jnp.asarray, params), jcfg,
                   prefix_embeds=jnp.asarray(prefix))
    dcfg = draft_for(cfg.vocab_size)
    dparams = jax.device_get(jtf.init_model(
        jax.random.PRNGKey(5), JaxModelConfig(**dataclasses.asdict(dcfg))))
    d = ModelBundle(from_jax_params(dcfg, dparams, device="cpu"))
    pcfg, max_len, page = PipeDecConfig(3, 4, 2), 128, 16
    rng = np.random.default_rng(6)
    reqs = [(i, rng.integers(0, 100, size=6), 12, at)
            for i, at in enumerate((0, 1))]
    written = 64 + 6 + 12
    jex = JaxLocalFusedExecutor(jt, jt, slots=2, max_len=max_len,
                                tree_capacity=pcfg.tree_buffer_capacity,
                                capacity=pcfg.capacity, paged=True,
                                page=page)
    jreq = JaxRequest(0, reqs[0][1].astype(np.int32), 12)
    assert -(-jex.arena._horizon(jreq) // page) < -(-written // page)
    out = {}
    for paged in (False, True):
        ex = LocalFusedExecutor(t, d, slots=2, max_len=max_len,
                                tree_capacity=pcfg.tree_buffer_capacity,
                                capacity=pcfg.capacity, paged=paged,
                                page=page)
        if paged:
            assert ex.arena._horizon(Request(*reqs[0][:3])) >= written
        eng = SpecPipeDBEngine(t, d, pcfg, max_len=max_len, max_slots=2,
                               executor=ex)
        for uid, prompt, n, at in reqs:
            eng.submit(Request(uid, prompt, n, arrival_t=at))
        res = eng.run()
        out[paged] = [res[uid].tokens for uid, *_ in reqs]
    for (_, prompt, n, _), dense, paged in zip(reqs, out[False], out[True]):
        np.testing.assert_array_equal(paged, dense)
        np.testing.assert_array_equal(
            dense, generate_autoregressive(t, prompt, n, max_len=max_len))


def test_ring_refuses_modality_bundles(pair):
    """The ring's config check accepts both configs, and the sharded,
    overlapped and async executors build for bundles carrying a prefix or
    an encoder output: the overlapped ring with its prefill lane off
    (``prefill_cap`` 0, ``begin_prefill`` None: admission prefills apart,
    baking the prefix or cross K/V in, as the reference's does), the same
    executor over the text-only bundle with its 64-token lane."""
    (t, _), (d, _) = pair["target"], pair["draft"]
    kw = dict(slots=2, max_len=MAX_LEN, tree_capacity=12, capacity=8,
              n_stages=2)
    pipeline.check_ring_supported(t.cfg)
    for cls in (ShardedPipelineExecutor, OverlappedShardedExecutor,
                AsyncPipelineExecutor):
        ex = cls(t, d, **kw)
        assert ex.n_stages == 2
        if cls is AsyncPipelineExecutor:
            assert ex.prefill_cap == 0
            ex.shutdown()
        elif cls is OverlappedShardedExecutor:
            assert ex.prefill_cap == 0
            assert ex.begin_prefill(0, np.array([1, 2, 3])) is None
            assert ex.calls["prefill_in_ring"] == 0
    text_only = OverlappedShardedExecutor(ModelBundle(t.model), d, **kw)
    assert text_only.prefill_cap == min(64, MAX_LEN)


@pytest.mark.parametrize("arch", ARCHS)
def test_trainer_refuses_modality_configs(arch):
    """The trainer takes the modality configs: one CPU step of
    ``make_train_step`` on a batch with the family's prefix or frames
    moves every weight, and ``launch.train`` trains one step on tokens
    alone; only InternVL2's int8 form is refused (``layers.trainable``;
    Whisper has none)."""
    cfg = reg.get_config(arch, smoke=True)
    model = tf.init_model(cfg, seed=0, device="cpu")
    before = [p.clone() for p in model.parameters()]
    opt = adamw_init(trainable(model))
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 8)),
             "labels": rng.integers(0, cfg.vocab_size, (2, 8))}
    n = (cfg.encoder.max_source_positions if cfg.is_encdec
         else cfg.prefix_tokens)
    batch["frames" if cfg.is_encdec else "prefix_embeds"] = (
        0.02 * rng.normal(size=(2, n, cfg.d_model))).astype(np.float32)
    opt, metrics = steps.make_train_step(cfg)(model, opt, batch)
    assert np.isfinite(float(metrics["loss"]))
    assert all(not torch.equal(a, b)
               for a, b in zip(before, model.parameters()))
    _, losses = train.train(cfg, steps=1, batch=1, seq=8, device="cpu",
                            log_every=0)
    assert len(losses) == 1 and np.isfinite(losses[0])
    bundle = ModelBundle(tf.init_model(cfg, seed=0, device="cpu"))
    if cfg.is_encdec:        # Whisper has no int8 form to train
        with pytest.raises(NotImplementedError, match="int8"):
            bundle.quantize()
    else:
        with pytest.raises(ValueError, match="int8"):
            trainable(bundle.quantize().model)


@pytest.mark.parametrize("arch,mode", [("whisper-base", "pipedec-db"),
                                       ("internvl2-26b", "pipedec")])
def test_cli_serves_modality_ids_text_only(arch, mode, capsys):
    """``--target-arch`` takes the two ids and serves them with no prefix
    and no encoder output; tokens equal autoregressive decoding."""
    engine, results = serve.main(["--mode", mode, "--device", "cpu",
                                  "--target-arch", arch, "--requests", "2",
                                  "--new-tokens", "4", "--slots", "2"])
    assert engine.target.cfg == reg.get_config(arch, smoke=True)
    assert engine.target.prefix_embeds is None
    assert engine.target.enc_out is None
    capsys.readouterr()
    rng = np.random.default_rng(0)
    for uid in range(2):
        prompt = rng.integers(0, engine.target.cfg.vocab_size, size=8)
        np.testing.assert_array_equal(
            results[uid].tokens,
            generate_autoregressive(engine.target, prompt, 4))
