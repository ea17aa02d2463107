"""The port's serving front door and CLI on the CPU: ``pp``, ``pipedec``
and ``pipedec-db`` modes against plain autoregressive decoding and
against the JAX package's ``ServingEngine`` on the same weights, eos
truncation and pp sampling included."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.pipedec import PipeDecConfig as JaxPipeDecConfig
from repro.core.speculative import ModelBundle as JaxBundle
from repro.models.config import ModelConfig as JaxModelConfig
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxServingEngine
from repro_torch.checkpoint import from_jax_params
from repro_torch.configs import pipedec_pair
from repro_torch.core.baselines import generate_autoregressive
from repro_torch.core.pipedec import PipeDecConfig, PipeDecEngine
from repro_torch.core.speculative import ModelBundle, SamplingParams
from repro_torch.launch import serve
from repro_torch.serving import Request, ServingEngine


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    return (serve.build_bundle("pipedec-target", seed=0, device="cpu"),
            serve.build_bundle("pipedec-draft", seed=1, device="cpu"))


def _requests(lengths, new_tokens, seed=0):
    rng = np.random.default_rng(seed)
    return [Request(uid, rng.integers(0, 512, n), new_tokens[uid])
            for uid, n in enumerate(lengths)]


@pytest.mark.parametrize("mode", ["pp", "pipedec"])
def test_modes_match_autoregressive(pair, mode):
    """Mixed prompt lengths (pp buckets them) and token budgets: every
    request's tokens equal its own autoregressive decode."""
    target, draft = pair
    reqs = _requests([5, 8, 5, 3], [6, 4, 9, 5])
    eng = ServingEngine(target, draft, mode=mode, max_batch=2,
                        pipedec=PipeDecConfig(n_stages=3, width=4, branch=2))
    for r in reqs:
        eng.submit(r)
    results = eng.run()
    assert sorted(results) == [0, 1, 2, 3] and not eng.queue
    for r in reqs:
        want = generate_autoregressive(target, r.prompt, r.max_new_tokens)
        np.testing.assert_array_equal(results[r.uid].tokens, want)
        assert results[r.uid].latency_s > 0
        if mode == "pipedec":
            assert results[r.uid].stats.commits >= r.max_new_tokens


def test_pp_matches_jax_serving_engine():
    """Batched pp decode with the same weights in both packages."""
    from test_torch_model import numpy_params
    cfg = pipedec_pair.DRAFT_SMOKE
    params = numpy_params(cfg, 2)
    jcfg = JaxModelConfig(**{f.name: getattr(cfg, f.name)
                             for f in dataclasses.fields(cfg)})
    port = ServingEngine(ModelBundle(from_jax_params(cfg, params,
                                                     device="cpu")),
                         mode="pp", max_batch=3)
    ref = JaxServingEngine(JaxBundle(jax.tree.map(jnp.asarray, params), jcfg),
                           mode="pp", max_batch=3)
    for r in _requests([6, 6, 4], [5, 7, 3], seed=3):
        port.submit(r)
        ref.submit(JaxRequest(r.uid, r.prompt.astype(np.int32),
                              r.max_new_tokens))
    got, want = port.run(), ref.run()
    for uid in want:
        np.testing.assert_array_equal(got[uid].tokens, want[uid].tokens)


def test_pipedec_db_is_not_ported(pair, capsys):
    """What SpecPipe-DB does not serve is refused with a message: the
    async executor has no paged arena, and the ring executors need
    ``--mode pipedec-db``; the speculative modes need a draft."""
    for flags, why in ((["--mode", "pipedec-db", "--executor", "async",
                         "--paged"], "no paged arena"),
                       (["--mode", "pipedec", "--executor", "async"],
                        "needs --mode pipedec-db")):
        with pytest.raises(SystemExit):
            serve.main(["--device", "cpu", *flags])
        assert why in capsys.readouterr().err
    for mode in ("pipedec", "pipedec-db"):
        with pytest.raises(ValueError):
            ServingEngine(pair[0], None, mode=mode)


def test_cli_pipedec_db_async_on_cpu(capsys):
    """``--executor async`` serves the smoke pair on free-running stage
    actors with the single-request engine's tokens, and shuts them down:
    no actor thread is left."""
    import threading
    engine = _check_cli_sharded(2, False, False, capsys, executor="async")
    ex = engine.executor
    assert ex.calls["stage_steps"] == ex.calls["entry_msgs"] * 2
    assert not [t for t in threading.enumerate()
                if t.name.startswith("async-")]


@pytest.mark.parametrize("executor,overlap", [("sharded", False),
                                              ("sharded", True),
                                              ("async", False)])
def test_cli_int8_on_the_ring_on_cpu(executor, overlap, capsys):
    """``--quant int8`` with ``--executor sharded [--overlap]`` and
    ``--executor async`` serves the int8 pair with the int8
    single-request engine's tokens."""
    engine = _check_cli_sharded(2, overlap, False, capsys,
                                executor=executor, quant="int8")
    assert engine.target.cfg.quant == engine.draft.cfg.quant == "int8"


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("paged", [False, True])
def test_cli_pipedec_db_sharded_on_cpu(overlap, paged, capsys):
    """``--mode pipedec-db --executor sharded [--overlap] [--paged]``
    serves the smoke pair on the stage ring; each request's tokens equal
    the single-request PipeDec engine's."""
    _check_cli_sharded(2, overlap, paged, capsys)


@pytest.mark.parametrize("overlap", [False, True])
def test_cli_sharded_with_a_stage_of_padding_on_cpu(overlap, capsys):
    """``--stages 3`` cuts the 4-layer smoke target into two layers a
    stage, so the last stage holds only padding; the ring passes it
    through and serves the single-request engine's tokens."""
    engine = _check_cli_sharded(3, overlap, False, capsys)
    assert not engine.executor.stage_valid[-1].any()


def _check_cli_sharded(stages, overlap, paged, capsys, executor="sharded",
                       quant="none"):
    argv = ["--mode", "pipedec-db", "--executor", executor, "--device",
            "cpu", "--requests", "3", "--new-tokens", "5", "--stages",
            str(stages), "--slots", "2", "--quant", quant] + \
        (["--overlap"] if overlap else []) + (["--paged"] if paged else [])
    engine, results = serve.main(argv)
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(results) == 3 and len(lines) == 3 and "acc=" in lines[0]
    ex = engine.executor
    assert ex.overlapped == (overlap or executor == "async")
    assert ex.paged == paged
    assert ex.calls["pipeline_tick" if ex.overlapped
                    else "pipeline_verify"] > 0
    single = PipeDecEngine(engine.target, engine.draft, engine.pipedec_cfg,
                           max_len=512)
    rng = np.random.default_rng(0)
    for uid in range(3):
        prompt = rng.integers(0, engine.target.cfg.vocab_size, size=8)
        np.testing.assert_array_equal(results[uid].tokens,
                                      single.generate(prompt, 5)[0])
    return engine


@pytest.mark.parametrize("mode", ["pp", "pipedec"])
def test_cli_on_cpu(mode, capsys):
    engine, results = serve.main(["--mode", mode, "--device", "cpu",
                                  "--requests", "2", "--new-tokens", "5",
                                  "--stages", "2"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(results) == 2 and len(lines) == 2
    assert engine.mode == mode and (engine.draft is None) == (mode == "pp")
    assert all(len(r.tokens) == 6 for r in results.values())
    assert ("acc=" in lines[0]) == (mode == "pipedec")


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_cli_pipedec_db_paged_on_cpu(quant, capsys):
    """``--mode pipedec-db --paged`` serves the smoke pair on the paged
    arena; each request's tokens equal the single-request PipeDec engine
    on the same (fp32 or int8) bundles."""
    argv = ["--mode", "pipedec-db", "--paged", "--device", "cpu",
            "--requests", "3", "--new-tokens", "5", "--stages", "2",
            "--slots", "2", "--quant", quant]
    engine, results = serve.main(argv)
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(results) == 3 and len(lines) == 3 and "acc=" in lines[0]
    assert engine.executor.paged and engine.db_stats.peak_occupancy == 2
    assert engine.target.cfg.quant == ("int8" if quant == "int8" else "")
    from repro_torch.core.pipedec import PipeDecEngine
    single = PipeDecEngine(engine.target, engine.draft, engine.pipedec_cfg,
                           max_len=engine.max_len)
    rng = np.random.default_rng(0)
    for uid in range(3):
        prompt = rng.integers(0, engine.target.cfg.vocab_size, size=8)
        want, _ = single.generate(prompt, 5)
        np.testing.assert_array_equal(results[uid].tokens, want)


@pytest.fixture(scope="module")
def tiny_pair():
    """{"target"|"draft": (port, jax)} on the same numpy weights."""
    from test_torch_baselines import DRAFT, TARGET, _pair
    return {"target": _pair(TARGET, 0), "draft": _pair(DRAFT, 9)}


@pytest.mark.parametrize("mode", ["pp", "pipedec", "pipedec-db"])
def test_eos_truncation_matches_jax_serving_engine(tiny_pair, mode):
    """eos set to a token that request 0's greedy output holds: every
    request's output stops at its first eos, eos included, as the JAX
    package's ServingEngine cuts it, in all three modes."""
    (t, jt), (d, jd) = tiny_pair["target"], tiny_pair["draft"]
    reqs = _requests([5, 5, 7], [10, 12, 9], seed=4)
    for r in reqs:
        r.prompt = r.prompt % t.cfg.vocab_size
    full = generate_autoregressive(t, reqs[0].prompt, reqs[0].max_new_tokens)
    eos = int(full[5])
    pcfg = PipeDecConfig(n_stages=2, width=4, branch=2)
    port = ServingEngine(t, d, mode=mode, max_batch=2, pipedec=pcfg,
                         eos_token=eos)
    ref = JaxServingEngine(jt, jd, mode=mode, max_batch=2,
                           pipedec=JaxPipeDecConfig(2, 4, 2), eos_token=eos)
    for r in reqs:
        port.submit(r)
        ref.submit(JaxRequest(r.uid, r.prompt.astype(np.int32),
                              r.max_new_tokens))
    got, want = port.run(), ref.run()
    assert sorted(got) == sorted(want) == [0, 1, 2]
    for uid in want:
        np.testing.assert_array_equal(got[uid].tokens, want[uid].tokens)
    cut = list(full).index(eos) + 1
    np.testing.assert_array_equal(got[0].tokens, full[:cut])
    assert cut < len(full)


def test_pp_sampling_replays_from_seeded_generators(tiny_pair):
    """pp mode with temperature > 0 samples every decode step per row from
    ``generator``: two generators with the same seed give the same tokens;
    the first token stays the prefill's argmax."""
    t, _ = tiny_pair["target"]
    sp = SamplingParams(temperature=0.9, top_k=50, top_p=0.95)
    outs = []
    for _ in range(2):
        eng = ServingEngine(t, mode="pp", max_batch=3, sampling=sp,
                            generator=torch.Generator().manual_seed(11))
        for r in _requests([4, 4, 4], [8, 8, 8], seed=5):
            r.prompt = r.prompt % t.cfg.vocab_size
            eng.submit(r)
        outs.append(eng.run())
    greedy = [generate_autoregressive(t, r.prompt % t.cfg.vocab_size, 8)
              for r in _requests([4, 4, 4], [8, 8, 8], seed=5)]
    for uid in range(3):
        a, b = outs[0][uid].tokens, outs[1][uid].tokens
        np.testing.assert_array_equal(a, b)
        assert len(a) == 9 and ((a >= 0) & (a < t.cfg.vocab_size)).all()
        assert a[0] == greedy[uid][0]
    assert any(not np.array_equal(outs[0][u].tokens, greedy[u])
               for u in range(3))
