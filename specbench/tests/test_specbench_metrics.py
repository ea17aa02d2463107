"""The host-clock metrics' arithmetic over synthetic stamps (the end-to-end
ones and the chat cell's time to first token): each moves when stalls are
put into the timeline."""
import dataclasses

import pytest

from specbench.lib import bench, serve


def reader(name):
    b = bench.load()
    return bench.reader(next(m for m in b["end_to_end"] + b["per_layer"]
                             if m["name"] == name))


def timeline(stall_every: int = 0, stall: float = 0.0) -> serve.Run:
    """200 requests on 4 slots, one token each 0.1 s a timestep; every
    ``stall_every``-th timestep takes ``stall`` seconds more.  Request u
    ends after 15 + u % 7 tokens and the next is sent at that moment; after
    the window, each request sent in it gets its first token a timestep
    later (the harness's drain)."""
    n = 200
    t, stamps, sent = 0.0, {u: [] for u in range(n)}, {}
    active = [0, 1, 2, 3]
    for u in active:
        sent[u] = 0.0
    nxt, step = 4, 0
    while t < 20.0:
        step += 1
        t += 0.1 + (stall if stall_every and step % stall_every == 0
                    else 0.0)
        for i, u in enumerate(active):
            if u is None:
                continue
            stamps[u].append(t)
            if len(stamps[u]) == 15 + u % 7:
                active[i] = nxt if nxt < n else None
                if nxt < n:
                    sent[nxt] = t
                nxt += 1
    for u in active:
        if u is not None and not stamps[u]:
            stamps[u].append(t + 0.1)
    return serve.Run(cfg={}, mix={}, setup_s=1.0, t0=0.0, t1=t, steps=[],
                     stamps=stamps, sent=sent, served={}, finished=[],
                     requests=[], weights={})


def test_sound_timeline_reads_its_rates():
    r = timeline()
    assert reader("tokens_per_s").read(r) == pytest.approx(40.0)
    assert reader("tbt_p95_ms").read(r) == pytest.approx(100.0)
    # sent at a retire, first token one timestep later
    assert reader("ttft_p80_ms.chat").read(r) == pytest.approx(100.0)
    assert reader("setup_s").read(r) == 1.0


@pytest.mark.parametrize("name,worse", [("tokens_per_s", "lower"),
                                        ("tbt_p95_ms", "higher"),
                                        ("ttft_p80_ms.chat", "higher")])
def test_stalls_move_every_metric(name, worse):
    sound, stalled = timeline(), timeline(stall_every=2, stall=0.3)
    a, b = reader(name).read(sound), reader(name).read(stalled)
    assert (b < 0.8 * a) if worse == "lower" else (b > 1.5 * a)


def test_a_request_without_its_first_token_reads_nothing():
    r = timeline()
    late = max(u for u, s in r.sent.items() if s > 0)
    r = dataclasses.replace(r, stamps={**r.stamps, late: []})
    assert reader("ttft_p80_ms.chat").read(r) is None


def test_traced_timesteps_are_left_out_of_the_window_rates():
    steps = [serve.Step(end=0.1 * (i + 1), flops=1e12, prefill_s=0.05,
                        traced=4 <= i < 6) for i in range(10)]
    r = dataclasses.replace(timeline(), steps=steps, t0=0.0)
    rows = serve.untraced(r)
    assert len(rows) == 8 and all(dt == pytest.approx(0.1) for dt, _ in rows)
    share = bench.reader(next(m for m in bench.load()["per_layer"]
                              if m["name"] == "prefill_share"))
    assert share.read(r) == pytest.approx(50.0)


def test_traced_run_reduces_its_profiled_window():
    """A traced smoke run on the CPU: the profiled timesteps are marked and
    left out of the window rates, and the trace has its window span."""
    from specbench.tests import smoke
    r = smoke.run("qwen2", 7, seconds=2.0, traced=True)
    traced = [s for s in r.steps if s.traced]
    assert 0 < len(traced) <= serve.TRACE_STEPS
    assert r.trace["timesteps"] == len(traced)
    assert 0 < r.trace["window_s"] < r.window_s
    assert len(serve.untraced(r)) == len(r.steps) - len(traced)
