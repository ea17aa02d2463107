"""The port's AdamW against the JAX package's on the same inputs.

Both updates are fed the same numpy parameters and gradients, step after
step, so the comparison holds the update itself (not a training run,
where Adam's near-sign first step would amplify fp32 differences in the
gradients).  Tolerance 1e-6 relative: ``grad_norm`` and ``lr`` (atol
1e-12 for exact zeros), and every element of params, m and v within
1e-6 of its tensor's largest magnitude (``m = b1 m + (1 - b1) g`` cancels,
so an element near 0 differs by a few ulps of its terms, not of itself).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro_torch import optim as toptim

RTOL, ATOL = 1e-6, 1e-12
SHAPES = [(16, 8), (8,), (4, 3, 5), (1,)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, msg):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=RTOL * np.abs(want).max() + ATOL,
                               err_msg=msg)


@pytest.mark.parametrize("step", [0, 1, 5, 9, 10, 11, 55, 100, 101, 250])
def test_cosine_schedule(step):
    kw = dict(lr=3e-3, warmup_steps=10, total_steps=100)
    want = float(joptim.cosine_schedule(joptim.AdamWConfig(**kw), step))
    got = toptim.cosine_schedule(toptim.AdamWConfig(**kw), step)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=RTOL, atol=ATOL)
    if step == 0 or step >= 100:
        assert float(got) == pytest.approx(0.0, abs=1e-12)
    if step == 10:
        assert float(got) == pytest.approx(3e-3, rel=1e-6)


def test_cosine_schedule_zero_warmup():
    kw = dict(lr=1e-3, warmup_steps=0, total_steps=0)
    for step in (0, 1, 3):
        want = float(joptim.cosine_schedule(joptim.AdamWConfig(**kw), step))
        got = float(toptim.cosine_schedule(toptim.AdamWConfig(**kw), step))
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_global_norm():
    rng = np.random.default_rng(0)
    xs = [rng.normal(size=s).astype(np.float32) for s in SHAPES]
    want = float(joptim.global_norm([jnp.asarray(x) for x in xs]))
    got = toptim.global_norm([torch.from_numpy(x) for x in xs])
    np.testing.assert_allclose(float(got), want, rtol=RTOL)
    assert float(toptim.global_norm([torch.zeros(3)])) == 0.0


def test_adamw_init():
    ps = [torch.ones(s) for s in SHAPES]
    st = toptim.adamw_init(ps)
    assert int(st["step"]) == 0 and st["step"].dtype == torch.int32
    for m, v, p in zip(st["m"], st["v"], ps):
        assert m.shape == p.shape and not m.any() and not v.any()


@pytest.mark.parametrize("grad_scale", [0.01, 10.0], ids=["unclipped",
                                                          "clipped"])
def test_adamw_update_five_steps_match_jax(grad_scale):
    rng = np.random.default_rng(1)
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=6, weight_decay=0.1,
              clip_norm=1.0)
    jcfg, tcfg = joptim.AdamWConfig(**kw), toptim.AdamWConfig(**kw)
    params = [rng.normal(size=s).astype(np.float32) for s in SHAPES]
    jp = [jnp.asarray(p) for p in params]
    tp = [torch.from_numpy(p.copy()) for p in params]
    jst, tst = joptim.adamw_init(jp), toptim.adamw_init(tp)
    update = jax.jit(lambda p, g, s: joptim.adamw_update(jcfg, p, g, s))
    for step in range(5):
        grads = [(grad_scale * rng.normal(size=s)).astype(np.float32)
                 for s in SHAPES]
        if step == 3:
            grads[1][:] = 0.0          # a zero gradient: decay alone
        jp, jst, jm = update(jp, [jnp.asarray(g) for g in grads], jst)
        tp, tst, tm = toptim.adamw_update(
            tcfg, tp, [torch.from_numpy(g) for g in grads], tst)
        gn = float(jm["grad_norm"])
        assert (gn > 1.0) == (grad_scale > 1.0)      # clip on / off
        np.testing.assert_allclose(float(tm["grad_norm"]), gn, rtol=RTOL)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=RTOL, atol=ATOL)
        assert int(tst["step"]) == int(jst["step"]) == step + 1
        for name, got, want in (("params", tp, jp), ("m", tst["m"], jst["m"]),
                                ("v", tst["v"], jst["v"])):
            for g, w in zip(got, want):
                _close(g.numpy(), w, f"{name} step {step}")


def test_adamw_update_in_place():
    """The port updates the given tensors (the model's weights) in place."""
    ps = [torch.ones(s) for s in SHAPES]
    ids = [p.data_ptr() for p in ps]
    st = toptim.adamw_init(ps)
    out, st, _ = toptim.adamw_update(toptim.AdamWConfig(warmup_steps=1), ps,
                                     [torch.ones(s) for s in SHAPES], st)
    assert [p.data_ptr() for p in out] == ids
    assert all((p < 1).all() for p in ps)
