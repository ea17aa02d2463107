"""The port's recurrent mixers (``models/ssm.py``: Mamba-2's chunked SSD;
``models/rglru.py``: RecurrentGemma's RG-LRU) against the JAX package's
functions, at the smoke widths of ``mamba2-130m`` and
``recurrentgemma-9b``.

Weights come from the JAX initialisers, with numpy noise on the leaves
they draw as constants (biases, A_log, D, the norm scale), and are copied
into the port's modules by name; inputs are drawn with numpy from a seed.
Tolerance: 1e-5 absolute (fp32 sums in another order).  The RG-LRU scan
is also held, over a 2112-step input (longer than RecurrentGemma's 2048
window), to a float64 sequential scan: finite and within 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jreg
from repro.models import rglru as JR
from repro.models import ssm as JS
from repro_torch.models import rglru as R
from repro_torch.models import ssm as S
from repro_torch.models.config import ModelConfig

ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_cfg(jcfg) -> ModelConfig:
    return ModelConfig(**{f.name: getattr(jcfg, f.name)
                          for f in dataclasses.fields(jcfg)})


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


def _noisy(params, rng, names):
    """The JAX leaves named in ``names`` plus N(0, 0.1) noise."""
    def f(path, x):
        x = np.asarray(x)
        if path[-1].key in names:
            return (x + 0.1 * rng.normal(size=x.shape)).astype(np.float32)
        return x
    return jax.tree_util.tree_map_with_path(f, params)


def _load(module, params):
    """Copy a JAX mixer's leaves into the port module, by name."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            src = params
            for key in name.split("."):
                src = src[key]
            p.copy_(torch.from_numpy(np.array(src, np.float32)))
    return module


@pytest.fixture(scope="module")
def ssm():
    """(port cfg, JAX cfg, JAX params (jnp), port SSM), same weights."""
    jcfg = jreg.get_config("mamba2-130m", smoke=True)
    params = _noisy(jax.device_get(JS.init_ssm(jax.random.PRNGKey(1), jcfg)),
                    np.random.default_rng(1),
                    ("conv_b", "dt_bias", "A_log", "D", "scale"))
    cfg = port_cfg(jcfg)
    return (cfg, jcfg, jax.tree.map(jnp.asarray, params),
            _load(S.SSM(cfg, "cpu"), params))


@pytest.fixture(scope="module")
def lru():
    """(port cfg, JAX cfg, JAX params (jnp), port RGLRU), same weights."""
    jcfg = jreg.get_config("recurrentgemma-9b", smoke=True)
    params = _noisy(jax.device_get(JR.init_rglru(jax.random.PRNGKey(2),
                                                 jcfg)),
                    np.random.default_rng(2), ("conv_b",))
    cfg = port_cfg(jcfg)
    return (cfg, jcfg, jax.tree.map(jnp.asarray, params),
            _load(R.RGLRU(cfg, "cpu"), params))


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("t", [32, 27])
@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_chunked_matches_jax(t, with_state):
    """T a multiple of the chunk (32 = 2 x 16) and not (27, padded to 32
    with zero steps as ``ssm_forward`` pads); with and without an initial
    state."""
    rng = np.random.default_rng(t + 7 * with_state)
    b, h, hd, n, q = 2, 3, 8, 5, 16
    pad = (-t) % q
    x = rng.normal(size=(b, t, h, hd)).astype(np.float32)
    dt = rng.uniform(0.1, 1.0, size=(b, t, h)).astype(np.float32)
    A = (-rng.uniform(0.5, 2.0, size=(h,))).astype(np.float32)
    B = rng.normal(size=(b, t, n)).astype(np.float32)
    C = rng.normal(size=(b, t, n)).astype(np.float32)
    D = rng.normal(size=(h,)).astype(np.float32)
    x, dt, B, C = (np.pad(u, [(0, 0), (0, pad)] + [(0, 0)] * (u.ndim - 2))
                   for u in (x, dt, B, C))
    s0 = (rng.normal(size=(b, h, hd, n)).astype(np.float32) if with_state
          else None)
    jy, js = JS.ssd_chunked(*map(jnp.asarray, (x, dt, A, B, C, D)), chunk=q,
                            initial_state=None if s0 is None
                            else jnp.asarray(s0))
    ty, ts = S.ssd_chunked(*map(_t, (x, dt, A, B, C, D)), chunk=q,
                           initial_state=None if s0 is None else _t(s0))
    _close(ty[:, :t], jy[:, :t])
    _close(ts, js)


@pytest.mark.parametrize("s", [37, 16, 2])
def test_ssm_forward_matches_jax(ssm, s):
    """Output and both state leaves; 37 pads T to the chunk, 16 is one
    chunk, 2 is shorter than d_conv - 1 (the conv state left-padded)."""
    cfg, jcfg, jp, mod = ssm
    x = np.random.default_rng(s).normal(size=(2, s, cfg.d_model)).astype(
        np.float32)
    jy, jst = JS.ssm_forward(jp, jcfg, jnp.asarray(x))
    ty, tst = S.ssm_forward(mod, cfg, _t(x))
    _close(ty, jy)
    assert set(tst) == set(jst) == {"conv", "ssd"}
    for k in tst:
        assert tuple(tst[k].shape) == jst[k].shape, k
        _close(tst[k], jst[k])


def test_ssm_decode_continues_prefill(ssm):
    """Decode steps after a prefill: each step's output and state against
    the JAX step fed the JAX state."""
    cfg, jcfg, jp, mod = ssm
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 20, cfg.d_model)).astype(np.float32)
    _, jst = JS.ssm_forward(jp, jcfg, jnp.asarray(x))
    _, tst = S.ssm_forward(mod, cfg, _t(x))
    for _ in range(3):
        xt = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
        jy, jst = JS.ssm_decode(jp, jcfg, jnp.asarray(xt), jst)
        ty, tst = S.ssm_decode(mod, cfg, _t(xt), tst)
        _close(ty, jy)
        for k in tst:
            _close(tst[k], jst[k])
    zero = S.init_ssm_state(cfg, 3, "cpu")
    want = JS.init_ssm_state(jcfg, 3)
    assert {k: tuple(v.shape) for k, v in zero.items()} == \
        {k: v.shape for k, v in want.items()}


@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_scan_matches_jax(with_h0):
    rng = np.random.default_rng(11 + with_h0)
    b, t, w = 2, 45, 16
    log_a = (-rng.uniform(0.01, 1.0, size=(b, t, w))).astype(np.float32)
    u = rng.normal(size=(b, t, w)).astype(np.float32)
    h0 = rng.normal(size=(b, w)).astype(np.float32) if with_h0 else None
    jh = JR.rglru_scan(jnp.asarray(log_a), jnp.asarray(u),
                       None if h0 is None else jnp.asarray(h0))
    th = R.rglru_scan(_t(log_a), _t(u), None if h0 is None else _t(h0))
    _close(th, jh)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("s", [23, 2])
def test_rglru_forward_matches_jax(lru, s, with_state):
    """Output and state, from zero or continuing a state; 2 steps is
    shorter than d_conv - 1."""
    cfg, jcfg, jp, mod = lru
    rng = np.random.default_rng(s + 3 * with_state)
    x = rng.normal(size=(2, s, cfg.d_model)).astype(np.float32)
    state = None
    if with_state:
        w = cfg.rglru.lru_width
        state = {"conv": rng.normal(size=(2, cfg.rglru.d_conv - 1, w)),
                 "h": rng.normal(size=(2, w))}
        state = {k: v.astype(np.float32) for k, v in state.items()}
    jy, jst = JR.rglru_forward(jp, jcfg, jnp.asarray(x), state=None if
                               state is None else
                               jax.tree.map(jnp.asarray, state))
    ty, tst = R.rglru_forward(mod, cfg, _t(x), state=None if state is None
                              else {k: _t(v) for k, v in state.items()})
    _close(ty, jy)
    assert set(tst) == set(jst) == {"conv", "h"}
    for k in tst:
        assert tuple(tst[k].shape) == jst[k].shape, k
        _close(tst[k], jst[k])


def test_rglru_decode_matches_jax(lru):
    cfg, jcfg, jp, mod = lru
    rng = np.random.default_rng(9)
    x = rng.normal(size=(2, 12, cfg.d_model)).astype(np.float32)
    _, jst = JR.rglru_forward(jp, jcfg, jnp.asarray(x))
    _, tst = R.rglru_forward(mod, cfg, _t(x))
    for _ in range(3):
        xt = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
        jy, jst = JR.rglru_decode(jp, jcfg, jnp.asarray(xt), jst)
        ty, tst = R.rglru_decode(mod, cfg, _t(xt), tst)
        _close(ty, jy)
        for k in tst:
            _close(tst[k], jst[k])
    zero = R.init_rglru_state(cfg, 3, "cpu")
    want = JR.init_rglru_state(jcfg, 3)
    assert {k: tuple(v.shape) for k, v in zero.items()} == \
        {k: v.shape for k, v in want.items()}


def test_rglru_scan_long_prompt_is_stable():
    """2112 steps, decays a in [0.5, 0.999] and the gate's input
    sqrt(1 - a^2) x: finite, and within 1e-5 of a float64 sequential
    scan (a global cumsum of log-decays times exp(-L_j) overflows here)."""
    rng = np.random.default_rng(21)
    b, t, w = 1, 2112, 64
    a = rng.uniform(0.5, 0.999, size=(b, t, w))
    u = np.sqrt(1.0 - a * a) * rng.normal(size=(b, t, w))
    log_a = np.log(a)
    got = R.rglru_scan(torch.from_numpy(log_a.astype(np.float32)),
                       torch.from_numpy(u.astype(np.float32))).numpy()
    assert np.isfinite(got).all()
    ref = np.zeros((b, t, w))
    h = np.zeros((b, w))
    for i in range(t):
        h = np.exp(log_a[:, i]) * h + u[:, i]
        ref[:, i] = h
    _close(got, ref)


def test_port_init_draws_the_reference_distributions(ssm, lru):
    """The port's own initialisers: sigmoid(lambda)^8 on [0.9, 0.999]
    (Griffin's init), SSD's constants (A = -1, D = 1, zero biases)."""
    cfg = lru[0]
    gen = torch.Generator().manual_seed(0)
    mod = R.RGLRU(cfg, "cpu")
    with torch.no_grad():
        mod.reset_parameters(gen)
    a = torch.sigmoid(mod.lam) ** 8
    assert 0.9 - 1e-5 <= float(a.min()) and float(a.max()) <= 0.999 + 1e-5
    assert not mod.conv_b.any()
    s = S.SSM(ssm[0], "cpu")
    with torch.no_grad():
        s.reset_parameters(gen)
    assert (s.A_log == 0).all() and (s.D == 1).all()
    assert not s.dt_bias.any() and not s.conv_b.any()
