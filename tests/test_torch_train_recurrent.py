"""The recurrent mixers' gradients under autograd: Mamba-2's chunked SSD
(``models/ssm.py``, the chunk loop included) and RecurrentGemma's RG-LRU
doubling scan (``models/rglru.py``) against ``jax.grad`` of the JAX
package's functions at their smoke widths, and the SSD gradient where a
chunk's decay overflows fp32.

There (a chunk's sum of dt * |A| above 88.7) the reference selects 0
after ``exp`` and its ``jax.grad`` is NaN, so the witness is the port's
own function computed in float64; the port masks the decay before
``exp``, which keeps the forward bit for bit (held against the form
before the repair).

Tolerances, relative to the compared tensor's largest magnitude: every
gradient leaf 1e-4 of ``jax.grad`` or of the float64 computation.
"""
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
from repro_torch.models.layers import trainable
from test_torch_train import TOL_GRAD, _close
from test_torch_ssm_rglru import _load, _noisy, port_cfg


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ssm_layer(dt_bias: float = 0.0):
    """(port cfg, JAX cfg, JAX SSD params (numpy), port SSM module) at
    Mamba-2's smoke width, with noisy constants and ``dt_bias`` added."""
    jcfg = jreg.get_config("mamba2-130m", smoke=True)
    params = _noisy(jax.device_get(JS.init_ssm(jax.random.PRNGKey(5), jcfg)),
                    np.random.default_rng(5),
                    ("conv_b", "dt_bias", "A_log", "D"))
    params["dt_bias"] = (params["dt_bias"] + dt_bias).astype(np.float32)
    cfg = port_cfg(jcfg)
    return cfg, jcfg, params, _load(S.SSM(cfg, "cpu"), params)


def _ssm_grads(module, cfg, x, w):
    """(y, {name: grad}) of sum(ssm_forward(x) * w) for ``module``."""
    module.zero_grad(set_to_none=True)
    trainable(module)
    y, _ = S.ssm_forward(module, cfg, x)
    (y * w).sum().backward()
    return y.detach(), {n: p.grad.clone()
                        for n, p in module.named_parameters()}


def _ssd_inputs(dt_bias: float, t: int = 40, seed: int = 6):
    """x [2, t, d] and the output weights, numpy."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, t, 128)).astype(np.float32)
    w = rng.normal(size=(2, t, 128)).astype(np.float32)
    return x, w


def _jax_ssm_grads(jcfg, params, x, w):
    jp = jax.tree.map(jnp.asarray, params)

    def f(p):
        y, _ = JS.ssm_forward(p, jcfg, jnp.asarray(x))
        return jnp.sum(y * jnp.asarray(w))
    return jax.jit(jax.grad(f))(jp)


def test_ssm_forward_grads_match_jax():
    """Every SSD leaf's gradient over 40 steps (3 chunks of 16, the last
    padded) at the initial dt against ``jax.grad``."""
    cfg, jcfg, params, module = _ssm_layer()
    x, w = _ssd_inputs(0.0)
    _, got = _ssm_grads(module, cfg, torch.from_numpy(x),
                        torch.from_numpy(w))
    want = _jax_ssm_grads(jcfg, params, x, w)
    for name, g in got.items():
        src = want
        for key in name.split("."):
            src = src[key]
        _close(g, src, TOL_GRAD, name)


# dt_bias 8: softplus(dt) about 8 a step, so a 16-step chunk spans about
# 120 above the diagonal, past fp32's exp overflow at 88.7
OVERFLOW_DT_BIAS = 8.0


def _ssd_where(x, dt, A, B, C, D, *, chunk: int):
    """``ssm.ssd_chunked`` as it stood before the decay mask moved ahead
    of ``exp`` (0 selected after ``exp``): the forward the repair keeps.
    No initial state."""
    b, t, h, hd = x.shape
    n, q = B.shape[-1], chunk
    nc = t // q
    xr, dtr = x.reshape(b, nc, q, h, hd).float(), dt.reshape(b, nc, q, h)
    Br, Cr = B.reshape(b, nc, q, n).float(), C.reshape(b, nc, q, n).float()
    cum = torch.cumsum(dtr.float() * A, dim=2)
    li = cum[:, :, :, None, :] - cum[:, :, None, :, :]
    ar = torch.arange(q)
    mask = (ar[:, None] >= ar[None, :])[None, None, :, :, None]
    L = torch.where(mask, torch.exp(li), torch.zeros(()))
    w = torch.einsum("bcin,bcjn->bcij", Cr, Br)[..., None] * L
    y_intra = torch.einsum("bcijh,bcjh,bcjhd->bcihd", w, dtr.float(), xr)
    total = cum[:, :, -1, :]
    decay_out = torch.exp(total[:, :, None, :] - cum)
    s_in = torch.einsum("bcjh,bcjh,bcjhd,bcjn->bchdn", decay_out,
                        dtr.float(), xr, Br)
    state = torch.zeros((b, h, hd, n))
    prev = []
    for c in range(nc):
        prev.append(state)
        state = state * torch.exp(total[:, c])[:, :, None, None] + s_in[:, c]
    y_inter = torch.einsum("bcin,bcih,bchdn->bcihd", Cr, torch.exp(cum),
                           torch.stack(prev, dim=1))
    y = (y_intra + y_inter).reshape(b, t, h, hd)
    return (y + x.float() * D[None, None, :, None]).to(x.dtype), state


def _ssd_case(seed: int = 7):
    """SSD inputs at Mamba-2's smoke width (8 heads of 32, N 16, chunk
    16, 48 steps) with dt = softplus(N(0,1) + OVERFLOW_DT_BIAS), A = -1."""
    rng = np.random.default_rng(seed)
    b, t, h, hd, n = 2, 48, 8, 32, 16
    raw = rng.normal(size=(b, t, h)) + OVERFLOW_DT_BIAS
    return {"x": rng.normal(size=(b, t, h, hd)).astype(np.float32),
            "dt": np.log1p(np.exp(raw)).astype(np.float32),
            "A": -np.ones(h, np.float32),
            "B": rng.normal(size=(b, t, n)).astype(np.float32),
            "C": rng.normal(size=(b, t, n)).astype(np.float32),
            "D": rng.normal(size=(h,)).astype(np.float32),
            "w": rng.normal(size=(b, t, h, hd)).astype(np.float32)}


def _chunk_span(case) -> float:
    """The largest sum of dt * |A| over one 16-step chunk."""
    dta = case["dt"] * -case["A"]
    return float(dta.reshape(2, -1, 16, 8).sum(2).max())


def _port_ssd_grads(case, dtype):
    """(y, grads of sum(y * w) for x, dt, B, C) of the port's
    ``ssd_chunked`` computed in ``dtype``."""
    ts = {k: torch.tensor(case[k], dtype=dtype, requires_grad=k in
                          ("x", "dt", "B", "C")) for k in case}
    y, _ = S.ssd_chunked(ts["x"], ts["dt"], ts["A"], ts["B"], ts["C"],
                         ts["D"], chunk=16)
    (y * ts["w"]).sum().backward()
    return y.detach(), [ts[k].grad for k in ("x", "dt", "B", "C")]


def test_ssd_grad_finite_and_f64_where_chunk_decay_overflows():
    """A chunk spans more than 88.7: the port's gradient is finite and
    within 1e-4 of the same function in float64."""
    case = _ssd_case()
    assert _chunk_span(case) > 88.7
    _, got = _port_ssd_grads(case, torch.float32)
    _, want = _port_ssd_grads(case, torch.float64)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        _close(g, w, TOL_GRAD)


def test_ssd_forward_unchanged_by_the_decay_mask():
    """The forward is bit for bit that of the form before the repair (0
    selected after ``exp``), where the chunk's decay overflows and at the
    initial dt."""
    overflow = _ssd_case()
    normal = dict(overflow, dt=np.log1p(np.exp(
        np.random.default_rng(9).normal(size=overflow["dt"].shape)))
        .astype(np.float32))
    for case in (overflow, normal):
        ts = {k: torch.from_numpy(v) for k, v in case.items()}
        y, state = S.ssd_chunked(ts["x"], ts["dt"], ts["A"], ts["B"],
                                 ts["C"], ts["D"], chunk=16)
        y0, state0 = _ssd_where(ts["x"], ts["dt"], ts["A"], ts["B"],
                                ts["C"], ts["D"], chunk=16)
        assert torch.equal(y, y0) and torch.equal(state, state0)


def test_reference_ssd_grad_is_nan_where_chunk_decay_overflows():
    """A reference-side limit: the reference selects 0 after ``exp``
    (``jnp.where(mask, jnp.exp(li), 0.0)``), so ``jax.grad`` multiplies
    the selected 0 by ``exp``'s inf above the diagonal and gives NaN, on
    the case where the port's gradient is finite."""
    case = _ssd_case()

    def f(x, dt, B, C):
        y, _ = JS.ssd_chunked(x, dt, jnp.asarray(case["A"]), B, C,
                              jnp.asarray(case["D"]), chunk=16)
        return jnp.sum(y * jnp.asarray(case["w"]))
    grads = jax.grad(f, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(case[k]) for k in ("x", "dt", "B", "C")))
    assert any(bool(jnp.isnan(g).any()) for g in grads)
    _, got = _port_ssd_grads(case, torch.float32)
    assert all(torch.isfinite(g).all() for g in got)


def test_ssm_layer_grads_finite_where_chunk_decay_overflows():
    """The whole SSD layer with ``dt_bias`` raised by 8: every leaf's
    gradient finite and within 1e-4 of a float64 copy of the layer."""
    cfg, _, _, module = _ssm_layer(dt_bias=OVERFLOW_DT_BIAS)
    x, w = _ssd_inputs(OVERFLOW_DT_BIAS)
    _, got = _ssm_grads(module, cfg, torch.from_numpy(x),
                        torch.from_numpy(w))
    _, want = _ssm_grads(module.double(), cfg,
                         torch.from_numpy(x).double(),
                         torch.from_numpy(w).double())
    for name, g in got.items():
        assert torch.isfinite(g).all(), name
        _close(g, want[name], TOL_GRAD, name)


def test_rglru_grads_match_jax_at_the_clamp_edge():
    """RG-LRU's doubling scan under autograd against ``jax.grad`` through
    the reference's ``associative_scan``, every leaf, with a quarter of
    the channels' lambda at 40: there a = 1 in fp32, so ``1 - a^2`` is 0
    and takes the ``clamp_min(1e-12)`` edge (gradient 0 in both)."""
    jcfg = jreg.get_config("recurrentgemma-9b", smoke=True)
    cfg = port_cfg(jcfg)
    params = jax.tree.map(np.asarray, jax.device_get(
        JR.init_rglru(jax.random.PRNGKey(4), jcfg)))
    rng = np.random.default_rng(4)
    params["conv_b"] = (0.1 * rng.normal(size=params["conv_b"].shape)
                        ).astype(np.float32)
    lam = params["lambda"].copy()
    lam[::4] = 40.0
    params["lambda"] = lam
    module = _load(R.RGLRU(cfg, "cpu"), params)
    trainable(module)
    x = rng.normal(size=(2, 37, cfg.d_model)).astype(np.float32)
    w = rng.normal(size=(2, 37, cfg.d_model)).astype(np.float32)
    log_a, _ = R._gates(module, torch.ones(1, cfg.rglru.lru_width))
    assert (torch.exp(2 * log_a[0, ::4]) == 1).all()   # the clamp edge

    def f(p):
        y, _ = JR.rglru_forward(p, jcfg, jnp.asarray(x))
        return jnp.sum(y * jnp.asarray(w))
    want = jax.jit(jax.grad(f))(jax.tree.map(jnp.asarray, params))
    y, _ = R.rglru_forward(module, cfg, torch.from_numpy(x))
    (y * torch.from_numpy(w)).sum().backward()
    for name, p in module.named_parameters():
        assert torch.isfinite(p.grad).all(), name
        _close(p.grad, want[name], TOL_GRAD, name)
