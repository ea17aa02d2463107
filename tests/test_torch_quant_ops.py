"""The port's int8 pieces at op level against the JAX package, on the same
numpy inputs: quantization (bit for bit), the dequant-matmul's plain
version against the Pallas kernel in interpret mode and its jnp oracle,
and the int8 modes of the two attention kernels' plain versions against
the Pallas kernels' int8 modes in interpret mode.

Tolerances: quantization is exact (the same fp32 division and
round-half-to-even in both packages).  Attention outputs are within 1e-5
absolute (fp32 sums in another order, on values of size about 1); matmul
outputs, sums of up to a few hundred products that grow to about 20,
within 1e-5 relative plus 1e-5 absolute.  The int8 inputs themselves are
shared, so nothing else differs.  The int8 CUDA kernels are held to
their plain versions on a card by ``test_torch_quant_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import quant as jquant
from repro.kernels import ref as jref
from repro.kernels.flash import flash_attention_lse as jflash
from repro.kernels.tree_block import tree_block_attention as jtree
from repro_torch.kernels import flash, ops, quant, ref, tree_block

ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # torch's CPU thread pool and XLA's contend in one process
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _close(got, want, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def _awkward(rng, *shape):
    """Normal values plus all-zero slices along the last axis and values
    placed exactly on rounding ties: a slice whose amax is 127 has scale
    exactly 1, so k + 0.5 divides to a tie."""
    x = _rand(rng, *shape)
    flat = x.reshape(-1, shape[-1])
    flat[0] = 0.0
    flat[1] = np.arange(shape[-1]) % 9 - 4 + 0.5
    flat[1, 0] = 127.0
    flat[2] = -flat[1]
    return x


@pytest.mark.parametrize("shape,axis", [((3, 5, 2, 16), -1),
                                        ((4, 7, 33), -1), ((6, 40), 0)])
def test_quantize_rows_bit_equal_to_jax(shape, axis):
    rng = np.random.default_rng(len(shape) + shape[-1])
    x = _awkward(rng, *shape)
    q, s = quant.quantize_rows(torch.tensor(x), axis)
    jq, js = jquant.quantize_rows(jnp.asarray(x), axis)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        quant.dequantize_rows(q, s, axis).numpy(),
        np.asarray(jquant.dequantize_rows(jq, js, axis)))
    if axis == -1:       # the zero slice and the ties, as set above
        flat_q = q.numpy().reshape(-1, shape[-1])
        assert (flat_q[0] == 0).all() and s.numpy().reshape(-1)[0] == 1.0
        assert (flat_q[1, 1:] % 2 == 0).all()      # half to even


@pytest.mark.parametrize("shape,n_in", [((32, 48), 1), ((16, 4, 8), 1),
                                        ((4, 8, 24), 2)])
def test_quantize_weight_bit_equal_to_jax(shape, n_in):
    rng = np.random.default_rng(sum(shape) + n_in)
    w = _rand(rng, *shape)
    w.reshape(-1, shape[-1])[:, 3] = 0.0           # an all-zero channel
    w.reshape(-1, shape[-1])[:, 5] = 0.5 * (np.arange(
        w.size // shape[-1]) % 5 - 2)              # amax 1: ties at 63.5
    q8, scale = quant.quantize_weight(torch.tensor(w), n_in)
    want = jquant.quantize_weight(jnp.asarray(w), n_in)
    np.testing.assert_array_equal(q8.numpy(), np.asarray(want["q8"]))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(want["scale"]))
    np.testing.assert_array_equal(
        quant.dequantize_weight(q8, scale).numpy(),
        np.asarray(jquant.dequantize_weight(want)))
    assert quant.is_quantized(want) and not quant.is_quantized(
        torch.tensor(w))


@pytest.mark.parametrize("m,k,n", [(7, 33, 19), (1, 64, 40),
                                   (130, 96, 200)])
def test_dequant_matmul_plain_matches_pallas(m, k, n):
    """Ragged shapes (the Pallas kernel pads them to its block grid) and a
    zero output channel, which must come out exactly zero."""
    rng = np.random.default_rng(m * 7 + k + n)
    x = _rand(rng, m, k)
    w = _rand(rng, k, n)
    w[:, 2] = 0.0
    wq = jquant.quantize_weight(jnp.asarray(w), 1)
    q8, scale = np.asarray(wq["q8"]), np.asarray(wq["scale"])
    got = quant.dequant_matmul(torch.tensor(x), torch.tensor(q8),
                               torch.tensor(scale))
    jx = jnp.asarray(x)
    _close(got, jquant.dequant_matmul_kernel(
        jx, wq["q8"], wq["scale"], block_m=64, block_n=64, block_k=32,
        interpret=True), rtol=1e-5)
    _close(got, jref.dequant_matmul_ref(jx, wq["q8"], wq["scale"]),
           rtol=1e-5)
    _close(ref.dequant_matmul_ref(torch.tensor(x), torch.tensor(q8),
                                  torch.tensor(scale)), got, atol=0)
    assert (got[:, 2] == 0).all()


def test_quant_matmul_collapses_contraction_axes():
    """w_o-style weight [H,hd,d] (two contraction axes) on [B,S,H,hd]
    activations, and w_q-style [d,H,hd] on [B,S,d], against the JAX
    seam's jnp path."""
    rng = np.random.default_rng(21)
    for x_shape, w_shape, n_in in (((2, 3, 4, 8), (4, 8, 16), 2),
                                   ((2, 3, 16), (16, 4, 8), 1)):
        x, w = _rand(rng, *x_shape), _rand(rng, *w_shape)
        wq = jquant.quantize_weight(jnp.asarray(w), n_in)
        got = ops.quant_matmul(torch.tensor(x),
                               torch.tensor(np.asarray(wq["q8"])),
                               torch.tensor(np.asarray(wq["scale"])))
        want = jops.quant_matmul(jnp.asarray(x), wq, use_kernel=False)
        assert tuple(got.shape) == want.shape
        _close(got, want, rtol=1e-5)


def _q(x):
    """int8 values and per-row scales (numpy) of an fp32 array."""
    q, s = jquant.quantize_rows(jnp.asarray(x))
    return np.asarray(q), np.asarray(s)


FLASH_CASES = [
    # name, b, h, kv, n, hd, L, kv_len, causal, window
    ("tree-past", 2, 4, 2, 8, 32, 96, [40, 77], False, 0),
    ("decode", 3, 4, 1, 1, 16, 64, [17, 0, 64], False, 0),
    ("causal-prefill", 1, 8, 2, 24, 32, 24, [24], True, 0),
    ("window", 2, 4, 2, 6, 32, 80, [70, 33], False, 12),
]


@pytest.mark.parametrize("case", FLASH_CASES, ids=lambda c: c[0])
def test_flash_int8_plain_matches_pallas(case):
    _, b, h, kv, n, hd, length, kv_len, causal, window = case
    rng = np.random.default_rng(n * 31 + hd + length)
    q = _rand(rng, b, h, n, hd)
    (kq, ks), (vq, vs) = (_q(_rand(rng, b, kv, length, hd))
                          for _ in range(2))
    kvl = np.asarray(kv_len, np.int32)
    if causal:
        qpos = np.broadcast_to(np.arange(length - n, length, dtype=np.int32),
                               (b, n))
    else:
        qpos = np.maximum(kvl[:, None] - 1, 0) + np.arange(n) // 2
    qpos = np.ascontiguousarray(qpos, np.int32)
    jo, jm, jl = jflash(*map(jnp.asarray, (q, kq, vq, kvl, qpos)),
                        k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs),
                        causal=causal, window=window, block_k=16)
    o, m, l = flash.flash_attention_lse(
        *map(torch.tensor, (q, kq, vq, kvl, qpos)), k_scale=torch.tensor(ks),
        v_scale=torch.tensor(vs), causal=causal, window=window)
    _close(o, jo)
    _close(m, np.asarray(jm)[..., 0])
    _close(l, np.asarray(jl)[..., 0])


def test_flash_int8_reads_cache_layout_by_stride():
    """An int8 [B,L,KV,hd] cache and its [B,L,KV] scales passed as
    transposed views give the same result as contiguous copies."""
    rng = np.random.default_rng(4)
    q = torch.tensor(_rand(rng, 3, 4, 4, 16))
    kq, ks = map(torch.tensor, _q(_rand(rng, 3, 20, 2, 16)))
    kv, sv = kq.transpose(1, 2), ks.transpose(1, 2)
    got = flash.flash_attention_lse(q, kv, kv, [5, 20, 0], k_scale=sv,
                                    v_scale=sv)
    want = flash.flash_attention_lse(q, kv.contiguous(), kv.contiguous(),
                                     [5, 20, 0], k_scale=sv.contiguous(),
                                     v_scale=sv.contiguous())
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("b,h,kv,n,hd,t,per_row", [
    (1, 4, 2, 8, 32, 24, False), (3, 8, 2, 4, 16, 41, True)])
def test_tree_int8_plain_matches_pallas(b, h, kv, n, hd, t, per_row):
    rng = np.random.default_rng(t + hd)
    q = _rand(rng, b, h, n, hd)
    (kq, ks), (vq, vs) = (_q(_rand(rng, b, kv, t, hd)) for _ in range(2))
    mask = rng.random((b, n, t) if per_row else (n, t)) < 0.4
    mask[..., -1, :] = False                        # an all-false row
    jo, jm, jl = jtree(*map(jnp.asarray, (q, kq, vq, mask)),
                       k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    o, m, l = tree_block.tree_block_attention(
        *map(torch.tensor, (q, kq, vq, mask)), k_scale=torch.tensor(ks),
        v_scale=torch.tensor(vs))
    _close(o, jo)
    _close(m, np.asarray(jm)[..., 0])
    _close(l, np.asarray(jl)[..., 0])
    assert (o[..., -1, :] == 0).all() and (l[..., -1] == 0).all()


def test_tree_attention_int8_matches_quant_ref():
    """Both kernels' int8 modes + combine_lse == the JAX quantized oracle
    (and the port's copy of it), per-row prefixes and masks."""
    rng = np.random.default_rng(8)
    b, h, kv, n, hd, lmax, t = 2, 4, 2, 6, 32, 48, 20
    q = _rand(rng, b, h, n, hd)
    (kp, kps), (vp, vps) = (_q(_rand(rng, b, kv, lmax, hd)) for _ in range(2))
    (kt, kts), (vt, vts) = (_q(_rand(rng, b, kv, t, hd)) for _ in range(2))
    mask = rng.random((b, n, t)) < 0.5
    mask[:, :, 0] = True
    plen = np.asarray([30, 7], np.int32)
    arrays = (q, kp, vp, kt, vt, mask, plen)
    scales = dict(k_scale=kps, v_scale=vps, kt_scale=kts, vt_scale=vts)
    want = jref.tree_attention_quant_ref(
        *map(jnp.asarray, arrays),
        **{k: jnp.asarray(v) for k, v in scales.items()})
    targs = tuple(map(torch.tensor, arrays))
    tscales = {k: torch.tensor(v) for k, v in scales.items()}
    _close(ops.tree_attention(*targs, **tscales), want)
    _close(ref.tree_attention_quant_ref(*targs, **tscales), want)


@pytest.mark.parametrize("window", [0, 9])
def test_decode_attention_int8_matches_quant_ref(window):
    rng = np.random.default_rng(30 + window)
    q = _rand(rng, 2, 4, 1, 32)
    (kq, ks), (vq, vs) = (_q(_rand(rng, 2, 2, 40, 32)) for _ in range(2))
    want = jref.decode_attention_quant_ref(
        *map(jnp.asarray, (q, kq, vq)), 33, k_scale=jnp.asarray(ks),
        v_scale=jnp.asarray(vs), window=window)
    args = tuple(map(torch.tensor, (q, kq, vq)))
    kw = dict(k_scale=torch.tensor(ks), v_scale=torch.tensor(vs),
              window=window)
    _close(ops.decode_attention(*args, 33, **kw), want)
    _close(ref.decode_attention_quant_ref(*args, 33, **kw), want)


def test_int8_prefill_attention_matches_round_trip():
    """Causal prefill over freshly quantized K/V == fp32 causal prefill
    over their quantize-dequantize round trip (what the reference's int8
    prefill attends)."""
    rng = np.random.default_rng(12)
    q = torch.tensor(_rand(rng, 1, 4, 10, 16))
    k, v = (torch.tensor(_rand(rng, 1, 2, 10, 16)) for _ in range(2))
    (kq, ks), (vq, vs) = quant.quantize_rows(k), quant.quantize_rows(v)
    got = ops.prefill_attention(q, kq, vq, torch.arange(10), k_scale=ks,
                                v_scale=vs)
    want = ops.prefill_attention(q, quant.dequantize_rows(kq, ks),
                                 quant.dequantize_rows(vq, vs),
                                 torch.arange(10))
    assert torch.equal(got, want)


def test_wrappers_check_int8_arguments():
    q = torch.zeros(1, 2, 3, 16)
    kq = torch.zeros(1, 2, 8, 16, dtype=torch.int8)
    s = torch.ones(1, 2, 8)
    with pytest.raises(RuntimeError, match="no dequant_matmul"):
        quant.dequant_matmul(torch.empty(2, 4, device="meta"),
                             torch.empty(4, 3, dtype=torch.int8,
                                         device="meta"),
                             torch.empty(3, device="meta"))
    with pytest.raises(ValueError, match="both"):
        flash.check_kv("flash", kq, kq, s, None)
    with pytest.raises(TypeError):
        flash.check_kv("flash", kq.float(), kq.float(), s, s)
    with pytest.raises(ValueError, match="scales"):
        flash.check_kv("flash", kq, kq, s[..., :4], s[..., :4])
    assert flash.check_kv("flash", kq, kq, s, s)
    assert not flash.check_kv("flash", kq.float(), kq.float(), None, None)
    o, _, _ = flash.flash_attention_lse(q, kq, kq, 8, k_scale=s, v_scale=s)
    assert (o == 0).all()


def test_plain_versions_count_no_launches():
    counters = (quant.dequant_matmul, flash.flash_attention_lse,
                tree_block.tree_block_attention)
    before = [(f.launches, getattr(f, "launches_int8", 0)) for f in counters]
    test_tree_attention_int8_matches_quant_ref()
    test_dequant_matmul_plain_matches_pallas(7, 33, 19)
    assert [(f.launches, getattr(f, "launches_int8", 0))
            for f in counters] == before


def test_k_split_depends_on_k_and_n_only():
    """The dequant-matmul kernel's split of K: whole BLOCK_K steps that
    cover K exactly, at least MIN_K_PER_SPLIT rows a split where K allows,
    at most ROWS_PER_SPLIT rows from a long K, more splits for narrow N,
    none for short K, and the same plan whatever M is (k_split takes no
    M)."""
    for k, n in ((8192, 8192), (8192, 1024), (8192, 28672), (28672, 8192),
                 (2048, 512), (33, 19), (300, 7)):
        splits, chunk = quant.k_split(k, n)
        assert chunk % quant.BLOCK_K == 0
        assert (splits - 1) * chunk < k <= splits * chunk
        assert splits == 1 or chunk >= quant.MIN_K_PER_SPLIT
        assert splits <= quant.MAX_SPLITS
    assert quant.k_split(8192, 1024)[0] > quant.k_split(8192, 28672)[0]
    # a long K range: splits of at most ROWS_PER_SPLIT rows (w_gate 8 of
    # 1024); a narrow shape splits further, up to SLOTS CTAs (w_q: 10)
    assert quant.k_split(8192, 28672) == (8, 1024)
    assert quant.k_split(8192, 8192) == (10, 832)
    for k, n in ((8192, 8192), (8192, 28672), (28672, 8192), (8192, 1024)):
        assert quant.k_split(k, n)[1] <= quant.ROWS_PER_SPLIT
    for k, n in ((2048, 2048), (2048, 8192), (8192, 2048)):
        splits, _ = quant.k_split(k, n)
        assert splits * -(-n // quant.BLOCK_N) <= quant.SLOTS
    assert quant.k_split(33, 19) == (1, 64)
    assert quant.k_split(300, 7) == (2, 192)
