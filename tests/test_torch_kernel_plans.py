"""What the port's CUDA kernels promise about their plans and arithmetic,
checked on the CPU with their plain twins (no JAX; the kernels themselves
run only on a card, in ``test_torch_quant_cuda.py`` and
``test_torch_paged_cuda.py``).

* ``flash_attention_lse`` splits the key range into chunks
  (``flash.chunk_plan``): the plan covers every key a query tile may
  attend, is the same for the dense and the paged mode, and a row's plan
  does not change with B or with other rows' ``kv_len``.  Merging per-chunk
  (acc, m, l) in chunk order (``flash.merge_chunks``, the last CTA's
  arithmetic) equals the plain version within 1e-6, fully masked chunks
  and rows included.
* ``dequant_matmul`` runs its products on the tensor cores: every int8
  value is exact in bf16 and in TF32, x splits exactly into bf16 terms
  (``quant.split_bf16``), and an emulation of the split product, in the
  kernel's order, meets ``dequant_matmul_plain`` within the card's
  tolerance, 1e-4.  The K plan takes K and N only.
"""
import inspect

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash, paged, quant

MERGE_ATOL = 1e-6


def _flash_inputs(rng, b, h, kvh, n, hd, length):
    q = torch.from_numpy(rng.normal(size=(b, h, n, hd)).astype(np.float32))
    k, v = (torch.from_numpy(rng.normal(size=(b, kvh, length, hd)).astype(
        np.float32)) for _ in range(2))
    return q, k, v


@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("causal,window", [(False, 0), (True, 0),
                                           (False, 40)])
def test_chunk_plan_covers_every_attended_key(hd, causal, window):
    """Chunks outside a tile's [c_lo, c_hi) hold no key any of its rows
    may attend, so the CTAs that exit at once skip nothing."""
    b, n, rep, length = 3, 24, 4, 600
    kv_len = torch.tensor([0, 130, 600], dtype=torch.int32)
    qpos = (torch.tensor([0, 100, 500])[:, None]
            + torch.arange(n)).to(torch.int32)
    valid = flash.valid_mask(b, n, length, kv_len, qpos, causal, window,
                             "cpu")
    plan = flash.chunk_plan(hd, length, kv_len, qpos, n, rep, causal=causal,
                            window=window)
    c, bq = flash.chunk_keys(hd), flash.queries_per_cta(rep)
    for row in range(b):
        assert len(plan[row]) == -(-n // bq)
        for i, (c_lo, c_hi) in enumerate(plan[row]):
            assert 0 <= c_lo < c_hi <= max(1, -(-length // c))
            tile = valid[row, i * bq:(i + 1) * bq]
            keys = tile.any(0).nonzero().flatten()
            if len(keys):
                assert c_lo * c <= int(keys.min())
                assert int(keys.max()) < c_hi * c


def test_chunk_plan_is_per_row_and_shared_by_paged():
    """A row's plan is the same alone as inside a batch of other rows
    with other bounds, and the paged wrapper sizes and plans with the same
    functions as the dense one (L = blocks * page)."""
    n, rep, hd, length = 8, 8, 128, 512
    kv_len = [90, 200, 130]
    qpos = [[k - 1 + i // 2 for i in range(n)] for k in kv_len]
    full = flash.chunk_plan(hd, length, kv_len, qpos, n, rep)
    for row in range(3):
        alone = flash.chunk_plan(hd, length, kv_len[row:row + 1],
                                 qpos[row:row + 1], n, rep)
        assert alone[0] == full[row]
        other = [7, kv_len[row], 512]
        assert flash.chunk_plan(hd, length, other, [qpos[0], qpos[row],
                                                    qpos[2]], n,
                                rep)[1] == full[row]
    # the main case: 200 keys in chunks of 64 keys for hd 128
    assert full[1] == [(0, 4)]
    assert paged.flash is flash
    src = inspect.getsource(paged._launch_flash)
    assert "flash.scratch_for" in src and "flash.queries_per_cta" in src


def _chunk_partial(qs, k, v, valid):
    """Per-chunk (acc, m, l) over the keys of ``k``/``v``: masked scores
    -1e30, m from -1e30, p zeroed where masked, acc unnormalised."""
    s = torch.einsum("bgrnd,bgld->bgrnl", qs, k)
    s = torch.where(valid, s, torch.full((), flash.NEG_INF))
    m = torch.maximum(s.amax(-1), torch.full((), flash.NEG_INF))
    p = torch.where(valid, torch.exp(s - m[..., None]), torch.zeros(()))
    return torch.einsum("bgrnl,bgld->bgrnd", p, v), m, p.sum(-1)


@pytest.mark.parametrize("hd,causal,window", [(128, False, 0),
                                              (64, False, 0),
                                              (256, False, 0),
                                              (256, True, 0),
                                              (128, True, 0),
                                              (128, False, 50)])
def test_merging_chunks_in_order_equals_plain(hd, causal, window):
    rng = np.random.default_rng(hd + 3 * causal + window)
    b, h, kvh, n, length = 4, 16, 4, 6, 300
    rep = h // kvh
    q, k, v = _flash_inputs(rng, b, h, kvh, n, hd, length)
    kv_len = torch.tensor([200, 37, 300, 0], dtype=torch.int32)
    qpos = ((kv_len.long() - 1).clamp_min(0)[:, None]
            + torch.arange(n) // 2).to(torch.int32)
    scale = hd ** -0.5
    want = flash.flash_attention_lse_plain(q, k, v, kv_len, qpos,
                                           scale=scale, causal=causal,
                                           window=window)
    valid = flash.valid_mask(b, n, length, kv_len, qpos, causal, window,
                             "cpu")[:, None, None]
    qs = (q * scale).reshape(b, kvh, rep, n, hd)
    c = flash.chunk_keys(hd)
    parts = [_chunk_partial(qs, k[:, :, c0:c0 + c], v[:, :, c0:c0 + c],
                            valid[..., c0:c0 + c])
             for c0 in range(0, length, c)]
    assert len(parts) > 2
    # the first chunk of row 1 (37 keys) is its only one; row 3 has none
    o, m, l = flash.merge_chunks(parts)
    for got, ref in zip((o.reshape(b, h, n, hd), m.reshape(b, h, n),
                         l.reshape(b, h, n)), want):
        torch.testing.assert_close(got, ref, rtol=MERGE_ATOL,
                                   atol=MERGE_ATOL)
    assert (m.reshape(b, h, n)[3] == flash.NEG_INF).all()
    assert (o.reshape(b, h, n, hd)[3] == 0).all()
    assert (l.reshape(b, h, n)[3] == 0).all()
    # merging only the plan's chunks changes no bit (a chunk with no valid
    # key adds exactly nothing)
    plan = flash.chunk_plan(hd, length, kv_len, qpos, n, rep, causal=causal,
                            window=window)
    bq = flash.queries_per_cta(rep)
    for row in range(b):
        for i, (c_lo, c_hi) in enumerate(plan[row]):
            sl = (slice(row, row + 1), slice(None), slice(None),
                  slice(i * bq, (i + 1) * bq))
            some = flash.merge_chunks([tuple(x[sl] for x in parts[j])
                                       for j in range(c_lo, c_hi)])
            every = flash.merge_chunks([tuple(x[sl] for x in p)
                                        for p in parts])
            for a, e in zip(some, every):
                assert torch.equal(a, e)


def test_int8_values_are_exact_in_bf16_and_tf32():
    """All 256 byte values: the kernel's byte-permute conversion (bits
    0x4B000000 | (b ^ 0x80), less 2^23 + 128) gives the exact integer, its
    upper 16 bits are that integer in bf16, and TF32 rounding keeps it."""
    b = torch.arange(-128, 128, dtype=torch.int32)
    bits = 0x4B000000 | ((b & 0xFF) ^ 0x80)
    f = bits.view(torch.float32) - 8388736.0
    assert torch.equal(f, b.float())
    fb = f.view(torch.int32)
    assert ((fb & 0xFFFF) == 0).all()
    assert torch.equal(f.to(torch.bfloat16).float(), b.float())
    # TF32: round to nearest (away) at mantissa bit 13
    tf = ((fb + 0x1000) & -8192).view(torch.float32)
    assert torch.equal(tf, b.float())
    assert torch.equal(b.to(torch.int8).float(), b.float())


def _edge_values():
    f32 = np.finfo(np.float32)
    vals = [0.0, -0.0, 1.0, -1.0, f32.max, -f32.max, f32.tiny, -f32.tiny,
            1e-30, -1e-25, 3.0e38, 1.0000001, 65504.0, 2.0 ** -100,
            np.nextafter(np.float32(1), np.float32(2))]
    return torch.tensor(np.array(vals, np.float32))


def test_x_split_reconstructs_x_exactly():
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.normal(size=4096) * 10.0 ** rng.integers(
        -20, 20, size=4096)).astype(np.float32))
    for vals in (x, _edge_values()):
        terms = quant.split_bf16(vals)
        assert all(t.dtype == torch.bfloat16 for t in terms)
        assert all(torch.isfinite(t).all() for t in terms)
        back = sum(t.double() for t in terms)
        big = vals.abs() >= 2.0 ** -100
        assert torch.equal(back[big], vals.double()[big])
        # below that, the last term may fall under bf16's subnormals
        assert ((back - vals.double()).abs() <= 2.0 ** -126).all()
    # negative zero splits into zeros
    assert all(float(t) == 0.0 for t in quant.split_bf16(torch.tensor(-0.0)))


def _emulate_dequant_matmul(x, q8, scale, passes=quant.PASSES):
    """The kernel's arithmetic on the CPU: per K split (``k_split``), per
    16-row k step, the bf16 terms of x from the last to the first, each a
    16-term product sum of exact products added to the fp32 accumulator;
    then the splits in order and the scale."""
    m, k = x.shape
    n = q8.shape[1]
    splits, chunk = quant.k_split(k, n)
    terms = [t.float() for t in quant.split_bf16(x, passes)]
    w = q8.double()
    total = None
    for z in range(splits):
        acc = torch.zeros(m, n, dtype=torch.float32)
        for k0 in range(z * chunk, min(k, (z + 1) * chunk), 16):
            ws = w[k0:k0 + 16]
            for t in reversed(terms):
                acc = acc + (t[:, k0:k0 + 16].double() @ ws).float()
        total = acc if total is None else total + acc
    return total * scale


@pytest.mark.parametrize("m,k,n", [(8, 1024, 96), (1, 300, 19),
                                   (13, 2048, 40)])
def test_split_product_emulation_matches_plain(m, k, n):
    rng = np.random.default_rng(m + k + n)
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(k, n)) / k ** 0.5).astype(
        np.float32))
    q8, scale = quant.quantize_weight(w, 1)
    want = quant.dequant_matmul_plain(x, q8, scale)
    got = _emulate_dequant_matmul(x, q8, scale)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
    # fewer terms: two carry 16 bits of x, one 8
    err2 = float((_emulate_dequant_matmul(x, q8, scale, 2) - want).abs()
                 .max())
    err1 = float((_emulate_dequant_matmul(x, q8, scale, 1) - want).abs()
                 .max())
    assert float((got - want).abs().max()) <= err2 <= err1


def test_k_plan_takes_k_and_n_only():
    """The K split, hence every element's order of summation, comes from K
    and N: k_split takes nothing else, and the wrapper calls it with
    nothing else; an emulated row equals itself computed alone."""
    assert list(inspect.signature(quant.k_split).parameters) == ["k", "n"]
    assert "k_split(k, n)" in inspect.getsource(quant._launch)
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(8, 640)).astype(np.float32))
    q8, scale = quant.quantize_weight(torch.from_numpy(
        rng.normal(size=(640, 24)).astype(np.float32)), 1)
    full = _emulate_dequant_matmul(x, q8, scale)
    for i in (0, 7):
        assert torch.equal(_emulate_dequant_matmul(x[i:i + 1], q8, scale)[0],
                           full[i])
