"""The flash kernel's plan for long key spans, checked on the CPU with its
plain mirrors (no JAX; the kernel itself runs only on a card, in
``test_torch_flash_long_cuda.py``).

* A grid row of the kernel holds ``flash.grid_x`` CTAs, at most
  ``max(G, flash.cta_cap(...))`` whatever the cache length, one a chunk up
  to one group of chunks; ``flash.cta_slots`` gives every chunk of every
  tile's ``[c_lo, c_hi)`` to exactly one CTA.
* ``flash.merge_groups`` (the kernel's two-level merge in absolute groups
  of ``flash.group_chunks`` chunks) equals ``flash.merge_chunks`` bit for
  bit when a tile's chunks lie in one group, and the plain version within
  1e-6 when they straddle groups, fully masked chunks and rows included.
  Its result is the same whichever CTA computed a chunk, and a tile that
  starts at its window's first chunk gives the bits of one that starts at
  chunk 0 with leading empty chunks; a row of a chunked causal prefill
  gives the bits of the same row in a one-shot prefill.
* ``flash.scratch_sizes`` strides the partials by the tile's own rows: a
  long_500k decode's scratch is under 256 MB.
"""
import inspect
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import build, flash, paged

MERGE_ATOL = 1e-6
SOURCE = (Path(flash.__file__).resolve().parents[1] / "csrc"
          / "flash_attention_lse.cu")

torch.set_num_threads(1)


def _inputs(rng, b, h, kvh, n, hd, length):
    q = torch.from_numpy(rng.normal(size=(b, h, n, hd)).astype(np.float32))
    k, v = (torch.from_numpy(rng.normal(size=(b, kvh, length, hd)).astype(
        np.float32)) for _ in range(2))
    return q, k, v


def _chunk_partial(qs, k, v, valid):
    """Per-chunk (acc, m, l) over the keys of ``k``/``v``: masked scores
    -1e30, m from -1e30, p zeroed where masked, acc unnormalised."""
    s = torch.einsum("bgrnd,bgld->bgrnl", qs, k)
    s = torch.where(valid, s, torch.full((), flash.NEG_INF))
    m = torch.maximum(s.amax(-1), torch.full((), flash.NEG_INF))
    p = torch.where(valid, torch.exp(s - m[..., None]), torch.zeros(()))
    return torch.einsum("bgrnl,bgld->bgrnd", p, v), m, p.sum(-1)


def _partials(q, k, v, kv_len, qpos, *, causal, window):
    """Every chunk's partial of every (row, query) as the kernel's chunk
    CTAs compute them, and the plain version's (o, m, l)."""
    b, h, n, hd = q.shape
    kvh, length = k.shape[1], k.shape[2]
    scale = hd ** -0.5
    valid = flash.valid_mask(b, n, length, kv_len, qpos, causal, window,
                             "cpu")[:, None, None]
    qs = (q * scale).reshape(b, kvh, h // kvh, n, hd)
    c = flash.chunk_keys(hd)
    parts = [_chunk_partial(qs, k[:, :, c0:c0 + c], v[:, :, c0:c0 + c],
                            valid[..., c0:c0 + c])
             for c0 in range(0, length, c)]
    want = flash.flash_attention_lse_plain(q, k, v, kv_len, qpos,
                                           scale=scale, causal=causal,
                                           window=window)
    return parts, want


def _tile(parts, row, q0, bq, chunks):
    """The partials of the given chunks for one tile (batch row ``row``,
    queries q0 .. q0 + bq)."""
    sl = (slice(row, row + 1), slice(None), slice(None), slice(q0, q0 + bq))
    return [tuple(x[sl] for x in parts[j]) for j in chunks]


@pytest.mark.parametrize("gx", [1, 3, 7, 64, 66, 200])
@pytest.mark.parametrize("b,n,rep,causal,window", [
    (1, 1, 5, False, 4096), (2, 1, 5, False, 0), (3, 24, 4, True, 0),
    (2, 40, 8, False, 700), (1, 64, 16, True, 2048)])
def test_cta_slots_give_every_chunk_to_one_cta(gx, b, n, rep, causal,
                                               window):
    hd, length = 128, 20000
    kv_len = [length, 9000, 130][:b]
    qpos = [[k - n + i for i in range(n)] for k in kv_len]
    plan = flash.chunk_plan(hd, length, kv_len, qpos, n, rep, causal=causal,
                            window=window)
    slots = flash.cta_slots(plan, gx)
    assert len(slots) == b
    for tiles, ctas in zip(plan, slots):
        assert len(ctas) == len(tiles)
        for (c_lo, c_hi), per_cta in zip(tiles, ctas):
            assert len(per_cta) == gx
            got = sorted(c for chunks in per_cta for c in chunks)
            assert got == list(range(c_lo, c_hi))
            for x, chunks in enumerate(per_cta):
                assert all((c - c_lo) % gx == x for c in chunks)


@pytest.mark.parametrize("hd", [64, 128, 256])
def test_grid_is_bounded_by_the_card_not_by_the_length(hd):
    """Up to one group of keys every chunk has a CTA (the grid of the
    single-level plan); past it a grid row holds max(G, cap) CTAs
    whatever the length."""
    g = flash.group_chunks(hd)
    c = flash.chunk_keys(hd)
    for tiles, per_sm in ((8, 2), (64, 2), (1, 1), (528, 1), (192, 4)):
        cap = flash.cta_cap(tiles, per_sm, 132)
        assert cap == max(1, 2 * per_sm * 132 // tiles)
        for length in (1, c, 5 * c + 1, g * c):
            assert flash.grid_x(hd, length, tiles, per_sm, 132) == max(
                1, -(-length // c))
        for length in (g * c + 1, 32768, 524288, 4 << 20):
            gx = flash.grid_x(hd, length, tiles, per_sm, 132)
            assert gx == min(-(-length // c), max(g, cap))
            assert gx <= max(g, cap)
    # long_500k's decode: 8 tiles on 132 SMs, one CTA an SM (or two)
    assert flash.grid_x(128, 524288, 8, 1, 132) == 64
    assert flash.grid_x(128, 524288, 8, 2, 132) == 66
    # decode_32k's span at batch 8: 64 tiles
    assert flash.grid_x(128, 32768, 64, 1, 132) == 64


def _source_constant(name):
    found = re.findall(rf"constexpr int {name} = (\d+);", SOURCE.read_text())
    assert len(found) == 1, name
    return int(found[0])


def test_group_chunks_depend_on_head_dim_and_dtype_alone():
    assert list(inspect.signature(flash.group_chunks).parameters) == [
        "hd", "int8"]
    assert _source_constant("kGroupKeys") == flash.GROUP_KEYS == 4096
    assert _source_constant("kWaves") == flash.WAVES
    for hd in range(1, flash.MAX_HEAD_DIM + 1):
        g = flash.group_chunks(hd, False)
        assert g == flash.group_chunks(hd, True)
        assert g * flash.chunk_keys(hd) == flash.GROUP_KEYS
    assert [flash.group_chunks(hd) for hd in (64, 128, 256)] == [32, 64, 64]


@pytest.mark.parametrize("hd,causal,window", [(128, False, 0),
                                              (64, False, 0),
                                              (256, True, 0),
                                              (128, False, 50)])
def test_merge_groups_within_one_group_is_merge_chunks(hd, causal, window):
    rng = np.random.default_rng(hd + 5 * causal + window)
    b, h, kvh, n, length = 3, 16, 4, 6, 300
    q, k, v = _inputs(rng, b, h, kvh, n, hd, length)
    kv_len = torch.tensor([200, 37, 0], dtype=torch.int32)
    qpos = ((kv_len.long() - 1).clamp_min(0)[:, None]
            + torch.arange(n) // 2).to(torch.int32)
    parts, _ = _partials(q, k, v, kv_len, qpos, causal=causal,
                         window=window)
    plan = flash.chunk_plan(hd, length, kv_len, qpos, n, h // kvh,
                            causal=causal, window=window)
    bq = flash.queries_per_cta(h // kvh)
    g = flash.group_chunks(hd)
    for row in range(b):
        for i, (c_lo, c_hi) in enumerate(plan[row]):
            tile = _tile(parts, row, i * bq, bq, range(c_lo, c_hi))
            for got, want in zip(flash.merge_groups(tile, c_lo, g),
                                 flash.merge_chunks(tile)):
                assert torch.equal(got, want)


@pytest.mark.parametrize("hd,g,causal,window", [
    (128, 3, False, 0), (128, 2, True, 0), (64, 4, False, 300),
    (256, 3, False, 0), (64, 32, False, 1000), (64, 32, True, 0)])
def test_merge_groups_across_groups_matches_plain(hd, g, causal, window):
    """Chunk partials merged per group, then the groups in order, equal
    the plain version within 1e-6; a row with no valid key (kv_len 0) and
    fully masked chunks (causal, window) add nothing.  The G = 32 cases
    are hd 64's own groups over 4736 keys (two groups)."""
    rng = np.random.default_rng(hd + g + window)
    b, h, kvh, n = 3, 8, 2, 4
    length = 4736 if g == 32 else 700
    q, k, v = _inputs(rng, b, h, kvh, n, hd, length)
    kv_len = torch.tensor([length, 0, length - 9], dtype=torch.int32)
    qpos = ((kv_len.long() - 1).clamp_min(0)[:, None]
            + torch.arange(n) - n).clamp_min(0).to(torch.int32)
    parts, want = _partials(q, k, v, kv_len, qpos, causal=causal,
                            window=window)
    # every row's tile: its plan's chunks, straddling groups
    plan = flash.chunk_plan(hd, length, kv_len, qpos, n, h // kvh,
                            causal=causal, window=window)
    straddled = False
    for row in range(b):
        (c_lo, c_hi), = plan[row]
        straddled |= c_lo // g != (c_hi - 1) // g
        o, m, l = flash.merge_groups(
            _tile(parts, row, 0, n, range(c_lo, c_hi)), c_lo, g)
        for got, ref in zip((o.reshape(1, h, n, hd), m.reshape(1, h, n),
                             l.reshape(1, h, n)),
                            (x[row:row + 1] for x in want)):
            torch.testing.assert_close(got, ref, rtol=MERGE_ATOL,
                                       atol=MERGE_ATOL)
        if row == 1:
            assert (m == flash.NEG_INF).all() and (o == 0).all()
            assert (l == 0).all()
    assert straddled


def test_merge_groups_same_whatever_the_cap_and_the_start():
    """The partials of a tile assembled from the CTAs of grid rows of
    several widths merge to the same bits, and a tile starting at its
    window's first chunk gives the bits of one starting at chunk 0 with
    leading empty chunks (the window-only paged decode against the full
    decode)."""
    rng = np.random.default_rng(7)
    hd, g = 64, 4
    b, h, kvh, n, length = 1, 8, 2, 1, 2500
    q, k, v = _inputs(rng, b, h, kvh, n, hd, length)
    kv_len = torch.tensor([length], dtype=torch.int32)
    qpos = torch.tensor([[length - 1]], dtype=torch.int32)
    for window in (900, 1100, 0):
        parts, _ = _partials(q, k, v, kv_len, qpos, causal=False,
                             window=window)
        (c_lo, c_hi), = flash.chunk_plan(hd, length, kv_len, qpos, n,
                                         h // kvh, window=window)[0]
        ref = flash.merge_groups(_tile(parts, 0, 0, n, range(c_lo, c_hi)),
                                 c_lo, g)
        for gx in (1, 2, 5, 64):
            done = {}
            for chunks in flash.cta_slots([[(c_lo, c_hi)]], gx)[0][0]:
                for c in chunks:
                    done[c] = _tile(parts, 0, 0, n, [c])[0]
            got = flash.merge_groups([done[c] for c in sorted(done)], c_lo,
                                     g)
            assert all(torch.equal(a, e) for a, e in zip(got, ref))
        from_zero = flash.merge_groups(_tile(parts, 0, 0, n, range(c_hi)),
                                       0, g)
        assert all(torch.equal(a, e) for a, e in zip(from_zero, ref))
        if window:
            assert c_lo > g     # leading empty groups, not only chunks


def test_chunked_prefill_rows_equal_one_shot_across_groups():
    """A causal prefill's query tiles differ between one shot and 48-query
    chunks, but each row's merged result is the same bits: the chunks and
    groups a tile adds past a row's own keys are empty for that row."""
    rng = np.random.default_rng(11)
    hd, g = 64, 2
    b, h, kvh, n = 1, 4, 4, 320         # 3 chunks of 128 keys, 2 groups
    length = n
    q, k, v = _inputs(rng, b, h, kvh, n, hd, length)
    kv_len = torch.tensor([length], dtype=torch.int32)
    qpos = torch.arange(n, dtype=torch.int32)[None]
    parts, _ = _partials(q, k, v, kv_len, qpos, causal=True, window=0)
    rep = h // kvh
    c = flash.chunk_keys(hd)

    def rows_of(q_first, q_last):
        """Merged rows of tiles of at most 64 // rep queries over the
        queries [q_first, q_last), each tile's plan its own."""
        bq = flash.queries_per_cta(rep)
        out = {}
        for q0 in range(q_first, q_last, bq):
            q1 = min(q0 + bq, q_last)
            c_hi = -(-(q1) // c)
            tile = [tuple(x[:, :, :, q0:q1] for x in parts[j])
                    for j in range(c_hi)]
            o, m, l = flash.merge_groups(tile, 0, g)
            for i in range(q1 - q0):
                out[q0 + i] = (o[..., i, :], m[..., i], l[..., i])
        return out
    one = rows_of(0, n)
    chunked = {}
    for q0 in range(0, n, 48):
        chunked.update(rows_of(q0, min(q0 + 48, n)))
    for i in range(n):
        assert all(torch.equal(a, e) for a, e in zip(chunked[i], one[i]))


def test_scratch_is_strided_by_the_tile_rows(monkeypatch):
    """long_500k's decode (524,288 rows, hd 128, 8 KV heads, 5 query heads
    each, n = 1) takes under 256 MB of scratch; decode_32k's span at batch
    8 under 100 MB.  The paged wrapper sizes with the same function."""
    asked = []

    def fake(name, device, floats, ints):
        asked.append((name, floats, ints))
        return torch.empty(1), torch.zeros(1, dtype=torch.int32)
    monkeypatch.setattr(build, "scratch", fake)
    flash.scratch_for(torch.device("cpu"), 1, 8, 1, 5, 524288, 128)
    (name, floats, ints), = asked
    assert name == "flash_attention_lse"
    # 8 tiles x (8192 chunks + 128 groups) x 5 rows x 130 floats, padded
    assert (floats, ints) == (8 * (8192 + 128) * 652, 8 * 129)
    assert 4 * (floats + ints) < 256 * 2**20
    assert (floats, ints) == flash.scratch_sizes(1, 8, 1, 5, 524288, 128)
    floats, ints = flash.scratch_sizes(8, 8, 1, 5, 32768, 128)
    assert floats == 64 * (512 + 8) * 652 and ints == 64 * 9
    assert 4 * (floats + ints) < 100 * 2**20
    # a full tile of 64 rows keeps the 64-row stride, padded to 16 bytes
    floats, _ = flash.scratch_sizes(1, 8, 8, 8, 512, 128)
    assert floats == 8 * (8 + 1) * 64 * 130
    floats, _ = flash.scratch_sizes(1, 8, 8, 8, 512, 63)
    assert floats == 8 * (4 + 1) * 64 * 65
    # one chunk: no scratch
    assert flash.scratch_sizes(1, 8, 8, 8, 64, 128) == (0, 0)
    assert flash.scratch_for(torch.device("cpu"), 1, 8, 8, 8, 64,
                             128) == (None, None)
    src = inspect.getsource(paged._launch_flash)
    assert "flash.scratch_for" in src
