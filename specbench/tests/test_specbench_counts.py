"""The count functions against hand counts at smoke size."""
import numpy as np
import pytest

from specbench.lib import counts
from specbench.tests import smoke

DENSE, MOE = smoke.config("qwen2"), smoke.config("qwen2_moe")


def test_dense_token_flops():
    # d 160, 5 heads of 32, 1 KV head, SwiGLU 448
    proj = 2 * 160 * (5 + 2) * 32 + 2 * 5 * 32 * 160
    assert counts.token_flops(DENSE) == proj + 6 * 160 * 448


def test_moe_token_flops_count_the_experts_a_token_reaches():
    # d 128, 4 heads of 32 (MHA), router over 4 experts, top-2 of width 88,
    # shared 176 with no gate (the file's departure)
    proj = 2 * 128 * (4 + 8) * 32 + 2 * 4 * 32 * 128
    want = proj + 2 * 128 * 4 + 2 * 6 * 128 * 88 + 6 * 128 * 176
    assert counts.token_flops(MOE) == want
    gated = {**MOE, "departures": {}}
    assert counts.token_flops(gated) == want + 2 * 128


def test_verify_counts_valid_nodes_of_pending_slots():
    # slot 0 pending with 10 committed rows: node 0 (root only), node 1
    # (root and itself), node 2 padded; slot 1 not pending
    masks = np.zeros((2, 3, 4), bool)
    masks[0, 0, 0] = True
    masks[0, 1, :2] = True
    masks[1, :, :2] = True
    got = counts.verify_flops(DENSE, np.array([10, 50]), masks,
                              np.array([True, False]))
    tf, hd, h, layers = counts.token_flops(DENSE), 32, 5, 2
    want = layers * (2 * tf + 4 * hd * h * (11 + 12)) + 2 * 2 * 160 * 512
    assert got == pytest.approx(want)


def test_prefill_counts_causal_scores_and_one_head_row():
    tf = counts.token_flops(DENSE)
    want = 2 * (4 * tf + 4 * 32 * 5 * (1 + 2 + 3 + 4)) + 2 * 160 * 512
    assert counts.prefill_flops(DENSE, 4) == pytest.approx(want)


def test_paged_flash_least_time():
    # B 2, H 4, n 8, hd 64, 2 KV heads, 3 table blocks, 100 and 20 rows
    q, kv = (2, 4, 8, 64), np.array([100, 20])
    nbytes = 4 * (2 * 4 * 8 * 64 + 120 * 2 * 2 * 64 + 2 * 3 + 2 + 2 * 8) \
        + 4 * (2 * 4 * 8 * 64 + 2 * 2 * 4 * 8)
    flops = 3 * 4 * 64 * 4 * 8 * 120
    assert counts.paged_flash_least_s(q, 2, 3, kv) == pytest.approx(
        max(nbytes / 3.35e12, flops / 495e12))


def test_paged_tree_least_time():
    q = (1, 2, 3, 32)
    mask = np.zeros((1, 3, 5), bool)
    mask[0, 0, 0] = mask[0, 1, :2] = mask[0, 2, [0, 2]] = True
    pairs, rows = 2 * 5, 3
    nbytes = 4 * (2 * 3 * 32 + rows * 1 * 2 * 32 + 2) + mask.size \
        + 4 * (2 * 3 * 32 + 2 * 2 * 3) + 4 * 2 * 3 * 32
    flops = 3 * 4 * 32 * pairs
    assert counts.paged_tree_least_s(q, 1, 2, mask, True) == pytest.approx(
        max(nbytes / 3.35e12, flops / 495e12))
