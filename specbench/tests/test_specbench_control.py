"""The check's control: the reference with TF32 products put in the
program's place (its argmax as the served tokens, its logits as the
program's) must fail the configuration's limits through the same
``compare``, ``numbers`` and ``judge``, while a program that serves the
reference's own float32 argmax and logits passes them.  On the CPU the
products' operands are rounded to TF32; on the card (``cuda_kernel``) TF32
runs as it is, at the configurations' published widths cut to two layers."""
import numpy as np
import pytest
import torch

from specbench.lib import check, serve, weights
from specbench.tests import smoke


def readings(cfg: dict, seqs: int, length: int, device) -> tuple:
    """(the program's compared numbers, the control's) over ``seqs`` seeded
    sequences, the second half of each served."""
    ref, _ = weights.family(cfg)
    w = weights.make(ref.weight_spec(cfg), 2 ** 31 + 41, device)
    ids = serve.logit_ids(2 ** 31 + 41, cfg["vocab_size"], device)
    limits = check.limits_of(cfg)
    sides = {"program": ([], []), "control": ([], [])}
    for s in range(seqs):
        toks = torch.as_tensor(np.random.default_rng(s).integers(
            0, cfg["vocab_size"], length), device=device)
        with torch.no_grad():
            full = ref.logits(w, cfg, toks)[length // 2 - 1:-1]
            with check.precision("tf32", device):
                low = ref.logits(w, cfg, toks)[length // 2 - 1:-1]
        for side, got in (("program", full), ("control", low)):
            gap, dist = check.compare(full, ids, got.index_select(1, ids),
                                      got.argmax(1).cpu().numpy())
            sides[side][0].append(gap)
            sides[side][1].append(dist.cpu())
    n = seqs * (length - length // 2)
    return tuple(check.numbers(g, d, limits, n) for g, d in sides.values())


def test_compare_reads_the_gap_and_the_distance():
    ref = torch.tensor([[1.0, 0.9, 0.0, 0.3], [0.2, 0.5, 0.4, -0.1]])
    ids = torch.tensor([0, 2])
    got = ref.index_select(1, ids) + torch.tensor([[0.0, 0.1], [0.0, 0.0]])
    gap, dist = check.compare(ref, ids, got, np.array([1, 1]))
    assert gap == pytest.approx(0.1)
    assert dist[0] == pytest.approx(0.1 / (0.5 ** 0.5))
    assert dist[1] == 0.0


def test_judge_holds_every_number_to_its_limit():
    limits = {"max_logit_gap": 0.1, "logit_dist": 1e-3}
    d = [torch.tensor([1e-4, 2e-4, 5e-3])]
    ok = check.numbers([0.05], d, limits, 64)
    assert "logit_dist_median" in ok and check.judge(ok)
    assert not check.judge(check.numbers([0.2], d, limits, 64))
    assert not check.judge(check.numbers([0.05], d, limits, 63))
    far = [torch.tensor([2e-3, 2e-3, 0.0])]
    assert not check.judge(check.numbers([0.05], far, limits, 64))


def test_tf32_rounding_moves_products():
    a = torch.randn(64, 64, generator=torch.Generator().manual_seed(0))
    with check.precision("tf32", torch.device("cpu")):
        low = a @ a
    assert 0 < float((low - a @ a).abs().max()) < 1e-2
    assert torch.equal(check.tf32_round(check.tf32_round(a)),
                       check.tf32_round(a))


# test sizes: the configuration's head size and ratios at a width and depth
# a CPU holds, with enough positions that the control meets near ties
TEST_SIZES = {
    "qwen2": (dict(name="qwen2.5-32b-l8", hidden_size=1536,
                   num_attention_heads=12, num_key_value_heads=2,
                   intermediate_size=8288, vocab_size=16384,
                   num_hidden_layers=2), 12),
    "qwen2_moe": (dict(name="qwen1.5-moe-a2.7b-l8", hidden_size=512,
                       num_attention_heads=4, num_key_value_heads=4,
                       moe_intermediate_size=352,
                       shared_expert_intermediate_size=1408, num_experts=16,
                       num_experts_per_tok=4, vocab_size=8192,
                       num_hidden_layers=2), 6),
}


@pytest.mark.parametrize("kind", sorted(TEST_SIZES))
def test_control_fails_the_limit_at_test_size(kind):
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        size, seqs = TEST_SIZES[kind]
        cfg = {**smoke.config(kind), **size}
        prog, ctrl = readings(cfg, seqs, 512, torch.device("cpu"))
    finally:
        torch.set_num_threads(n)
    assert check.judge(prog) and not check.judge(ctrl), (prog, ctrl)


@pytest.mark.cuda_kernel
@pytest.mark.parametrize("name", ["qwen2.5-32b-l8", "qwen1.5-moe-a2.7b-l8"])
def test_control_fails_the_limit_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: TF32 runs only there")
    import json
    from specbench.lib import bench
    cfg = json.loads((bench.HERE / "configs" / f"{name}.json").read_text())
    cfg["num_hidden_layers"] = 2
    prog, ctrl = readings(cfg, 4, 512, torch.device("cuda"))
    assert check.judge(prog) and not check.judge(ctrl), (prog, ctrl)
