"""The int8 CUDA kernels of the port against their plain versions, on a
card: the dequant-matmul (including its M-independence: a row gives the
same bits alone as inside a larger M) and the int8 modes of the two
attention kernels, at the main path's shapes.  Every test here is marked
``cuda_kernel`` and skips on a host without a card.  The file imports no
JAX, so it runs on a machine that has only the port's dependencies:

    PYTHONPATH=src python -m pytest -q tests/test_torch_quant_cuda.py

Tolerances: the dequant-matmul within 1e-4 of the plain version (outputs
of size about 1 here, fp32 sums in another order than cuBLAS's); the
attention kernels as their fp32 modes (o 1e-4 absolute, 1e-5 relative),
since a row is dequantized with the same single rounding in both.
"""
import pytest
import torch

from repro_torch.kernels import flash, quant, tree_block


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU "
                    "mode; test_torch_quant_ops.py holds their plain "
                    "versions to the JAX package)")
    return torch.device("cuda")


@pytest.mark.cuda_kernel
@pytest.mark.parametrize("m,k,n", [(8, 8192, 1024), (1, 2048, 512),
                                   (5, 300, 19), (130, 96, 200)])
def test_dequant_matmul_kernel_matches_plain_on_card(cuda, m, k, n):
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(m, k, generator=gen, device=cuda)
    q8, scale = quant.quantize_weight(
        torch.randn(k, n, generator=gen, device=cuda) / k ** 0.5, 1)
    got = quant.dequant_matmul(x, q8, scale)
    torch.testing.assert_close(got, quant.dequant_matmul_plain(x, q8, scale),
                               rtol=1e-4, atol=1e-4)
    # a row gives the same bits whatever M is
    for i in {0, m - 1}:
        assert torch.equal(quant.dequant_matmul(x[i:i + 1], q8, scale)[0],
                           got[i])


@pytest.mark.cuda_kernel
def test_flash_int8_kernel_matches_plain_on_card(cuda):
    gen = torch.Generator(device=cuda).manual_seed(1)
    q = torch.randn(1, 64, 8, 128, generator=gen, device=cuda)
    (kq, ks), (vq, vs) = (quant.quantize_rows(torch.randn(
        1, 512, 8, 128, generator=gen, device=cuda)) for _ in range(2))
    kv = torch.tensor([200], dtype=torch.int32, device=cuda)
    qpos = torch.full((1, 8), 199, dtype=torch.int32, device=cuda)
    args = (q, kq.transpose(1, 2), vq.transpose(1, 2), kv, qpos)
    kw = dict(k_scale=ks.transpose(1, 2), v_scale=vs.transpose(1, 2))
    got = flash.flash_attention_lse(*args, **kw)
    want = flash.flash_attention_lse_plain(*args, scale=128 ** -0.5, **kw)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-4)


@pytest.mark.cuda_kernel
def test_tree_int8_kernel_matches_plain_on_card(cuda):
    gen = torch.Generator(device=cuda).manual_seed(2)
    q = torch.randn(1, 64, 8, 128, generator=gen, device=cuda)
    (kq, ks), (vq, vs) = (quant.quantize_rows(torch.randn(
        1, 105, 8, 128, generator=gen, device=cuda)) for _ in range(2))
    mask = torch.rand(1, 8, 105, generator=gen, device=cuda) < 0.3
    args = (q, kq.transpose(1, 2), vq.transpose(1, 2), mask)
    kw = dict(k_scale=ks.transpose(1, 2), v_scale=vs.transpose(1, 2))
    got = tree_block.tree_block_attention(*args, **kw)
    want = tree_block.tree_block_attention_plain(*args, scale=128 ** -0.5,
                                                 **kw)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-4)


@pytest.mark.cuda_kernel
def test_quantization_on_card_equals_cpu(cuda):
    """Weights and K/V rows quantize to the same int8 values and scales on
    the card as on the CPU (true division by 127 on both)."""
    gen = torch.Generator().manual_seed(3)
    w = torch.randn(512, 8, 64, generator=gen) / 23
    for got, want in ((quant.quantize_weight(w.to(cuda), 1),
                       quant.quantize_weight(w, 1)),
                      (quant.quantize_rows(w.to(cuda)),
                       quant.quantize_rows(w))):
        for g, c in zip(got, want):
            assert torch.equal(g.cpu(), c)
