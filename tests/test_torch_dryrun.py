"""The port's dry run (``python -m repro_torch.launch.dryrun``): the CLI for
one arch of each family at one shape on both production meshes (rows,
exit code, the window override at long_500k), the ring's tick on meta,
the meta pass's product count against the same step on real CPU tensors
at smoke width (exactly equal: ``FlopCounterMode`` counts from shapes),
and MoE routing on meta (``moe.expert_counts`` equal to
``torch.bincount``).  No JAX: nothing here has a reference counterpart
to run (the reference lowers with XLA on 512 fake devices).
"""
import json

import numpy as np
import pytest
import torch

from repro_torch import configs as reg
from repro_torch.launch import dryrun, specs
from repro_torch.launch.specs import InputShape
from repro_torch.models import moe
from repro_torch.models import transformer as tf
from repro_torch.models.layers import trainable

# one (arch, shape) per family: dense (the window override), MoE (train,
# on meta), MLA, VLM, audio (the encoder under autograd), SSM, hybrid
FAMILY_RUNS = (("qwen2.5-32b", "long_500k"), ("qwen2-moe-a2.7b", "train_4k"),
               ("deepseek-v2-236b", "decode_32k"),
               ("internvl2-26b", "prefill_32k"), ("whisper-base", "train_4k"),
               ("mamba2-130m", "decode_32k"),
               ("recurrentgemma-9b", "long_500k"))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch,shape", FAMILY_RUNS)
def test_cli_one_arch_per_family(arch, shape, tmp_path, capsys):
    out = tmp_path / "rows.jsonl"
    assert dryrun.main(["--arch", arch, "--shape", shape, "--both-meshes",
                        "--out", str(out)]) == 0
    assert "[dryrun] 2 ok, 0 failed" in capsys.readouterr().out
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    assert [r["mesh"] for r in rows] == ["16x16", "2x16x16"]
    assert [r["chips"] for r in rows] == [256, 512]
    cfg = reg.get_config(arch)
    for r in rows:
        assert r["shape"] == shape and r["flops"] > 0
        assert r["window_override"] == specs.window_override(
            cfg, specs.SHAPES[shape])
        assert r["param_bytes"] > 0 and r["per_device_mem"] == (
            r["param_bytes"] + r["opt_bytes"] + r["cache_bytes"]
            + r["input_bytes"])
        assert (r["opt_bytes"] > 0) == (shape == "train_4k")
        assert (r["cache_bytes"] > 0) == (shape != "train_4k")
    assert rows[0]["flops"] == rows[1]["flops"]   # one pass, two meshes
    if arch == "qwen2.5-32b":
        assert rows[0]["window_override"] == 4096


def test_cli_fails_loudly():
    with pytest.raises(KeyError):
        dryrun.count_step("no-such-arch", "train_4k")
    assert dryrun.dry_run("no-such-arch", "train_4k", [False])[1]


def _cpu_inputs(cfg, shape, seed=0):
    """``specs.input_specs``' keys on the CPU with drawn values (decode: a
    zeroed fp32 cache)."""
    rng = np.random.default_rng(seed)
    b, s = shape.global_batch, shape.seq_len
    ins = {}
    if shape.kind == "decode":
        ins = {"token": torch.as_tensor(rng.integers(0, cfg.vocab_size, b)),
               "cache": tf.init_cache(cfg, b, s, device="cpu")}
    else:
        ins["tokens"] = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                                     (b, s)))
        if shape.kind == "train":
            ins["labels"] = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                                         (b, s)))
    if cfg.prefix_tokens and shape.kind != "decode":
        ins["prefix_embeds"] = torch.randn(b, cfg.prefix_tokens,
                                           cfg.d_model)
    if cfg.is_encdec:
        ins["frames" if shape.kind != "decode" else "enc_out"] = \
            torch.randn(b, cfg.encoder.max_source_positions, cfg.d_model)
    return ins


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ["pipedec-target", "qwen2-moe-a2.7b",
                                  "deepseek-v2-236b", "internvl2-26b",
                                  "whisper-base", "mamba2-130m",
                                  "recurrentgemma-9b"])
def test_meta_count_equals_cpu_count(arch, kind):
    """The product count of the meta pass (bf16 stand-ins) equals that of
    the same step on real fp32 CPU tensors at smoke width, and the CPU
    step's outputs are finite."""
    cfg = reg.get_config(arch, smoke=True)
    shape = InputShape("t", 24, 2, kind)
    meta = specs.param_specs(cfg)
    cpu = tf.init_model(cfg, seed=0, device="cpu")
    if kind == "train":
        trainable(meta)
        trainable(cpu)
    want, _ = dryrun.count_products(cfg, shape, meta,
                                    specs.input_specs(cfg, shape))
    got, cache = dryrun.count_products(cfg, shape, cpu,
                                       _cpu_inputs(cfg, shape))
    assert got == want > 0
    if kind == "train":
        assert all(torch.isfinite(p.grad).all() for p in cpu.parameters()
                   if p.grad is not None)
    else:
        assert all(torch.isfinite(t).all() for layer in cache
                   for t in layer.values())


def test_moe_routes_on_meta():
    """``expert_counts`` equals ``torch.bincount(minlength=e)`` on CPU
    ids, and a MoE block at published width runs on meta."""
    ids = torch.as_tensor(np.random.default_rng(0).integers(0, 60, (50, 4)))
    assert torch.equal(moe.expert_counts(ids, 60),
                       torch.bincount(ids.reshape(-1), minlength=60))
    cfg = reg.get_config("qwen2-moe-a2.7b")
    block = specs.param_specs(cfg).layers[0].ffn
    x = torch.empty((4, 128, cfg.d_model), dtype=specs.PARAM_DTYPE,
                    device="meta")
    y, aux = moe.moe_forward(block, cfg, x)
    assert y.shape == x.shape and y.device.type == "meta"
    assert aux.shape == ()


def test_pipeline_tick_on_meta():
    """One tick of a full ring (every stage holding a tree layer) at
    Gemma-7b's published width: every layer applied once."""
    row = dryrun.lower_pipeline_tick("gemma-7b", n_stages=4, width=8)
    assert row["stage_layers"] == reg.get_config("gemma-7b").num_layers
    assert row["flops"] > 0
