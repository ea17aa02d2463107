"""The training CLI for every family the port serves:
``python -m repro_torch.launch.train --arch <id> --smoke --device cpu
--steps 3`` trains on tokens and labels alone, as the JAX CLI does (an
encoder-decoder without frames, a VLM without a prefix), and its
checkpoint loads in the JAX package (the ``encoder``, per-kind ``stack``
and ``tail`` leaves), whose forward on it gives the port's logits.

Tolerances: the checkpoint's arrays bit for bit; the JAX forward's logits
1e-5 of their largest magnitude, as in ``test_torch_train.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.io import load_pytree as jax_load_pytree
from repro.models import encdec as jenc
from repro.models import transformer as jtf
from repro_torch import configs as reg
from repro_torch.checkpoint import to_jax_params
from repro_torch.launch import train
from repro_torch.models import encdec
from repro_torch.models import transformer as tf
from test_torch_train import TOL_FWD, _close
from test_torch_train_families import jax_cfg

# every registry id the port serves but the MoE ones, whose training
# test_torch_train_moe.py holds, and the pair's, test_torch_train.py's
CLI_ARCHS = ("qwen2.5-32b", "qwen1.5-32b", "gemma-7b", "internvl2-26b",
             "whisper-base", "mamba2-130m", "recurrentgemma-9b")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _modal_kwargs(cfg, seed: int = 4):
    """(JAX forward kwargs, port forward kwargs, the JAX encoder input):
    a seeded prefix [2, P, d] or frames [2, T, d], as numpy."""
    rng = np.random.default_rng(seed)
    if cfg.prefix_tokens:
        x = (0.02 * rng.normal(size=(2, cfg.prefix_tokens, cfg.d_model))
             ).astype(np.float32)
        return {"prefix_embeds": jnp.asarray(x)}, {"prefix_embeds": x}, None
    if cfg.is_encdec:
        x = (0.02 * rng.normal(size=(2, cfg.encoder.max_source_positions,
                                     cfg.d_model))).astype(np.float32)
        return {}, {}, x
    return {}, {}, None


@pytest.mark.parametrize("arch", CLI_ARCHS)
def test_family_cli_trains_and_jax_loads_its_checkpoint(arch, tmp_path,
                                                        capsys):
    """``python -m repro_torch.launch.train --arch <id> --smoke --device
    cpu --steps 3`` on tokens and labels alone: finite losses; the
    checkpoint (``encoder``, per-kind ``stack`` and ``tail`` leaves) loads
    in the JAX package bit for bit, and the JAX forward on it, with a
    prefix or the encoder over frames where the family takes one, gives
    the port's logits."""
    path = str(tmp_path / "ckpt.npz")
    model, losses = train.main(["--device", "cpu", "--smoke", "--arch",
                                arch, "--steps", "3", "--batch", "2",
                                "--seq", "16", "--ckpt", path])
    assert "saved checkpoint" in capsys.readouterr().out
    assert len(losses) == 3 and all(np.isfinite(losses))
    cfg = model.cfg
    assert cfg.name == reg.get_config(arch, smoke=True).name
    blob = jax_load_pytree(path)
    jax.tree.map(np.testing.assert_array_equal, blob["params"],
                 to_jax_params(model))
    jcfg = jax_cfg(arch)
    jp = jax.tree.map(jnp.asarray, blob["params"])
    jkw, kw, frames = _modal_kwargs(cfg)
    if frames is not None:
        jkw["enc_out"] = jenc.encode(jp["encoder"], jcfg,
                                     jnp.asarray(frames))
        kw["enc_out"] = encdec.encode(model.encoder, cfg, frames)
    tokens = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 19))
    want, _ = jtf.forward(jp, jcfg, jnp.asarray(tokens), **jkw)
    with torch.no_grad():
        got = tf.forward(model, tokens, **kw)
    _close(got, want, TOL_FWD)
