"""Training the families the port serves against ``jax.grad``: the loss
and every gradient leaf of the smoke configs of Qwen 2.5 and 1.5 (QKV
bias), Gemma (GeGLU, head_dim 256 in the published config), InternVL2
(a vision prefix in the batch, its rows left out of the loss), Whisper
with frames (the encoder under autograd) and on tokens alone (the JAX
CLI's batch: the encoder and the cross sub-layers take no gradient),
Mamba-2 (chunked SSD), RecurrentGemma (RG-LRU and windowed local
attention) and the attention+SSD hybrid, on the JAX package's own initial
weights carried over by the bridge.  The recurrent mixers' gradients
alone are in ``test_torch_train_recurrent.py``, the train steps, the CLI
and the checkpoints in ``test_torch_train_families_steps.py``.

Tolerances, relative to the compared tensor's largest magnitude as in
``test_torch_train.py``: the loss 1e-5, every gradient leaf 1e-4, remat
on against off 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import encdec as jenc
from repro.models import transformer as jtf
from repro_torch.checkpoint import from_jax_params
from repro_torch.launch import steps
from repro_torch.models.layers import trainable
from test_torch_recurrent import jax_cfg as recurrent_jax_cfg
from test_torch_recurrent import port_cfg
from test_torch_train import (TOL_FWD, TOL_GRAD, TOL_REMAT, _batch, _close,
                              _port_grads, _tree_close)

# "whisper-base-tokens": Whisper trained on tokens and labels alone
CASES = ("qwen2.5-32b", "qwen1.5-32b", "gemma-7b", "internvl2-26b",
         "whisper-base", "whisper-base-tokens", "mamba2-130m",
         "recurrentgemma-9b", "hybrid-ssm")
CONSTANT_LEAVES = ("scale", "conv_b", "dt_bias", "A_log", "D")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_cfg(case: str):
    """The case's JAX config: ``test_torch_recurrent.jax_cfg`` (a registry
    smoke config, or the reference's "sa" hybrid) of the case's id."""
    return recurrent_jax_cfg(case.removesuffix("-tokens"))


def train_params(jcfg, seed: int):
    """The JAX package's pytree as numpy, with N(0, 0.1) noise on the
    leaves it draws as constants and on the QKV biases (drawn as zeros)."""
    params = jax.device_get(jtf.init_model(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)

    def f(path, x):
        x = np.asarray(x)
        name = getattr(path[-1], "key", None)
        if name in CONSTANT_LEAVES + ("b_q", "b_k", "b_v"):
            return (x + 0.1 * rng.normal(size=x.shape)).astype(np.float32)
        return x
    return jax.tree_util.tree_map_with_path(f, params)


def train_batch(cfg, case: str, *, b: int = 2, s: int = 21, seed: int = 0):
    """``test_torch_train._batch``'s tokens and labels (s past
    RecurrentGemma's 16-key smoke window, not a multiple of the SSD chunk,
    some labels -1), and the case's modality input,
    normal times 0.02: a prefix [b, P, d] or frames [b, T, d]."""
    tokens, labels = _batch(cfg, b=b, s=s, seed=seed)
    batch = {"tokens": tokens, "labels": labels}
    rng = np.random.default_rng(seed + 100)
    if cfg.prefix_tokens:
        batch["prefix_embeds"] = (0.02 * rng.normal(
            size=(b, cfg.prefix_tokens, cfg.d_model))).astype(np.float32)
    if cfg.is_encdec and not case.endswith("-tokens"):
        batch["frames"] = (0.02 * rng.normal(
            size=(b, cfg.encoder.max_source_positions,
                  cfg.d_model))).astype(np.float32)
    return batch


def jax_loss(jcfg, batch, *, remat: bool = False):
    """``p -> loss``: the JAX train step's loss of ``batch`` (the encoder
    over the frames inside it, as ``repro.launch.steps._enc_out``)."""
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss(p):
        enc = None
        if "frames" in jb:
            enc = jenc.encode(p["encoder"], jcfg, jb["frames"])
        return jtf.loss_fn(p, jcfg, jb["tokens"], jb["labels"],
                           prefix_embeds=jb.get("prefix_embeds"),
                           enc_out=enc, remat=remat)
    return loss


@pytest.fixture(scope="module", params=CASES)
def case(request):
    """{"case", "cfg", "jcfg", "params", "model" (trainable)}."""
    jcfg = jax_cfg(request.param)
    cfg = port_cfg(jcfg)
    params = train_params(jcfg, seed=3)
    model = from_jax_params(cfg, params, device="cpu")
    trainable(model)
    return {"case": request.param, "cfg": cfg, "jcfg": jcfg,
            "params": params, "model": model}


def test_family_loss_and_grads_match_jax(case):
    """The loss and every gradient leaf against ``jax.value_and_grad`` of
    the reference's step loss; for Whisper on tokens alone the encoder's
    and the cross sub-layers' leaves are zeros in both."""
    cfg, model = case["cfg"], case["model"]
    batch = train_batch(cfg, case["case"])
    jl, jg = jax.jit(jax.value_and_grad(jax_loss(case["jcfg"], batch)))(
        jax.tree.map(jnp.asarray, case["params"]))
    model.zero_grad(set_to_none=True)
    loss = steps.batch_loss(model, batch, remat=False)
    loss.backward()
    grads = _port_grads(model)
    model.zero_grad(set_to_none=True)
    _close(loss.item(), float(jl), TOL_FWD)
    _tree_close(grads, jg, TOL_GRAD)
    if case["case"] == "whisper-base-tokens":
        assert not np.abs(np.concatenate(
            [np.ravel(x) for x in jax.tree.leaves(grads["encoder"])])).any()
        assert all(not np.abs(np.asarray(x)).any() for x in jax.tree.leaves(
            [layer["cross"] for layer in grads["stack"]]))


def test_family_remat_matches_plain(case):
    """``torch.utils.checkpoint`` per block (every layer kind, the cross
    sub-layer, the prefix rows) against no remat: loss and gradients."""
    model = case["model"]
    batch = train_batch(case["cfg"], case["case"], seed=1)
    out = []
    for remat in (False, True):
        model.zero_grad(set_to_none=True)
        loss = steps.batch_loss(model, batch, remat=remat)
        loss.backward()
        out.append((loss.item(), _port_grads(model)))
    model.zero_grad(set_to_none=True)
    _close(out[1][0], out[0][0], TOL_REMAT)
    _tree_close(out[1][1], out[0][1], TOL_REMAT)
