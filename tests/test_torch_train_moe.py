"""Training the MoE families: the port's ``loss_fn`` (cross-entropy plus
``router_aux_weight`` times the summed router term, as in the reference)
and every gradient leaf against ``jax.grad`` of the JAX ``loss_fn``, on
the Moonlight, Qwen-MoE and DeepSeek-V2 smoke configs with the JAX
package's own initial weights carried over by the bridge.  Tolerances,
relative to the compared tensor's largest magnitude as in
``test_torch_train.py``: the loss 1e-6, every gradient leaf 1e-4 (the
pair's training tolerance).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jreg
from repro.models import transformer as jtf
from repro_torch.checkpoint import from_jax_params
from repro_torch.models import transformer as tf
from repro_torch.models.layers import trainable
from test_torch_moe import port_cfg
from test_torch_train import _batch, _close, _port_grads, _tree_close

TOL_LOSS, TOL_GRAD = 1e-6, 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "qwen2-moe-a2.7b",
                                  "deepseek-v2-236b"])
def test_moe_loss_and_grads_match_jax(arch):
    jcfg = jreg.get_config(arch, smoke=True)
    params = jax.tree.map(np.asarray, jax.device_get(
        jtf.init_model(jax.random.PRNGKey(3), jcfg)))
    model = from_jax_params(port_cfg(jcfg), params, device="cpu")
    trainable(model)
    tokens, labels = _batch(jcfg, s=16)

    def jloss(p):
        return jtf.loss_fn(p, jcfg, jnp.asarray(tokens), jnp.asarray(labels),
                           ce_chunk=8)
    jl, jg = jax.value_and_grad(jloss)(jax.tree.map(jnp.asarray, params))
    loss = tf.loss_fn(model, tokens, labels, ce_chunk=8)
    loss.backward()
    _, aux = jtf.forward(params, jcfg, jnp.asarray(tokens))
    assert float(aux) > 0     # the router term is in play
    _close(loss.item(), float(jl), TOL_LOSS)
    _tree_close(_port_grads(model), jg, TOL_GRAD)
