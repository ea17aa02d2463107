"""Training the families the port serves, step by step: 3 AdamW steps of
``launch.steps.make_train_step`` against the JAX ``make_train_step`` on
the same weights and batches (the cases of
``test_torch_train_families.py``: Whisper with frames and on tokens
alone, InternVL2 with a prefix, the recurrent families).

Whisper on tokens alone is the JAX CLI's batch: the encoder and the cross
sub-layers take no gradient, which ``jax.grad`` gives as zeros and
autograd as ``None``; AdamW decays those weights in both.

Tolerances, relative to the compared tensor's largest magnitude as in
``test_torch_train.py``: each step's loss and grad norm 1e-4; every
parameter after the 3 steps within 1e-4 absolute (the encoder of
tokens-only Whisper within 1e-6 of its initial weights times the 3
steps' decay factors).  The steps run at the trainer's default peak lr
(3e-4), not at ``test_torch_train.py``'s 1e-2: Adam's first update is
near sign(g), so an element whose gradient is near its eps (1e-8) moves
by a share of the lr that fp32 rounding of g decides, in both packages
alike.  At 1e-2 Qwen 2.5's parameters part by up to 8.8e-4 of a leaf's
largest value (an ``lm_head`` element whose first gradient is -6.4e-9),
at 1e-3 by 9.3e-5, at 3e-4 by 2.8e-5: the parting scales with the lr.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch.steps import make_train_step as jax_make_train_step
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import adamw_init as jax_adamw_init
from repro_torch.checkpoint import from_jax_params, to_jax_params
from repro_torch.launch import steps
from repro_torch.models.layers import trainable
from repro_torch.optim import AdamWConfig, adamw_init
from test_torch_train import TOL_STEPS, _close, _tree_close
from test_torch_train_families import (CASES, jax_cfg, port_cfg,
                                       train_batch, train_params)

# every parameter after the 3 steps, absolute
TOL_PARAMS = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("case", CASES)
def test_family_three_train_steps_match_jax(case):
    jcfg = jax_cfg(case)
    cfg = port_cfg(jcfg)
    params = train_params(jcfg, seed=7)
    kw = dict(lr=AdamWConfig().lr, warmup_steps=1, total_steps=3)
    jstep = jax.jit(jax_make_train_step(jcfg, JaxAdamWConfig(**kw),
                                        remat=False))
    jp = jax.tree.map(jnp.asarray, params)
    jopt = jax_adamw_init(jp)
    model = from_jax_params(cfg, params, device="cpu")
    opt = adamw_init(trainable(model))
    tstep = steps.make_train_step(cfg, AdamWConfig(**kw), remat=False)
    lrs = []
    for i in range(3):
        batch = train_batch(cfg, case, seed=10 + i)
        jp, jopt, jm = jstep(jp, jopt, {k: jnp.asarray(v)
                                        for k, v in batch.items()})
        opt, tm = tstep(model, opt, batch)
        lrs.append(float(tm["lr"]))
        assert all(p.grad is None for p in model.parameters())
        _close(float(tm["loss"]), float(jm["loss"]), TOL_STEPS, f"step {i}")
        _close(float(tm["grad_norm"]), float(jm["grad_norm"]), TOL_STEPS)
    assert int(opt["step"]) == 3
    got = to_jax_params(model)
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(jp)[0],
                            jax.tree.leaves(got)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0,
                                   atol=TOL_PARAMS,
                                   err_msg=jax.tree_util.keystr(path))
    if case == "whisper-base-tokens":
        # no gradient reaches the encoder: the decay alone moves it
        wd = AdamWConfig(**kw).weight_decay
        factor = np.prod([1 - lr * wd for lr in lrs])
        _tree_close(got["encoder"],
                    jax.tree.map(lambda x: x * factor, params["encoder"]),
                    1e-6)
