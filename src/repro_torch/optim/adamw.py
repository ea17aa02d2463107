"""AdamW with decoupled weight decay, grad clipping and a cosine schedule.

The JAX package's ``repro/optim/adamw.py`` as plain functions on lists of
tensors, under ``torch.no_grad``.  The update is the JAX one, not
``torch.optim.AdamW`` with ``clip_grad_norm_`` (whose clip scale is
``max_norm / (norm + 1e-6)`` and whose decay and bias corrections come in
another order):

  * the step is counted before the schedule and the bias corrections;
  * the clip scale is ``min(1, clip_norm / max(gnorm, 1e-9))``;
  * the decay ``weight_decay * p`` is decoupled and applies to every
    tensor, norms and embeddings included;
  * a gradient of ``None`` (a weight the loss does not reach, whose
    ``.grad`` autograd leaves unset) is the zero gradient ``jax.grad``
    gives such a leaf: it adds 0 to the global norm, its moments decay
    and the weight decay still moves it, with no zero tensor made.

The step, the schedule and the clip scale stay on the parameters' device
as 0-d tensors, so a step never waits for the card.  Parameters, ``m``
and ``v`` are updated in place, one tensor at a time, so the update's
temporaries are the size of the largest tensor, not of the model.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    """Peak learning rate, Adam betas and eps, decoupled weight decay, the
    global-norm clip, and the schedule's warm-up and total steps."""
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000


def cosine_schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warm-up to ``cfg.lr``, then a cosine decay to 0 at
    ``total_steps``; fp32, on ``step``'s device."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    return cfg.lr * warm * 0.5 * (1 + torch.cos(math.pi * prog))


@torch.no_grad()
def global_norm(tensors: Sequence[Optional[torch.Tensor]]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in fp32; a ``None``
    counts as zeros."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tensors if x is not None))


def adamw_init(params: Sequence[torch.Tensor]) -> dict:
    """Zero moments beside each parameter and a step count of 0."""
    dev = params[0].device
    return {"m": [torch.zeros_like(p, dtype=torch.float32) for p in params],
            "v": [torch.zeros_like(p, dtype=torch.float32) for p in params],
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params: List[torch.Tensor],
                 grads: Sequence[Optional[torch.Tensor]], state: dict
                 ) -> Tuple[List[torch.Tensor], dict, dict]:
    """One AdamW step: ``params`` and the moments of ``state`` are updated
    in place; a ``None`` gradient is a zero one.  Returns (params, state,
    {"grad_norm", "lr"})."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    stepf = step.to(torch.float32)
    bc1 = 1 - torch.pow(torch.tensor(cfg.b1, device=stepf.device), stepf)
    bc2 = 1 - torch.pow(torch.tensor(cfg.b2, device=stepf.device), stepf)
    lr = cosine_schedule(cfg, step)
    for p, g, m, v in zip(params, grads, state["m"], state["v"]):
        m.mul_(cfg.b1)
        v.mul_(cfg.b2)
        if g is not None:     # None: b * m + (1 - b) * 0, exactly
            g = g.float() * scale
            m.add_((1 - cfg.b1) * g)
            v.add_((1 - cfg.b2) * g * g)
            del g
        delta = (m / bc1).div_(torch.sqrt(v / bc2).add_(cfg.eps))
        delta.add_(cfg.weight_decay * p)
        p.sub_(lr * delta)
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
