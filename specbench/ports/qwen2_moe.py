"""How the program serves a ``qwen2_moe`` configuration file.

The port's MoE layer renormalises the top-k gates and has no gate on the
shared expert, so it serves only a file whose ``departures`` state both
(``norm_topk_prob`` true, ``shared_expert_gate`` false); any other file is
refused rather than served as something it does not state."""
from __future__ import annotations

import dataclasses

from specbench.ports import qwen2
from specbench.reference import served


def model_config(cfg: dict):
    from repro_torch.models.config import MoEConfig
    if not served(cfg, "norm_topk_prob") or \
            served(cfg, "shared_expert_gate", True):
        raise ValueError("the port's MoE layer renormalises the top-k gates "
                         "and has no shared-expert gate; the file's "
                         "departures must state norm_topk_prob true and "
                         "shared_expert_gate false")
    f = cfg["moe_intermediate_size"]
    fs = cfg["shared_expert_intermediate_size"]
    if fs % f:
        raise ValueError("the port's shared expert is a whole number of "
                         "expert widths")
    moe = MoEConfig(num_experts=cfg["num_experts"],
                    experts_per_token=cfg["num_experts_per_tok"],
                    d_ff_expert=f, num_shared_experts=fs // f, first_dense=0,
                    capacity_factor=cfg["assumed"]["capacity_factor"],
                    router_aux_weight=cfg["router_aux_loss_coef"])
    return dataclasses.replace(qwen2.model_config(cfg), family="moe",
                               d_ff=fs, moe=moe)


def port_name(name: str) -> str:
    if name in qwen2.OUTER:
        return qwen2.OUTER[name]
    _, i, rest = name.split(".", 2)
    if rest in qwen2.ATTENTION:
        return f"layers.{i}.{qwen2.ATTENTION[rest]}"
    if rest == "router":
        return f"layers.{i}.ffn.router"
    for group, port in (("experts.", "ffn."), ("shared.", "ffn.shared.")):
        if rest.startswith(group):
            return f"layers.{i}.{port}{rest[len(group):]}"
    raise KeyError(name)


def state_dict(weights: dict, cfg: dict) -> dict:
    return {port_name(n): t for n, t in weights.items()}
