"""How the program serves a ``qwen2`` configuration file: the port's
``ModelConfig`` and the names under which its ``Transformer`` takes the
harness's weights."""
from __future__ import annotations

from specbench.reference import served


def model_config(cfg: dict):
    """The port's ``ModelConfig`` of the file's sizes, in float32 (the
    port's precision: a file must state it among its ``departures``)."""
    from repro_torch.models.config import ModelConfig
    if served(cfg, "torch_dtype") != "float32":
        raise ValueError("the port serves float32; the file's departures "
                         "must state torch_dtype float32")
    return ModelConfig(
        name=cfg["name"], family="dense",
        num_layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"],
        num_heads=cfg["num_attention_heads"],
        num_kv_heads=cfg["num_key_value_heads"],
        d_ff=cfg["intermediate_size"], vocab_size=cfg["vocab_size"],
        mlp_variant="swiglu", qkv_bias=True,
        tie_embeddings=cfg["tie_word_embeddings"],
        norm_eps=cfg["rms_norm_eps"], rope_theta=cfg["rope_theta"],
        max_seq_len=cfg["max_position_embeddings"], dtype="float32")


ATTENTION = {"norm1": "norm1.scale", "norm2": "norm2.scale",
             "wq": "mixer.w_q", "bq": "mixer.b_q", "wk": "mixer.w_k",
             "bk": "mixer.b_k", "wv": "mixer.w_v", "bv": "mixer.b_v",
             "wo": "mixer.w_o"}
OUTER = {"embed": "embed.table", "final_norm": "final_norm.scale",
         "head": "lm_head.table"}


def port_name(name: str) -> str:
    """The port's state-dict key of a reference weight name."""
    if name in OUTER:
        return OUTER[name]
    _, i, rest = name.split(".", 2)
    if rest in ATTENTION:
        return f"layers.{i}.{ATTENTION[rest]}"
    if rest.startswith("mlp."):
        return f"layers.{i}.ffn.{rest[4:]}"
    raise KeyError(name)


def state_dict(weights: dict, cfg: dict) -> dict:
    return {port_name(n): t for n, t in weights.items()}
