"""Registry of the configurations the port runs: the paper's pair."""
from __future__ import annotations

from repro_torch.configs import pipedec_pair
from repro_torch.models.config import ModelConfig

_PAIR = {
    "pipedec-target": (pipedec_pair.TARGET, pipedec_pair.TARGET_SMOKE),
    "pipedec-draft": (pipedec_pair.DRAFT, pipedec_pair.DRAFT_SMOKE),
}


def get_config(arch: str, *, smoke: bool = False) -> ModelConfig:
    """``pipedec-target`` / ``pipedec-draft``, full width or smoke size."""
    if arch not in _PAIR:
        raise KeyError(f"unknown arch {arch!r}; the port has "
                       f"{sorted(_PAIR)}")
    full, small = _PAIR[arch]
    return small if smoke else full
