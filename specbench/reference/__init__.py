"""Plain float32 references, one module per model type (nothing of the
program)."""


def served(cfg: dict, key: str, default=None):
    """The value of ``key`` in the model that is served: the file's
    ``departures`` (where the program computes otherwise than the published
    configuration) over the published key."""
    return cfg.get("departures", {}).get(key, cfg.get(key, default))
