"""Checkpoint reading and the JAX-to-port weight bridge."""
from repro_torch.checkpoint.bridge import from_jax_params, load_jax_params
from repro_torch.checkpoint.io import load_pytree

__all__ = ["from_jax_params", "load_jax_params", "load_pytree"]
