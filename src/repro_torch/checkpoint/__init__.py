"""Checkpoints (flat-key ``.npz``) and the weight bridge between the JAX
package's parameter pytree and the port's modules."""
from repro_torch.checkpoint.bridge import (from_jax_params, load_jax_params,
                                           to_jax_params)
from repro_torch.checkpoint.io import load_pytree, save_pytree

__all__ = ["from_jax_params", "load_jax_params", "load_pytree",
           "save_pytree", "to_jax_params"]
