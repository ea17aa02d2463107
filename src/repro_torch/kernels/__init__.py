"""Hand-written CUDA kernels of the port, their plain versions and the
attention entry points built on them."""
