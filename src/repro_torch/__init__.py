"""SpecPipe in PyTorch and CUDA for one NVIDIA Hopper card.

The package mirrors the JAX package's layers (kernels -> models -> core ->
serving -> launch) and keeps its public layouts, so the two compute the
same functions on the same inputs.  It never imports JAX.

Precision is IEEE fp32 throughout, as in the JAX reference: TF32 is
switched off for matrix products and cuDNN here, once, when the package
is imported.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
