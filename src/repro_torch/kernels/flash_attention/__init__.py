"""flash_attention: fused causal and sliding-window attention (kernel K7).

``kernel`` holds the CUDA kernel's wrapper and its plain PyTorch version,
``ops`` the public API over it, ``ref`` the oracle.
"""
from repro_torch.kernels.flash_attention.ops import *  # noqa: F401,F403
