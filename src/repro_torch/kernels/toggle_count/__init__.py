"""toggle_count: bit toggles along a value stream (kernel K5).

``kernel`` holds the CUDA kernel's wrapper and its plain PyTorch version,
``ops`` the public API over it, ``ref`` the oracle.
"""
from repro_torch.kernels.toggle_count.ops import *  # noqa: F401,F403
