"""selective_scan: Mamba's selective scan, forward (kernel L3).

``kernel`` holds the CUDA kernel's wrapper and its plain PyTorch version,
``ops`` the public API over it, ``ref`` the oracle.
"""
from repro_torch.kernels.selective_scan.ops import *  # noqa: F401,F403
