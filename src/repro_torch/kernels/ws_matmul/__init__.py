"""ws_matmul: the weight-stationary tiled GEMM (kernel K6).

``kernel`` holds the CUDA kernel's wrapper and its plain PyTorch version,
``ops`` the public API over it, ``ref`` the oracle.
"""
from repro_torch.kernels.ws_matmul.ops import *  # noqa: F401,F403
