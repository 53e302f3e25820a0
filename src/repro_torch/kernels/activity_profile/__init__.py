"""activity_profile: exact switching-activity toggle counts of a GEMM.

``kernel`` holds the CUDA kernels' wrappers and their plain PyTorch
versions, ``ops`` the per-GEMM API over them, ``ref`` the numpy oracle.
"""
from repro_torch.kernels.activity_profile.ops import *  # noqa: F401,F403
