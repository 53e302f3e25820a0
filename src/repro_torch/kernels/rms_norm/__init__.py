"""rms_norm: RMSNorm over rows in one pass, with RoPE fused for attention's
q and k (kernel L4).

``kernel`` holds the CUDA kernel's wrappers and their plain PyTorch
versions, ``ops`` the public API over them.
"""
from repro_torch.kernels.rms_norm.ops import *  # noqa: F401,F403
