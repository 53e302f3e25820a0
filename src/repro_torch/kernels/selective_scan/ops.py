"""Public API of Mamba's selective scan (kernel L3).

``engine="cuda"`` (the default: the kernel on the current CUDA device) or
``engine="torch"`` (its plain PyTorch version on the CPU), as the other
kernel packages take it.  Inputs are numpy arrays (float32) or tensors
(also bfloat16); numpy input is copied to the engine's device once and a
contiguous tensor already there is used in place.
"""

from __future__ import annotations

import torch

from repro_torch.kernels._engine import engine_device, to_engine
from repro_torch.kernels.selective_scan.kernel import selective_scan_fwd

__all__ = ["selective_scan"]


def selective_scan(u, dt, z, b, c, a, d, dt_bias, *, engine: str = "cuda") -> torch.Tensor:
    """y = (sum_n h[n] C[n] + D u) silu(z) of the selective scan with
    decays exp(softplus(dt + dt_bias) A) and inputs softplus(dt + dt_bias)
    u B (``kernel.selective_scan_fwd``); (B, S, d_inner) in u's type on the
    engine's device."""
    device = engine_device(engine)
    return selective_scan_fwd(*(to_engine(x, device) for x in (u, dt, z, b, c, a, d, dt_bias)))
