"""Public API of the row norm and the q/k norm-and-rotate (kernel L4).

``engine="cuda"`` (the default: the kernel on the current CUDA device) or
``engine="torch"`` (its plain PyTorch versions on the CPU), as the other
kernel packages take it.  Inputs are numpy arrays (float32) or tensors
(also bfloat16); numpy input is copied to the engine's device once and a
contiguous tensor already there is used in place.
"""

from __future__ import annotations

import torch

from repro_torch.kernels._engine import engine_device, to_engine
from repro_torch.kernels.rms_norm.kernel import qk_rope_fwd, rms_norm_fwd

__all__ = ["qk_rope", "rms_norm"]


def rms_norm(x, weight, eps: float = 1e-6, *, engine: str = "cuda") -> torch.Tensor:
    """x * rsqrt(mean(x^2) + eps) * weight over x's last dim, in float32,
    in x's type on the engine's device (``kernel.rms_norm_fwd``)."""
    device = engine_device(engine)
    return rms_norm_fwd(to_engine(x, device), to_engine(weight, device), eps)


def qk_rope(x, weight, cos, sin, eps: float = 1e-6, *, engine: str = "cuda") -> torch.Tensor:
    """(B, H, S, hd) q or k normed per head by ``weight`` (or None) and
    rotated by (B, S, hd/2) ``cos`` and ``sin`` (or None), in x's type on
    the engine's device (``kernel.qk_rope_fwd``)."""
    device = engine_device(engine)
    weight, cos, sin = (None if t is None else to_engine(t, device) for t in (weight, cos, sin))
    return qk_rope_fwd(to_engine(x, device), weight, cos, sin, eps)
