"""PyTorch oracle for the selective scan kernel (L3)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["selective_scan_ref"]


def selective_scan_ref(u, dt, z, b, c, a, d, dt_bias) -> torch.Tensor:
    """The recurrence token by token in float64, from a zero state:
    (B, S, d_inner) in float64 (shapes as ``kernel.selective_scan_fwd``)."""
    u, dt, z, b, c, a, d, dt_bias = (x.double() for x in (u, dt, z, b, c, a, d, dt_bias))
    delta = F.softplus(dt + dt_bias)
    h = torch.zeros(u.shape[0], u.shape[2], a.shape[-1], dtype=torch.float64, device=u.device)
    ys = []
    for t in range(u.shape[1]):
        h = torch.exp(delta[:, t, :, None] * a) * h + (delta[:, t] * u[:, t])[..., None] * b[:, t, None]
        ys.append((h * c[:, t, None]).sum(-1))
    return (torch.stack(ys, dim=1) + d * u) * F.silu(z)
