"""PyTorch oracle for the toggle_count kernel (K5)."""

from __future__ import annotations

import torch

from repro_torch.kernels.bitops import popcount64

__all__ = ["popcount_u32_ref", "toggle_count_ref", "stream_toggle_count_ref"]


def popcount_u32_ref(v: torch.Tensor) -> torch.Tensor:
    """Set bits of each element read as a uint32 (its low 32 bits), int64."""
    return popcount64(v.to(torch.int64) & 0xFFFFFFFF)


def toggle_count_ref(cur: torch.Tensor, nxt: torch.Tensor) -> torch.Tensor:
    """Total bit flips between aligned int32 arrays, as an int64 scalar."""
    return popcount_u32_ref(cur.to(torch.int32) ^ nxt.to(torch.int32)).sum()


def stream_toggle_count_ref(stream: torch.Tensor) -> torch.Tensor:
    """Total bit flips along axis 0 of an int32 value stream (T, L)."""
    return toggle_count_ref(stream[:-1], stream[1:])
