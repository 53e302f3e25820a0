"""PyTorch oracle for the ws_matmul kernel (K6)."""

from __future__ import annotations

import torch

__all__ = ["ws_matmul_ref", "wrap_int32"]


def wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 values reduced mod 2^32 into the int32 range, as an int32
    accumulator wraps."""
    return (((x + 2**31) % 2**32) - 2**31).to(torch.int32)


def ws_matmul_ref(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain matmul at the kernel's accumulation precision: integers exact
    in int64 and wrapped to int32, floats in f32."""
    if not a.dtype.is_floating_point:
        return wrap_int32(a.to(torch.int64) @ w.to(torch.int64))
    return a.to(torch.float32) @ w.to(torch.float32)
