"""Bit-manipulation primitives shared by the plain PyTorch kernel versions.

On the card the kernels use ``__popcll``; PyTorch has no popcount, so the
plain versions count bits with a SWAR reduction on int64 tensors.
"""

from __future__ import annotations

import torch

__all__ = ["bus_mask", "popcount64"]

_LOW63 = 0x7FFFFFFFFFFFFFFF


def bus_mask(bits: int) -> int:
    """The low ``bits`` of a 64-bit word as a signed int64 constant.

    ``bits == 64`` selects every bit (-1 as int64).
    """
    if not 1 <= bits <= 64:
        raise ValueError("bus width must be in [1, 64]")
    return -1 if bits == 64 else (1 << bits) - 1


def _popcount63(v: torch.Tensor) -> torch.Tensor:
    # v holds non-negative int64 values, so no shift below ever sees a sign
    # bit and no sum leaves the int64 range.
    v = v - ((v >> 1) & 0x5555555555555555)
    v = (v & 0x3333333333333333) + ((v >> 2) & 0x3333333333333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F0F0F0F0F
    v = v + (v >> 8)
    v = v + (v >> 16)
    v = v + (v >> 32)
    return v & 0x7F


def popcount64(x: torch.Tensor) -> torch.Tensor:
    """Number of set bits of each int64 element, read as a 64-bit pattern.

    ``>>`` on int64 is arithmetic, so the sign bit is counted apart and the
    SWAR steps run on the non-negative low 63 bits.
    """
    if x.dtype != torch.int64:
        raise TypeError(f"popcount64 takes int64 tensors, got {x.dtype}")
    return _popcount63(x & _LOW63) + (x < 0)
