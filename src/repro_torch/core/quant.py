"""Symmetric integer quantization (the paper evaluates 16-bit-int inference)."""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["QuantizedTensor", "quantize_symmetric", "dequantize"]


@dataclasses.dataclass(frozen=True)
class QuantizedTensor:
    values: np.ndarray  # int64 container, representable in `bits` bits
    scale: float
    bits: int

    def dequantize(self) -> np.ndarray:
        return dequantize(self)


def quantize_symmetric(x: np.ndarray, bits: int) -> QuantizedTensor:
    """Symmetric per-tensor quantization to signed ``bits``-bit integers."""
    if not 2 <= bits <= 32:
        raise ValueError("bits must be in [2, 32]")
    x = np.asarray(x, dtype=np.float64)
    qmax = float(2 ** (bits - 1) - 1)
    amax = float(np.max(np.abs(x))) if x.size else 0.0
    scale = amax / qmax if amax > 0 else 1.0
    q = np.clip(np.rint(x / scale), -qmax, qmax).astype(np.int64)
    return QuantizedTensor(values=q, scale=scale, bits=bits)


def dequantize(q: QuantizedTensor) -> np.ndarray:
    return q.values.astype(np.float64) * q.scale
