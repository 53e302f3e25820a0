"""K6: the weight-stationary tiled GEMM and its plain version.

``ws_gemm`` (``csrc/ws_matmul.cu``) replaces ``ws_matmul_pallas``
(``src/repro/kernels/ws_matmul/kernel.py``): ``a @ w`` with K innermost and
a wide accumulator, int8/int16 -> int32 (wrapping mod 2^32, as the TPU's
int32 accumulator does) and bf16/f32 -> f32.  The note at the top of the
source says what bounds it on the card and what its design does about
that.  For CPU tensors the wrapper runs the plain PyTorch version beside
it; for CUDA tensors it launches the kernel, adds one to
``ws_gemm.launches``, and raises if the launch is refused.  The plain
version also runs on CUDA tensors when called directly, which is how the
kernel is checked on the card.
"""

from __future__ import annotations

import torch

from repro_torch.kernels._engine import launch, on_cpu
from repro_torch.kernels.ws_matmul.ref import wrap_int32

__all__ = ["DTYPE_CODES", "EXACT_CHUNK_K", "ws_gemm", "ws_gemm_plain"]

# Operand types the kernel takes, by the code its C entry point reads.
DTYPE_CODES = {torch.int8: 0, torch.int16: 1, torch.bfloat16: 2, torch.float32: 3}

# Reduction rows per float64 product in the plain integer version: int16
# products are below 2^30 in magnitude, so a chunk's sums stay below 2^52
# and every float64 partial sum is an exact integer.
EXACT_CHUNK_K = 1 << 22


def _check(a: torch.Tensor, w: torch.Tensor) -> None:
    if not isinstance(a, torch.Tensor) or not isinstance(w, torch.Tensor):
        raise TypeError("a and w must be tensors")
    if a.ndim != 2 or w.ndim != 2 or a.shape[1] != w.shape[0]:
        raise ValueError(f"bad shapes {tuple(a.shape)} x {tuple(w.shape)}")
    if a.dtype != w.dtype or a.dtype not in DTYPE_CODES:
        raise TypeError(
            f"a and w must share one of {sorted(map(str, DTYPE_CODES))}, got {a.dtype}, {w.dtype}"
        )
    if a.device != w.device:
        raise ValueError(f"a is on {a.device} but w on {w.device}")
    if not (a.is_contiguous() and w.is_contiguous()):
        raise ValueError("a and w must be contiguous")
    if max(a.shape + w.shape) >= 2**31:
        raise ValueError("dimensions must be below 2^31")


def ws_gemm_plain(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K6, on any device.

    Integers: float64 products of ``EXACT_CHUNK_K`` reduction rows at a time
    (exact; PyTorch has no CUDA integer matmul), summed in int64 and wrapped
    to int32.  Floats: an f32 matmul (full f32 unless the caller enables
    TF32).
    """
    if a.dtype.is_floating_point:
        return a.to(torch.float32) @ w.to(torch.float32)
    k = a.shape[1]
    out = torch.zeros((a.shape[0], w.shape[1]), dtype=torch.int64, device=a.device)
    for k0 in range(0, k, EXACT_CHUNK_K):
        part = a[:, k0 : k0 + EXACT_CHUNK_K].double() @ w[k0 : k0 + EXACT_CHUNK_K].double()
        out += part.to(torch.int64)
    return wrap_int32(out)


def ws_gemm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """K6: ``a @ w`` for contiguous (M, K) and (K, N) tensors of one type,
    int8/int16 -> int32 (wrapped mod 2^32) or bf16/f32 -> f32, on ``a``'s
    device."""
    _check(a, w)
    if on_cpu(a, "ws_gemm"):
        return ws_gemm_plain(a, w)
    m, k = a.shape
    n = w.shape[1]
    out_dtype = torch.float32 if a.dtype.is_floating_point else torch.int32
    if m == 0 or n == 0 or k == 0:
        return torch.zeros((m, n), dtype=out_dtype, device=a.device)
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    launch(
        "ws_matmul", "ws_matmul", a.device,
        a.data_ptr(), w.data_ptr(), out.data_ptr(), m, k, n, DTYPE_CODES[a.dtype],
    )
    ws_gemm.launches += 1
    return out


ws_gemm.launches = 0
