"""Toggle-counting kernels of the activity profiler and their plain versions.

Two kernels, written for Hopper in ``csrc/activity_profile.cu`` (the note at
the top of that file says what bounds each on the card and what its design
does about it):

  * K1 ``ws_activity_toggles`` replaces ``activity_profile_pallas``
    (``src/repro/kernels/activity_profile/kernel.py``): exact (h, v) toggle
    totals of a whole weight-stationary GEMM.
  * K4 ``operand_stream_toggles`` replaces ``operand_stream_toggles_pallas``
    (same file): the exact toggle total of a (T, L) bundle of independent
    operand lane streams, the per-GEMM work of the output-stationary
    dataflow.

Each wrapper takes int32 tensors and returns int64 totals on the operands'
device.  For CPU tensors it runs the plain PyTorch version beside it; for
CUDA tensors it launches the kernel, adds one to its ``launches`` count,
and raises if the launch is refused.  The plain versions also run on CUDA
tensors when called directly, which is how the kernels are checked on the
card.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.bitops import bus_mask, popcount64

__all__ = [
    "PLAIN_BLOCK_ELEMENTS",
    "ws_activity_toggles",
    "ws_activity_toggles_plain",
    "operand_stream_toggles",
    "operand_stream_toggles_plain",
]

# Largest int64 partial-sum block a plain version materializes at once.
PLAIN_BLOCK_ELEMENTS = 1 << 22


def _check_bits(*bits: int) -> None:
    if not all(1 <= b <= 64 for b in bits):
        raise ValueError("bus widths must be in [1, 64]")


def _check_operand(x: torch.Tensor, name: str, device: torch.device) -> None:
    if not isinstance(x, torch.Tensor) or x.ndim != 2:
        raise ValueError(f"{name} must be a 2-D tensor")
    if x.dtype != torch.int32:
        raise TypeError(f"{name} must be int32, got {x.dtype}")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if max(x.shape) >= 2**31:
        raise ValueError(f"{name} is too large for 32-bit extents")


def _launch(fn_name: str, device: torch.device, *args) -> None:
    lib = _build.load("activity_profile")
    with torch.cuda.device(device):
        err = getattr(lib, fn_name)(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn_name}: CUDA launch failed with error {err}")


def ws_activity_toggles_plain(
    a: torch.Tensor,
    w: torch.Tensor,
    rows: int,
    cols: int,
    b_h: int,
    b_v: int,
    *,
    block_t: int | None = None,
) -> torch.Tensor:
    """Plain PyTorch version of K1: ``(h_toggles, v_toggles)`` int64.

    Walks the k strips of ``rows`` reduction rows and, within each, windows
    of ``block_t`` time transitions; a window materializes the
    (block_t + 1, rows, N) int64 partial sums of every n tile of the strip,
    recomputing its seed row t0 - 1 as the kernel does.  ``block_t``
    defaults to the most that fits ``PLAIN_BLOCK_ELEMENTS``.
    """
    m, k = a.shape
    n = w.shape[1]
    out = torch.zeros(2, dtype=torch.int64, device=a.device)
    if m < 2 or k == 0 or n == 0:
        return out
    n_tiles = -(-n // cols)
    a64 = a.to(torch.int64)
    w64 = w.to(torch.int64)
    out[0] = popcount64((a64[1:] ^ a64[:-1]) & bus_mask(b_h)).sum() * n_tiles
    if block_t is None:
        block_t = max(1, PLAIN_BLOCK_ELEMENTS // (min(rows, k) * n))
    mask_v = bus_mask(b_v)
    for k0 in range(0, k, rows):
        a_strip = a64[:, k0 : k0 + rows]
        w_strip = w64[k0 : k0 + rows]
        for t0 in range(1, m, block_t):
            t1 = min(t0 + block_t, m)
            s = torch.cumsum(a_strip[t0 - 1 : t1, :, None] * w_strip[None], dim=1)
            out[1] += popcount64((s[1:] ^ s[:-1]) & mask_v).sum()
    return out


def ws_activity_toggles(
    a: torch.Tensor, w: torch.Tensor, rows: int, cols: int, b_h: int, b_v: int
) -> torch.Tensor:
    """K1: exact ``(h_toggles, v_toggles)`` int64 totals of the WS GEMM
    ``a @ w`` on an R x C array, on ``a``'s device.

    ``a`` is (M, K) and ``w`` (K, N), int32 with int16-range values.  h
    counts every input-bus transition of every weight tile (each k strip's
    stream once per n tile); v counts every partial-sum-bus transition of
    every PE.
    """
    _check_operand(a, "a", a.device)
    _check_operand(w, "w", a.device)
    if a.shape[1] != w.shape[0]:
        raise ValueError(f"bad GEMM shapes {tuple(a.shape)} x {tuple(w.shape)}")
    if rows < 1 or cols < 1:
        raise ValueError("rows and cols must be positive")
    _check_bits(b_h, b_v)
    if a.device.type == "cpu":
        return ws_activity_toggles_plain(a, w, rows, cols, b_h, b_v)
    if a.device.type != "cuda":
        raise ValueError(f"ws_activity_toggles runs on cpu or cuda tensors, not {a.device}")
    m, k = a.shape
    n = w.shape[1]
    out = torch.zeros(2, dtype=torch.int64, device=a.device)
    if m < 2 or k == 0 or n == 0:
        return out
    _launch(
        "ws_activity_toggles", a.device,
        a.data_ptr(), w.data_ptr(), out.data_ptr(), m, k, n, rows, cols, b_h, b_v,
    )
    ws_activity_toggles.launches += 1
    return out


ws_activity_toggles.launches = 0


def operand_stream_toggles_plain(
    x: torch.Tensor, bits: int, *, block_t: int | None = None
) -> torch.Tensor:
    """Plain PyTorch version of K4: the toggle total as a (1,) int64 tensor.

    Windows of ``block_t`` transitions each recompute their seed row
    t0 - 1, as the kernel's blocks do.
    """
    t, lanes = x.shape
    out = torch.zeros(1, dtype=torch.int64, device=x.device)
    if t < 2 or lanes == 0:
        return out
    if block_t is None:
        block_t = max(1, PLAIN_BLOCK_ELEMENTS // lanes)
    x64 = x.to(torch.int64)
    mask = bus_mask(bits)
    for t0 in range(1, t, block_t):
        seg = x64[t0 - 1 : min(t0 + block_t, t)]
        out += popcount64((seg[1:] ^ seg[:-1]) & mask).sum()
    return out


def operand_stream_toggles(x: torch.Tensor, bits: int) -> torch.Tensor:
    """K4: exact toggle total of the (T, L) int32 lane streams ``x`` on a
    ``bits``-wide two's-complement bus, as a (1,) int64 tensor on ``x``'s
    device.  Lane l carries x[:, l]; lanes never mix."""
    _check_operand(x, "x", x.device)
    _check_bits(bits)
    if x.device.type == "cpu":
        return operand_stream_toggles_plain(x, bits)
    if x.device.type != "cuda":
        raise ValueError(f"operand_stream_toggles runs on cpu or cuda tensors, not {x.device}")
    t, lanes = x.shape
    out = torch.zeros(1, dtype=torch.int64, device=x.device)
    if t < 2 or lanes == 0:
        return out
    _launch(
        "operand_stream_toggles", x.device, x.data_ptr(), out.data_ptr(), t, lanes, bits
    )
    operand_stream_toggles.launches += 1
    return out


operand_stream_toggles.launches = 0
