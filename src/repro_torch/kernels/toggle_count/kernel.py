"""K5: the stream toggle counter and its plain version.

``stream_toggles`` (``csrc/toggle_count.cu``) replaces ``toggle_count_pallas``
(``src/repro/kernels/toggle_count/kernel.py``): the total bit flips along
axis 0 of a (T, L) int32 or int64 stream, under a bus mask.  The note at
the top of the source says what bounds it on the card and what its design
does about that.  For a CPU tensor the wrapper runs the plain PyTorch
version beside it; for a CUDA tensor it launches the kernel, adds one to
``stream_toggles.launches``, and raises if the launch is refused.  The
plain version also runs on CUDA tensors when called directly, which is how
the kernel is checked on the card.
"""

from __future__ import annotations

import torch

from repro_torch.kernels._engine import launch, on_cpu
from repro_torch.kernels.bitops import bus_mask, popcount64

__all__ = ["PLAIN_BLOCK_ELEMENTS", "stream_toggles", "stream_toggles_plain"]

# Largest int64 block the plain version materializes at once.
PLAIN_BLOCK_ELEMENTS = 1 << 22


def _check_stream(x: torch.Tensor, bits: int) -> None:
    if not isinstance(x, torch.Tensor) or x.ndim != 2:
        raise ValueError("the stream must be a 2-D (T, L) tensor")
    if x.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"the stream must be int32 or int64, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("the stream must be contiguous")
    bus_mask(bits)  # raises outside [1, 64]


def stream_toggles_plain(x: torch.Tensor, bits: int = 64) -> torch.Tensor:
    """Plain PyTorch version of K5: the toggle total as a (1,) int64 tensor.

    Values are sign-extended to int64 and each transition counts the set
    bits of ``(x[t] ^ x[t + 1]) & mask`` over the low ``bits``; windows of
    about ``PLAIN_BLOCK_ELEMENTS`` values each recompute their seed row.
    """
    t, lanes = x.shape
    out = torch.zeros(1, dtype=torch.int64, device=x.device)
    if t < 2 or lanes == 0:
        return out
    mask = bus_mask(bits)
    step = max(1, PLAIN_BLOCK_ELEMENTS // lanes)
    for t0 in range(1, t, step):
        seg = x[t0 - 1 : min(t0 + step, t)].to(torch.int64)
        out += popcount64((seg[1:] ^ seg[:-1]) & mask).sum()
    return out


def stream_toggles(x: torch.Tensor, bits: int = 64) -> torch.Tensor:
    """K5: exact toggle total of the (T, L) stream ``x`` along axis 0, on a
    ``bits``-wide two's-complement bus, as a (1,) int64 tensor on ``x``'s
    device.

    ``x`` is contiguous int32 or int64; lane l carries ``x[:, l]`` and
    lanes never mix.  Values are sign-extended to 64 bits, so ``bits`` above
    32 on an int32 stream counts its sign copies.
    """
    _check_stream(x, bits)
    if on_cpu(x, "stream_toggles"):
        return stream_toggles_plain(x, bits)
    t, lanes = x.shape
    if t < 2 or lanes == 0:
        return torch.zeros(1, dtype=torch.int64, device=x.device)
    out = torch.empty(1, dtype=torch.int64, device=x.device)  # the C entry zeroes it
    launch(
        "toggle_count", "stream_toggles", x.device,
        x.data_ptr(), out.data_ptr(), t, lanes, x.element_size(), bus_mask(bits) & (2**64 - 1),
    )
    stream_toggles.launches += 1
    return out


stream_toggles.launches = 0
