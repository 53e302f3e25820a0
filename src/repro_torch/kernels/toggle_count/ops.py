"""Public API of stream toggle counting (switching-activity profiling).

The same entry points as the JAX package's ``toggle_count/ops.py``, with
``engine="cuda"`` (the default: kernel K5 on the current CUDA device) or
``engine="torch"`` (its plain PyTorch version on the CPU) in place of
``interpret=``.  A stream is a numpy array or a tensor; numpy input is
copied to the engine's device once, and a tensor already there is used in
place.  Counts are exact Python ints for any stream size.

Deliberate differences from the reference: no ``block_t``/``block_l``
arguments (TPU tiling knobs), no padding, and int64 streams are counted
natively, where the reference split them into lo/hi int32 planes.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels._engine import engine_device
from repro_torch.kernels.toggle_count.kernel import stream_toggles

__all__ = ["stream_toggle_count", "stream_toggle_count_i64", "stream_activity"]

_WORD32 = 32
_NUMPY_TYPES = {torch.int32: np.int32, torch.int64: np.int64}


def _as_stream(stream, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``stream`` as a contiguous (T, L) ``dtype`` tensor on ``device``: a
    1-D stream is one lane; values are converted as numpy's ``astype``
    does (integers wrap, floats truncate)."""
    if isinstance(stream, torch.Tensor):
        x = stream.to(device=device, dtype=dtype)
    else:
        x = torch.from_numpy(np.asarray(stream).astype(_NUMPY_TYPES[dtype])).to(device)
    if x.ndim == 1:
        x = x[:, None]
    if x.ndim != 2:
        raise ValueError(f"a stream is 1-D or 2-D (T, L), got shape {tuple(x.shape)}")
    return x.contiguous()


def stream_toggle_count(stream, *, engine: str = "cuda") -> int:
    """Total bit flips along axis 0 of a (T, L) stream read as int32 words.

    Values are narrowed to int32 first, as the reference does, and all 32
    bits of each word count.  A 1-D stream is one lane; T < 2 gives 0.
    """
    x = _as_stream(stream, torch.int32, engine_device(engine))
    if x.shape[0] < 2:
        return 0
    return int(stream_toggles(x, _WORD32).item())


def stream_toggle_count_i64(stream, *, engine: str = "cuda") -> int:
    """Toggle count of an int64-valued stream (e.g. 37-bit partial sums),
    over all 64 bits of each value."""
    x = _as_stream(stream, torch.int64, engine_device(engine))
    if x.shape[0] < 2:
        return 0
    return int(stream_toggles(x).item())


def stream_activity(stream, bits: int, *, engine: str = "cuda") -> float:
    """Per-bit, per-transition switching activity of a (T, L) value stream.

    Values are read on the ``bits``-wide two's-complement bus (their low
    ``bits`` after sign extension to int64, matching
    ``repro_torch.core.switching.stream_toggle_rate``); the total is divided
    by (T - 1) * L * bits.  An int32 stream is counted without a widening
    copy: the kernel sign-extends.
    """
    if not 1 <= bits <= 64:
        raise ValueError("bus width must be in [1, 64]")
    device = engine_device(engine)
    narrow = (isinstance(stream, torch.Tensor) and stream.dtype == torch.int32) or (
        isinstance(stream, np.ndarray) and stream.dtype == np.int32
    )
    x = _as_stream(stream, torch.int32 if narrow else torch.int64, device)
    if x.shape[0] < 2:
        return 0.0
    toggles = int(stream_toggles(x, bits).item())
    transitions = (x.shape[0] - 1) * x.shape[1]
    return toggles / (transitions * bits)
