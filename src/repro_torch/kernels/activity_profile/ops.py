"""Public API of the fused switching-activity engine.

``profile_gemm_toggles`` returns EXACT integer toggle totals for the
horizontal and vertical buses of a full GEMM under either systolic dataflow:

  * ``dataflow="WS"``: weight-stationary. Horizontal buses stream the A
    operand over the M axis, vertical buses carry the partial-sum cumsum
    down the reduction rows; kernel K1 (``ws_activity_toggles``) counts both.
  * ``dataflow="OS"``: output-stationary. BOTH buses are operand streams
    over the K axis (A rows horizontally, W columns vertically; the
    accumulators never move).  Per-lane toggle totals are geometry-free and
    scale with the output-tile counts, ceil(N/cols) horizontally and
    ceil(M/rows) vertically, so kernel K4 (``operand_stream_toggles``) runs
    once per operand.

Two engines run the same counts:

  * ``"cuda"``: the hand-written kernels on the CUDA card (the default);
  * ``"torch"``: their plain PyTorch versions on the CPU.

Operand contract: values must be int16-range (|x| < 2^15), as everything
``repro_torch.core.quant`` emits at 16 bits is.  ``repro_torch.core.switching``
sends anything wider to the numpy oracle.  The ``MAX_FUSED_*`` bounds are the
reference engine's contracts, kept so that ``backend="auto"`` resolves as it
does there.

``profile_gemm_lane_toggles`` and ``stream_lane_toggle_totals`` resolve the
same counts per bus bit lane, through two more kernels: L1
(``ws_lane_toggles``) for the WS partial-sum buses and L2
(``stream_lane_toggles``) for the operand streams (the WS horizontal bus and
both OS buses).  On ``"torch"`` their plain versions run: the WS pass walks
each k strip in time blocks of bounded size, carrying the strip's last
int64 partial-sum row from block to block, so the (T, R, C) tensor never
exists.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.switching import os_stream_counts
from repro_torch.kernels._engine import ENGINES, engine_device
from repro_torch.kernels.activity_profile.kernel import (
    compact_lanes,
    operand_stream_toggles,
    stream_lane_toggles,
    ws_activity_toggles,
    ws_lane_toggles,
)

__all__ = [
    "ToggleCounts",
    "LaneToggleCounts",
    "ENGINES",
    "INT16_SAFE_MAX",
    "MAX_FUSED_K",
    "MAX_FUSED_ROWS",
    "MAX_FUSED_LANES",
    "operands_fit_fused",
    "profile_gemm_toggles",
    "profile_gemm_lane_toggles",
    "stream_toggle_total",
    "stream_lane_toggle_totals",
]

INT16_SAFE_MAX = (1 << 15) - 1
# Bounds of the reference engine (whose int32 partials they protect): K_pad
# below 2^25, rows below 2^15, OS stream lanes below 2^25.
MAX_FUSED_K = 1 << 25
MAX_FUSED_ROWS = 1 << 15
MAX_FUSED_LANES = 1 << 25


@dataclasses.dataclass(frozen=True)
class ToggleCounts:
    """Exact integer toggle totals + transition denominators for one GEMM."""

    h_toggles: int
    v_toggles: int
    h_transitions: int
    v_transitions: int

    def activities(self, b_h: int, b_v: int) -> tuple[float, float]:
        a_h = self.h_toggles / (self.h_transitions * b_h) if self.h_transitions else 0.0
        a_v = self.v_toggles / (self.v_transitions * b_v) if self.v_transitions else 0.0
        return a_h, a_v

    def __add__(self, other: "ToggleCounts") -> "ToggleCounts":
        return ToggleCounts(
            self.h_toggles + other.h_toggles,
            self.v_toggles + other.v_toggles,
            self.h_transitions + other.h_transitions,
            self.v_transitions + other.v_transitions,
        )


@dataclasses.dataclass(frozen=True)
class LaneToggleCounts:
    """Exact per-bit-lane toggle totals for one GEMM.

    ``h_lanes[b]`` / ``v_lanes[b]`` count the toggles of bus bit-lane ``b``
    (LSB first) summed over every wire bundle and transition of the
    respective direction; every lane shares the bundle's transition
    denominator, so lane activities are ``lanes / transitions`` and the
    lane sums reproduce the aggregate ``ToggleCounts`` bit-exactly
    (``sum(h_lanes) == h_toggles`` etc.).
    """

    h_lanes: tuple[int, ...]
    v_lanes: tuple[int, ...]
    h_transitions: int
    v_transitions: int

    def totals(self) -> ToggleCounts:
        return ToggleCounts(
            sum(self.h_lanes), sum(self.v_lanes), self.h_transitions, self.v_transitions
        )

    def activities(self, b_h: int, b_v: int) -> tuple[float, float]:
        return self.totals().activities(b_h, b_v)


def _fits_int16(arr: np.ndarray) -> bool:
    # Bounds are checked via min/max, NOT np.abs: abs(int64 min) wraps
    # negative and would silently admit an out-of-contract value.
    return not arr.size or (
        -INT16_SAFE_MAX <= int(arr.min()) and int(arr.max()) <= INT16_SAFE_MAX
    )


def operands_fit_fused(a: np.ndarray, w: np.ndarray) -> bool:
    """True iff both operands are int16-range, the engine's contract."""
    return _fits_int16(a) and _fits_int16(w)


def _to_device(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """Narrow a contract-checked int16-range array to int32 on the host and
    copy it to ``device`` once."""
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.int32)).to(device)


def stream_toggle_total(x: np.ndarray, bits: int, *, engine: str = "cuda") -> int:
    """Exact toggle total of a bundle of independent value streams.

    ``x`` is (T, L): L lanes, each a T-step stream of int16-range values
    toggling on a ``bits``-wide two's-complement bus.  This is the whole
    per-operand computation of the OS dataflow.
    """
    x = np.asarray(x)
    t, lanes = x.shape
    device = engine_device(engine)
    if t < 2 or lanes == 0:
        return 0
    if not _fits_int16(x):
        # validate-or-raise: a silent int32 cast would wrap out-of-contract
        # values into wrong totals
        raise ValueError(
            "fused engine needs int16-range stream values; "
            "use the numpy backend for wider values"
        )
    if lanes >= MAX_FUSED_LANES:
        raise ValueError("fused engine supports < 2^25 stream lanes")
    return int(operand_stream_toggles(_to_device(x, device), bits).item())


def _profile_os_toggles(
    a: np.ndarray, w: np.ndarray, rows: int, cols: int, b_h: int, b_v: int, engine: str
) -> ToggleCounts:
    """OS totals: per-lane operand-stream toggles scaled by the tile grid.

    Every (mt, nt) output tile streams the SAME A rows (for its mt) and the
    same W columns (for its nt) over the K axis; the fold into full-GEMM
    totals is the shared ``switching.os_stream_counts`` identity.  Edge
    tiles need no masking: summing over the true lanes of ``a``/``w``
    already covers exactly the valid PEs.
    """
    m, k = a.shape
    n = w.shape[1]
    if k < 2 or m == 0 or n == 0:
        return ToggleCounts(*os_stream_counts(0, 0, m, k, n, rows, cols))
    base_h = stream_toggle_total(np.ascontiguousarray(a.T), b_h, engine=engine)
    base_v = stream_toggle_total(w, b_v, engine=engine)
    return ToggleCounts(*os_stream_counts(base_h, base_v, m, k, n, rows, cols))


def profile_gemm_toggles(
    a: np.ndarray,
    w: np.ndarray,
    rows: int,
    cols: int,
    b_h: int,
    b_v: int,
    *,
    dataflow: str = "WS",
    engine: str = "cuda",
) -> ToggleCounts:
    """Exact toggle totals for GEMM ``a @ w`` tiled on an R x C array.

    ``a`` is (M, K), ``w`` is (K, N), integer-valued with int16-range
    magnitudes.  Counts match ``repro_torch.core.switching``'s numpy oracle
    bit-for-bit under both dataflows: for WS every ceil(K/rows)*ceil(N/cols)
    weight tile and all M stream steps; for OS every ceil(M/rows)*ceil(N/cols)
    output tile and all K reduction steps.  Bus widths ``b_h``/``b_v`` in
    [1, 64].  ``engine="cuda"`` runs the kernels on the current CUDA device,
    ``"torch"`` their plain versions on the CPU.
    """
    a = np.asarray(a)
    w = np.asarray(w)
    if a.ndim != 2 or w.ndim != 2 or a.shape[1] != w.shape[0]:
        raise ValueError(f"bad GEMM shapes {a.shape} x {w.shape}")
    if not 1 <= b_h <= 64 or not 1 <= b_v <= 64:
        raise ValueError("bus widths must be in [1, 64]")
    if dataflow not in ("WS", "OS"):
        raise ValueError(f"unknown dataflow {dataflow!r}")
    device = engine_device(engine)
    if not operands_fit_fused(a, w):
        raise ValueError(
            "fused engine needs int16-range operands (products must fit int32); "
            "use the numpy backend for wider values"
        )
    if dataflow == "OS":
        if max(a.shape[0], w.shape[1]) >= MAX_FUSED_LANES:
            raise ValueError(
                "fused OS engine supports M, N < 2^25; use the numpy backend"
            )
        return _profile_os_toggles(a, w, rows, cols, b_h, b_v, engine)
    if a.shape[1] + rows >= MAX_FUSED_K:
        raise ValueError("fused engine supports K < 2^25; use the numpy backend")
    if rows >= MAX_FUSED_ROWS:
        raise ValueError("fused engine supports rows < 2^15; use the numpy backend")
    m, k = a.shape
    n = w.shape[1]
    n_tiles = -(-n // cols) if n else 0
    h_trans = max(m - 1, 0) * k * n_tiles
    v_trans = max(m - 1, 0) * k * n
    if m < 2 or k == 0 or n == 0:
        return ToggleCounts(0, 0, h_trans, v_trans)
    h_tog, v_tog = ws_activity_toggles(
        _to_device(a, device), _to_device(w, device), rows, cols, b_h, b_v
    ).tolist()
    return ToggleCounts(h_tog, v_tog, h_trans, v_trans)


# ---------------------------------------------------------------------------
# Per-bit-lane toggle totals (lane-resolved rendering of the same counts)
# ---------------------------------------------------------------------------
#
# Bus semantics match the aggregate counts: on a bus wider than the 32-bit
# operand, lanes >= 32 of an operand stream are copies of its sign bit (they
# all flip with it), while the WS partial-sum lanes >= 32 are the true high
# bits of the int64 sum.  Each lane is taken as ``(x >> b) & 1`` of the
# XORed values; ``>>`` is arithmetic, so no value is read as unsigned.


def _expand_sign_lanes(cnt, bits: int) -> np.ndarray:
    """(compact,) device counts -> (bits,) int64 per-lane totals."""
    cnt = np.asarray(cnt, np.int64)
    if bits <= 32:
        return cnt
    return np.concatenate([cnt[:32], np.repeat(cnt[32:33], bits - 32)])


def stream_lane_toggle_totals(x: np.ndarray, bits: int, *, engine: str = "cuda") -> np.ndarray:
    """Per-bit-lane totals of ``stream_toggle_total``: (bits,) int64.

    ``x`` is (T, L) int16-range stream lanes on a ``bits``-wide bus; entry b
    counts the toggles of bus bit b summed over all L wires and T-1
    transitions (``sum(result) == stream_toggle_total(x, bits)``,
    bit-exactly).
    """
    x = np.asarray(x)
    t, lanes = x.shape
    device = engine_device(engine)
    if t < 2 or lanes == 0:
        return np.zeros(bits, np.int64)
    if not _fits_int16(x):
        raise ValueError(
            "fused engine needs int16-range stream values; "
            "use the numpy backend for wider values"
        )
    if lanes >= MAX_FUSED_LANES:
        raise ValueError("fused engine supports < 2^25 stream lanes")
    compact = stream_lane_toggles(_to_device(x, device), bits)
    return _expand_sign_lanes(compact.cpu().numpy(), bits)


def profile_gemm_lane_toggles(
    a: np.ndarray,
    w: np.ndarray,
    rows: int,
    cols: int,
    b_h: int,
    b_v: int,
    *,
    dataflow: str = "WS",
    engine: str = "cuda",
) -> LaneToggleCounts:
    """Exact per-bit-lane toggle totals for GEMM ``a @ w`` on an R x C array.

    The lane-resolved sibling of ``profile_gemm_toggles`` (same operand and
    dimension contracts, same tiling semantics under both dataflows); the
    lane sums equal the aggregate totals bit-for-bit.  ``engine="cuda"``
    launches L2 (the h lanes; both buses under OS) and L1 (the WS v lanes)
    on the current CUDA device, ``"torch"`` runs their plain versions on
    the CPU.
    """
    a = np.asarray(a)
    w = np.asarray(w)
    if a.ndim != 2 or w.ndim != 2 or a.shape[1] != w.shape[0]:
        raise ValueError(f"bad GEMM shapes {a.shape} x {w.shape}")
    if not 1 <= b_h <= 64 or not 1 <= b_v <= 64:
        raise ValueError("bus widths must be in [1, 64]")
    if dataflow not in ("WS", "OS"):
        raise ValueError(f"unknown dataflow {dataflow!r}")
    device = engine_device(engine)
    if not operands_fit_fused(a, w):
        raise ValueError(
            "fused engine needs int16-range operands (products must fit int32); "
            "use the numpy backend for wider values"
        )
    m, k = a.shape
    n = w.shape[1]

    if dataflow == "OS":
        if max(m, n) >= MAX_FUSED_LANES:
            raise ValueError(
                "fused OS engine supports M, N < 2^25; use the numpy backend"
            )
        _, _, h_trans, v_trans = os_stream_counts(0, 0, m, k, n, rows, cols)
        if k < 2 or m == 0 or n == 0:
            return LaneToggleCounts((0,) * b_h, (0,) * b_v, h_trans, v_trans)
        base_h = stream_lane_toggle_totals(np.ascontiguousarray(a.T), b_h, engine=engine)
        base_v = stream_lane_toggle_totals(w, b_v, engine=engine)
        n_tiles = -(-n // cols)
        m_tiles = -(-m // rows)
        return LaneToggleCounts(
            tuple(int(v) for v in n_tiles * base_h),
            tuple(int(v) for v in m_tiles * base_v),
            h_trans,
            v_trans,
        )

    if k + rows >= MAX_FUSED_K:
        raise ValueError("fused engine supports K < 2^25; use the numpy backend")
    if rows >= MAX_FUSED_ROWS:
        raise ValueError("fused engine supports rows < 2^15; use the numpy backend")
    n_tiles = -(-n // cols) if n else 0
    h_trans = max(m - 1, 0) * k * n_tiles
    v_trans = max(m - 1, 0) * k * n
    if m < 2 or k == 0 or n == 0:
        return LaneToggleCounts((0,) * b_h, (0,) * b_v, h_trans, v_trans)
    a_t = _to_device(a, device)
    w_t = _to_device(w, device)
    counts = torch.cat([stream_lane_toggles(a_t, b_h), ws_lane_toggles(a_t, w_t, rows, b_v)])
    counts = counts.cpu().numpy()
    h_lanes = n_tiles * _expand_sign_lanes(counts[: compact_lanes(b_h)], b_h)
    v_lanes = counts[compact_lanes(b_h) :]
    return LaneToggleCounts(
        tuple(int(v) for v in h_lanes),
        tuple(int(v) for v in v_lanes),
        h_trans,
        v_trans,
    )
