"""Systolic array functional + timing models, parameterized by dataflow.

Two dataflows, one ``Dataflow`` abstraction (see ``DATAFLOWS``):

Weight-stationary (WS)
    Weights resident per (K x N) tile; the M input rows stream horizontally
    and partial sums reduce down the columns.  For one R x C tile over a
    T-step stream:

        cycles(tile) = weight_load + fill/drain + stream
                     = R + (R + C - 2) + T

    (rows of weights loaded one per cycle; the wavefront needs R + C - 2
    cycles to fill and drain; one output column per cycle in steady state).
    Tile grid: ceil(K/rows) x ceil(N/cols); stream length T = M.

Output-stationary (OS)
    Accumulators resident per (M x N) output tile; BOTH operands stream —
    A rows West->East on the horizontal buses, W columns North->South on
    the vertical buses — for the K reduction steps, then the finished
    outputs drain.  SCALE-sim-style timing for one R x C tile:

        cycles(tile) = fill/drain skew + stream + output drain
                     = (R + C - 2) + K + R

    (the operand wavefronts need R + C - 2 cycles of skew; K reduction
    steps in steady state; accumulators shift out one per column per cycle,
    R cycles).  Tile grid: ceil(M/rows) x ceil(N/cols); stream length = K.

Functional models (``ws_matmul_reference`` / ``os_matmul_reference``) are
exact tiled executions of ``A @ W`` on torch tensors in the same tile order
the hardware uses, validated against the reference package's models in
tests.

Utilization = useful MAC-cycles / (R * C * total cycles) for both.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence

import torch

__all__ = [
    "Dataflow",
    "DATAFLOWS",
    "get_dataflow",
    "TileSchedule",
    "ws_tile_cycles",
    "os_tile_cycles",
    "schedule_gemm",
    "ws_matmul_reference",
    "os_matmul_reference",
    "matmul_reference",
    "SAUtilization",
    "schedule_many",
]


@dataclasses.dataclass(frozen=True)
class TileSchedule:
    """Static schedule of one GEMM on an R x C systolic array.

    ``m_tiles``/``k_tiles``/``n_tiles`` count the tiling along each GEMM
    axis under the schedule's dataflow; the axis that streams through time
    (M for WS, K for OS) has a tile count of 1 and its extent is
    ``stream_len``.
    """

    m: int
    k: int
    n: int
    rows: int
    cols: int
    k_tiles: int
    n_tiles: int
    total_tiles: int
    cycles_per_tile: int
    total_cycles: int
    useful_macs: int
    peak_macs: int
    dataflow: str = "WS"
    m_tiles: int = 1
    stream_len: int = 0

    @property
    def utilization(self) -> float:
        return self.useful_macs / self.peak_macs if self.peak_macs else 0.0


def ws_tile_cycles(rows: int, cols: int, stream_len: int) -> int:
    """Cycles for one WS tile: weight load + wavefront fill/drain + stream."""
    return rows + (rows + cols - 2) + stream_len


def os_tile_cycles(rows: int, cols: int, k_len: int) -> int:
    """Cycles for one OS tile: wavefront skew + K-reduction stream + output
    drain (accumulators shift out of the array, one per column per cycle)."""
    return (rows + cols - 2) + k_len + rows


def ws_matmul_reference(a: torch.Tensor, w: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """Tiled WS execution of ``a @ w`` (exact, same tile order as hardware).

    Iterates weight tiles (K-major then N), accumulating each tile's column
    reduction into the output: the software analogue of preloading W[k0:k1,
    n0:n1] and streaming all M input rows. A Python loop over tiles is fine:
    this is a correctness oracle, not a fast path.
    """
    if a.ndim != 2 or w.ndim != 2 or a.shape[1] != w.shape[0]:
        raise ValueError(f"bad shapes {tuple(a.shape)} x {tuple(w.shape)}")
    m, k = a.shape
    _, n = w.shape
    acc_dtype = _acc_dtype(a, w)
    out = torch.zeros((m, n), dtype=acc_dtype, device=a.device)
    for k0 in range(0, k, rows):
        k1 = min(k0 + rows, k)
        for n0 in range(0, n, cols):
            n1 = min(n0 + cols, n)
            a_tile = a[:, k0:k1].to(acc_dtype)
            w_tile = w[k0:k1, n0:n1].to(acc_dtype)
            out[:, n0:n1] += a_tile @ w_tile
    return out


def os_matmul_reference(a: torch.Tensor, w: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """Tiled OS execution of ``a @ w`` (exact, same tile order as hardware).

    Iterates OUTPUT tiles (M-major then N); each tile's accumulators stay
    put while both operands stream through the K reduction in chunks: the
    software analogue of resident C[m0:m1, n0:n1] fed by the A-row and
    W-column streams. Like ``ws_matmul_reference`` this is a correctness
    oracle, not a fast path.
    """
    if a.ndim != 2 or w.ndim != 2 or a.shape[1] != w.shape[0]:
        raise ValueError(f"bad shapes {tuple(a.shape)} x {tuple(w.shape)}")
    m, k = a.shape
    _, n = w.shape
    acc_dtype = _acc_dtype(a, w)
    out = torch.zeros((m, n), dtype=acc_dtype, device=a.device)
    k_chunk = max(1, rows)
    for m0 in range(0, m, rows):
        m1 = min(m0 + rows, m)
        for n0 in range(0, n, cols):
            n1 = min(n0 + cols, n)
            acc = torch.zeros((m1 - m0, n1 - n0), dtype=acc_dtype, device=a.device)
            for k0 in range(0, k, k_chunk):
                k1 = min(k0 + k_chunk, k)
                acc = acc + a[m0:m1, k0:k1].to(acc_dtype) @ w[k0:k1, n0:n1].to(acc_dtype)
            out[m0:m1, n0:n1] = acc
    return out


def _acc_dtype(a: torch.Tensor, w: torch.Tensor) -> torch.dtype:
    """Integer operands accumulate in at least int32, floats in float32."""
    if a.dtype.is_floating_point:
        return torch.float32
    return torch.promote_types(torch.promote_types(a.dtype, w.dtype), torch.int32)


@dataclasses.dataclass(frozen=True)
class Dataflow:
    """One systolic dataflow: tiling, timing, and functional semantics.

    ``tile_grid(m, k, n, rows, cols)`` returns (m_tiles, k_tiles, n_tiles);
    ``stream_len(m, k, n)`` is the per-tile time extent;
    ``tile_cycles(rows, cols, stream_len)`` the per-tile cycle count;
    ``matmul_reference`` the exact tiled functional model.
    """

    name: str
    tile_grid: Callable[[int, int, int, int, int], tuple[int, int, int]]
    stream_len: Callable[[int, int, int], int]
    tile_cycles: Callable[[int, int, int], int]
    matmul_reference: Callable[[torch.Tensor, torch.Tensor, int, int], torch.Tensor]


DATAFLOWS: dict[str, Dataflow] = {
    "WS": Dataflow(
        name="WS",
        tile_grid=lambda m, k, n, rows, cols: (
            1,
            math.ceil(k / rows),
            math.ceil(n / cols),
        ),
        stream_len=lambda m, k, n: m,
        tile_cycles=ws_tile_cycles,
        matmul_reference=ws_matmul_reference,
    ),
    "OS": Dataflow(
        name="OS",
        tile_grid=lambda m, k, n, rows, cols: (
            math.ceil(m / rows),
            1,
            math.ceil(n / cols),
        ),
        stream_len=lambda m, k, n: k,
        tile_cycles=os_tile_cycles,
        matmul_reference=os_matmul_reference,
    ),
}


def get_dataflow(dataflow: str | Dataflow) -> Dataflow:
    if isinstance(dataflow, Dataflow):
        return dataflow
    try:
        return DATAFLOWS[dataflow]
    except KeyError:
        raise ValueError(
            f"unknown dataflow {dataflow!r}; expected one of {tuple(DATAFLOWS)}"
        ) from None


def schedule_gemm(
    m: int, k: int, n: int, rows: int, cols: int, dataflow: str | Dataflow = "WS"
) -> TileSchedule:
    """Tile an (M,K)x(K,N) GEMM onto an R x C array and count cycles."""
    if min(m, k, n, rows, cols) <= 0:
        raise ValueError("all dims must be positive")
    df = get_dataflow(dataflow)
    m_tiles, k_tiles, n_tiles = df.tile_grid(m, k, n, rows, cols)
    total_tiles = m_tiles * k_tiles * n_tiles
    stream = df.stream_len(m, k, n)
    cpt = df.tile_cycles(rows, cols, stream)
    total_cycles = total_tiles * cpt
    useful = m * k * n  # one MAC per (m, k, n) triple
    peak = rows * cols * total_cycles
    return TileSchedule(
        m=m,
        k=k,
        n=n,
        rows=rows,
        cols=cols,
        k_tiles=k_tiles,
        n_tiles=n_tiles,
        total_tiles=total_tiles,
        cycles_per_tile=cpt,
        total_cycles=total_cycles,
        useful_macs=useful,
        peak_macs=peak,
        dataflow=df.name,
        m_tiles=m_tiles,
        stream_len=stream,
    )


def matmul_reference(
    a: torch.Tensor, w: torch.Tensor, rows: int, cols: int, dataflow: str | Dataflow = "WS"
) -> torch.Tensor:
    """Exact tiled execution of ``a @ w`` under the given dataflow."""
    return get_dataflow(dataflow).matmul_reference(a, w, rows, cols)


@dataclasses.dataclass(frozen=True)
class SAUtilization:
    """Aggregate timing over a set of GEMMs (e.g. a full network)."""

    total_cycles: int
    useful_macs: int
    peak_macs: int

    @property
    def utilization(self) -> float:
        return self.useful_macs / self.peak_macs if self.peak_macs else 0.0


def schedule_many(
    gemms: Sequence[tuple[int, int, int]],
    rows: int,
    cols: int,
    dataflow: str | Dataflow = "WS",
) -> SAUtilization:
    total_cycles = 0
    useful = 0
    for m, k, n in gemms:
        s = schedule_gemm(m, k, n, rows, cols, dataflow=dataflow)
        total_cycles += s.total_cycles
        useful += s.useful_macs
    return SAUtilization(
        total_cycles=total_cycles,
        useful_macs=useful,
        peak_macs=rows * cols * total_cycles,
    )
