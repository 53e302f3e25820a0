"""Numpy oracle for the fused activity engine: exact integer toggle counts.

Deliberately does the work the fused engines avoid, so the two
implementations share no code and a match is meaningful:

  * WS — materializes the (T, R, C) partial-sum tensor per tile via
    ``repro_torch.core.switching.vertical_partial_sums`` + XOR-popcount.
  * OS — loops every ceil(M/rows) * ceil(N/cols) OUTPUT tile and counts its
    operand-stream toggles tile by tile (the fused engine instead counts
    each lane once and scales by the orthogonal tile count).

Used by tests (bit-exact comparison).
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.switching import toggles_between, vertical_partial_sums

__all__ = ["profile_gemm_toggles_ref"]


def profile_gemm_toggles_ref(
    a: np.ndarray,
    w: np.ndarray,
    rows: int,
    cols: int,
    b_h: int,
    b_v: int,
    dataflow: str = "WS",
) -> tuple[int, int, int, int]:
    """(h_toggles, v_toggles, h_transitions, v_transitions) for a full GEMM."""
    a = np.asarray(a, dtype=np.int64)
    w = np.asarray(w, dtype=np.int64)
    if a.ndim != 2 or w.ndim != 2 or a.shape[1] != w.shape[0]:
        raise ValueError(f"bad GEMM shapes {a.shape} x {w.shape}")
    if dataflow == "OS":
        return _profile_os_ref(a, w, rows, cols, b_h, b_v)
    if dataflow != "WS":
        raise ValueError(f"unknown dataflow {dataflow!r}")
    m, k = a.shape
    n = w.shape[1]
    k_tiles = -(-k // rows) if k else 0
    n_tiles = -(-n // cols) if n else 0
    h_tog = v_tog = 0
    for kt in range(k_tiles):
        k0, k1 = kt * rows, min((kt + 1) * rows, k)
        a_tile = a[:, k0:k1]
        h_tile = int(toggles_between(a_tile[:-1], a_tile[1:], b_h).sum()) if m > 1 else 0
        for nt in range(n_tiles):
            n0, n1 = nt * cols, min((nt + 1) * cols, n)
            v = vertical_partial_sums(a_tile, w[k0:k1, n0:n1])
            if m > 1:
                v_tog += int(toggles_between(v[:-1], v[1:], b_v).sum())
            h_tog += h_tile
    h_trans = max(m - 1, 0) * k * n_tiles
    v_trans = max(m - 1, 0) * k * n
    return h_tog, v_tog, h_trans, v_trans


def _profile_os_ref(
    a: np.ndarray, w: np.ndarray, rows: int, cols: int, b_h: int, b_v: int
) -> tuple[int, int, int, int]:
    """OS oracle: walk every output tile, toggle its own operand streams."""
    m, k = a.shape
    n = w.shape[1]
    m_tiles = -(-m // rows) if m else 0
    n_tiles = -(-n // cols) if n else 0
    h_tog = v_tog = 0
    for mt in range(m_tiles):
        m0, m1 = mt * rows, min((mt + 1) * rows, m)
        # horizontal: each array row streams one A row over the K axis
        h_stream = a[m0:m1, :].T  # (K, rows_valid)
        h_tile = (
            int(toggles_between(h_stream[:-1], h_stream[1:], b_h).sum()) if k > 1 else 0
        )
        for nt in range(n_tiles):
            n0, n1 = nt * cols, min((nt + 1) * cols, n)
            # vertical: each array column streams one W column over K
            v_stream = w[:, n0:n1]  # (K, cols_valid)
            if k > 1:
                v_tog += int(toggles_between(v_stream[:-1], v_stream[1:], b_v).sum())
            h_tog += h_tile
    h_trans = max(k - 1, 0) * m * n_tiles
    v_trans = max(k - 1, 0) * n * m_tiles
    return h_tog, v_tog, h_trans, v_trans
