"""Bit-level switching-activity profiling of systolic-array data streams.

The paper's Eq. 6 needs the *average switching activity per bit* of every
bus, and what each bus carries is a property of the DATAFLOW
(``profile_gemm(..., dataflow=...)``):

Weight-stationary (``"WS"``, the paper's array):
  * horizontal buses (a_h): the input operands A[t, r] streamed into each
    row r of the array over the M axis;
  * vertical buses (a_v): the partial sums
    S[t, r, c] = sum_{r' <= r} A[t, r'] * W[r', c] flowing South out of
    each PE (r, c).

Output-stationary (``"OS"``): the accumulators never move; BOTH buses are
operand streams over the K (reduction) axis:
  * horizontal buses (a_h): each array row streams one A row, A[m, t];
  * vertical buses (a_v): each array column streams one W column, W[t, n].

Toggle statistics between *consecutive values on the same wire* are invariant
to the systolic pipeline skew (skew delays whole sequences; it does not
reorder them), so we profile the unskewed streams directly.

WS partial sums need up to ``2*B + ceil(log2 R)`` bits (37 for the paper's
config), so this module carries them as int64 and counts toggles on the
two's-complement representation truncated to the bus width.

Backends
--------
``profile_gemm(..., backend=...)`` dispatches between implementations of
the same integer counts (verified bit-exact against each other in tests):

  * ``"cuda"``: the hand-written CUDA kernels of
    ``repro_torch.kernels.activity_profile`` on the current CUDA device;
  * ``"torch"``: their plain PyTorch versions on the CPU;
  * ``"numpy"``: the host-side oracle below (per-tile Python loop,
    materialized (T, R, C) int64 cumsum), kept as the verification reference;
  * ``"auto"`` (default): ``"cuda"``.  Operands wider than int16, or
    dimensions beyond the engine's ``MAX_FUSED_*`` bounds, go to numpy with
    a ``ProfileDegradationWarning``; with no CUDA device ``"auto"`` raises.
    ``$REPRO_TORCH_ACTIVITY_BACKEND`` sets the default.

Exact full-stream profiling is the DEFAULT: every weight tile, every stream
step. Subsampling (``max_tiles``/``max_stream``) is an explicit opt-in and
every backend draws the identical subsample plan from the seed.

Results are memoized in a content-keyed cache (sha256 over operand bytes +
geometry + backend + dataflow); see ``clear_profile_cache`` /
``profile_cache_info``.  Lookup is layered, memory -> on-disk store
(``configure_profile_store`` or ``$REPRO_TORCH_PROFILE_STORE``) -> compute.

``profile_gemms`` profiles many GEMMs at once through the batched pipeline
(``repro_torch.core.pipeline``).  ``profile_gemm(..., lane_detail=True)``
also resolves the counts per bus bit lane, on the same backends.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import warnings
from collections import OrderedDict
from typing import Iterable

import numpy as np
import torch

from repro_torch.runtime.resilience import (
    CacheThrashWarning,
    ContractViolationError,
    ProfileDegradationWarning,
)

__all__ = [
    "BACKENDS",
    "popcount",
    "toggles_between",
    "stream_toggle_rate",
    "stream_lane_toggles",
    "horizontal_stream",
    "vertical_partial_sums",
    "os_operand_streams",
    "os_stream_counts",
    "ActivityProfile",
    "profile_tile",
    "profile_gemm",
    "profile_gemms",
    "combine_profiles",
    "clear_profile_cache",
    "profile_cache_info",
    "set_profile_cache_capacity",
    "configure_profile_store",
    "profile_store",
    "profile_store_info",
    "CacheThrashWarning",
]

BACKENDS = ("auto", "cuda", "torch", "numpy")
DEFAULT_BACKEND = os.environ.get("REPRO_TORCH_ACTIVITY_BACKEND", "auto")

_M1 = np.uint64(0x5555555555555555)
_M2 = np.uint64(0x3333333333333333)
_M4 = np.uint64(0x0F0F0F0F0F0F0F0F)
_H01 = np.uint64(0x0101010101010101)


def popcount(x: np.ndarray) -> np.ndarray:
    """Vectorized 64-bit population count (Hamming weight).

    Classic SWAR bit-twiddling; exact for any uint64 input.
    """
    x = np.asarray(x, dtype=np.uint64)
    x = x - ((x >> np.uint64(1)) & _M1)
    x = (x & _M2) + ((x >> np.uint64(2)) & _M2)
    x = (x + (x >> np.uint64(4))) & _M4
    return ((x * _H01) >> np.uint64(56)).astype(np.int64)


def _to_bus_repr(values: np.ndarray, bits: int) -> np.ndarray:
    """Two's-complement representation of ``values`` on a ``bits``-wide bus."""
    if not 1 <= bits <= 64:
        raise ValueError("bus width must be in [1, 64]")
    v = np.asarray(values).astype(np.int64)
    if bits == 64:
        return v.view(np.uint64)
    mask = np.uint64((1 << bits) - 1)
    return v.view(np.uint64) & mask


def toggles_between(a: np.ndarray, b: np.ndarray, bits: int) -> np.ndarray:
    """Number of bit flips when a ``bits``-wide bus goes from value a to b."""
    ua = _to_bus_repr(a, bits)
    ub = _to_bus_repr(b, bits)
    return popcount(ua ^ ub)


def stream_toggle_rate(stream: np.ndarray, bits: int, axis: int = 0) -> float:
    """Average toggles per bit per transition along ``axis`` of a value stream.

    For a stream of T values on one wire bundle, there are T-1 transitions;
    the rate is  mean_t popcount(x_t XOR x_{t+1}) / bits, averaged over every
    other axis (i.e. over all wires in the bundle).
    """
    s = np.asarray(stream)
    if s.shape[axis] < 2:
        return 0.0
    cur = np.take(s, range(0, s.shape[axis] - 1), axis=axis)
    nxt = np.take(s, range(1, s.shape[axis]), axis=axis)
    return float(np.mean(toggles_between(cur, nxt, bits))) / float(bits)


def stream_lane_toggles(stream: np.ndarray, bits: int, axis: int = 0) -> np.ndarray:
    """Per-bit-lane toggle totals along ``axis`` of a value stream: (bits,) int64.

    Entry b counts the flips of bus bit-lane b (LSB first) summed over every
    transition and every wire bundle in the stream; ``result.sum() ==
    bits * stream_toggle_rate(...) * transitions`` holds bit-exactly.  The
    numpy lane oracle behind ``profile_gemm(..., lane_detail=True)``.
    """
    s = np.asarray(stream)
    out = np.zeros(bits, np.int64)
    if s.shape[axis] < 2:
        return out
    cur = np.take(s, range(0, s.shape[axis] - 1), axis=axis)
    nxt = np.take(s, range(1, s.shape[axis]), axis=axis)
    x = _to_bus_repr(cur, bits) ^ _to_bus_repr(nxt, bits)
    one = np.uint64(1)
    for b in range(bits):
        out[b] = int(((x >> np.uint64(b)) & one).sum())
    return out


def horizontal_stream(a_tile: np.ndarray) -> np.ndarray:
    """The per-row horizontal bus streams for one WS tile.

    ``a_tile`` has shape (T, R): T time steps (one output row of the GEMM per
    step, in steady state) of R input operands. Row r's horizontal bus sees
    the sequence a_tile[:, r]. Returned unchanged (shape (T, R)); the stream
    axis is axis 0.
    """
    a = np.asarray(a_tile)
    if a.ndim != 2:
        raise ValueError("a_tile must be (T, R)")
    return a


def vertical_partial_sums(a_tile: np.ndarray, w_tile: np.ndarray) -> np.ndarray:
    """Partial-sum sequences on every vertical bus segment of one WS tile.

    Under weight-stationary dataflow, PE (r, c) emits
    S[t, r, c] = sum_{r' <= r} a_tile[t, r'] * w_tile[r', c] on its South bus.
    Shape: (T, R, C), int64 (exact for bus widths <= 63 bits).
    """
    a = np.asarray(a_tile, dtype=np.int64)
    w = np.asarray(w_tile, dtype=np.int64)
    if a.ndim != 2 or w.ndim != 2 or a.shape[1] != w.shape[0]:
        raise ValueError(f"bad shapes {a.shape} x {w.shape}")
    # products[t, r, c] then prefix-sum down the rows (the reduction axis).
    products = a[:, :, None] * w[None, :, :]
    return np.cumsum(products, axis=1)


def os_operand_streams(
    a_tile: np.ndarray, w_tile: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """The per-lane bus streams of one OS output tile.

    ``a_tile`` is (Mt, K) — the A rows resident on the tile's array rows —
    and ``w_tile`` is (K, Nt).  Under output-stationary dataflow the
    horizontal bus of array row r carries a_tile[r, t] over the K reduction
    steps and the vertical bus of array column c carries w_tile[t, c]; no
    partial sum ever crosses a PE boundary.  Returns ``(h_streams (K, Mt),
    v_streams (K, Nt))`` with the stream axis leading, ready for
    ``stream_toggle_rate``.
    """
    a = np.asarray(a_tile)
    w = np.asarray(w_tile)
    if a.ndim != 2 or w.ndim != 2 or a.shape[1] != w.shape[0]:
        raise ValueError(f"bad shapes {a.shape} x {w.shape}")
    return a.T, w


@dataclasses.dataclass(frozen=True)
class ActivityProfile:
    """Measured switching activities + supporting statistics for one workload.

    ``input_elements`` is the number of operand elements behind
    ``input_zero_fraction`` (0 for hand-built profiles — ``combine_profiles``
    then falls back to an unweighted mean for the zero fraction).

    ``h_lane_toggles`` / ``v_lane_toggles`` (present when profiled with
    ``lane_detail=True``) are the exact per-bit-lane toggle totals, LSB
    first: lane b of the ``b_h``/``b_v``-wide bus toggled that many times
    over ``h_transitions``/``v_transitions`` bundle transitions.  The lane
    sums reproduce the aggregate counts bit-exactly
    (``sum(h_lane_toggles) == round(a_h * h_transitions * b_h)``), and the
    mean of ``a_h_lanes`` is ``a_h`` — the aggregate activity IS the
    mean-lane approximation of the per-lane profile.  The segment-level
    layout engine consumes the per-lane arrays to price buses that carry
    only a lane subset (e.g. multi-pod partial-sum buses).
    """

    a_h: float
    a_v: float
    b_h: int
    b_v: int
    h_transitions: int
    v_transitions: int
    input_zero_fraction: float
    input_elements: int = 0
    h_lane_toggles: tuple[int, ...] | None = None
    v_lane_toggles: tuple[int, ...] | None = None

    @property
    def a_h_lanes(self) -> np.ndarray | None:
        """(b_h,) per-lane horizontal activities (toggles per transition)."""
        if self.h_lane_toggles is None:
            return None
        return np.asarray(self.h_lane_toggles, float) / max(self.h_transitions, 1)

    @property
    def a_v_lanes(self) -> np.ndarray | None:
        """(b_v,) per-lane vertical activities (toggles per transition)."""
        if self.v_lane_toggles is None:
            return None
        return np.asarray(self.v_lane_toggles, float) / max(self.v_transitions, 1)

    def as_bus_activity(self):
        from repro_torch.core.floorplan import BusActivity

        return BusActivity(a_h=self.a_h, a_v=self.a_v)

    def as_dict(self) -> dict:
        """The plain fields, JSON-ready (lane tuples become lists)."""
        d = dataclasses.asdict(self)
        for key in ("h_lane_toggles", "v_lane_toggles"):
            if d[key] is not None:
                d[key] = list(d[key])
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "ActivityProfile":
        """Inverse of ``as_dict``; also rebuilds a profile computed by the
        reference package from its field values."""
        d = dict(d)
        for key in ("h_lane_toggles", "v_lane_toggles"):
            if d.get(key) is not None:
                d[key] = tuple(int(v) for v in d[key])
        return cls(**d)


def profile_tile(
    a_tile: np.ndarray,
    w_tile: np.ndarray,
    b_h: int,
    b_v: int,
    dataflow: str = "WS",
) -> tuple[float, float, int, int]:
    """(a_h, a_v, #h transitions, #v transitions) for one R x C array tile.

    WS: ``a_tile`` is the (T, R) input stream of one weight tile,
    ``w_tile`` the resident (R, C) weights.  OS: ``a_tile`` is the (Mt, K)
    A rows of one output tile, ``w_tile`` the (K, Nt) W columns; both buses
    carry operand streams over K.
    """
    if dataflow == "OS":
        h, v = os_operand_streams(a_tile, w_tile)
        t = h.shape[0]
        a_h = stream_toggle_rate(h, b_h, axis=0)
        a_v = stream_toggle_rate(v, b_v, axis=0)
        h_trans = max(t - 1, 0) * h.shape[1]
        v_trans = max(t - 1, 0) * v.shape[1]
        return a_h, a_v, h_trans, v_trans
    if dataflow != "WS":
        raise ValueError(f"unknown dataflow {dataflow!r}")
    h = horizontal_stream(a_tile)
    v = vertical_partial_sums(a_tile, w_tile)
    t = a_tile.shape[0]
    a_h = stream_toggle_rate(h, b_h, axis=0)
    a_v = stream_toggle_rate(v, b_v, axis=0)
    h_trans = max(t - 1, 0) * h.shape[1]
    v_trans = max(t - 1, 0) * v.shape[1] * v.shape[2]
    return a_h, a_v, h_trans, v_trans


def _tile_plan(
    m: int,
    k: int,
    n: int,
    rows: int,
    cols: int,
    max_tiles: int | None,
    max_stream: int | None,
    seed: int,
) -> list[tuple[int, int, int, int, int, int]]:
    """Subsample plan: (k0, k1, n0, n1, t0, t1) per profiled tile.

    One function shared by BOTH backends so the numpy oracle and the fused
    engine see byte-identical subsamples (same rng draw order as the seed
    implementation: one tile choice, then one stream start per tile).
    Stream windows are consecutive — toggle statistics need adjacency.
    """
    rng = np.random.default_rng(seed)
    k_tiles = -(-k // rows)
    n_tiles = -(-n // cols)
    tile_ids = [(kt, nt) for kt in range(k_tiles) for nt in range(n_tiles)]
    if max_tiles is not None and len(tile_ids) > max_tiles:
        idx = rng.choice(len(tile_ids), size=max_tiles, replace=False)
        tile_ids = [tile_ids[i] for i in sorted(idx)]
    plan = []
    for kt, nt in tile_ids:
        t0, t1 = 0, m
        if max_stream is not None and m > max_stream:
            t0 = int(rng.integers(0, m - max_stream + 1))
            t1 = t0 + max_stream
        plan.append(
            (kt * rows, min((kt + 1) * rows, k), nt * cols, min((nt + 1) * cols, n), t0, t1)
        )
    return plan


def _warn_numpy_fallback(reason: str) -> None:
    # warnings dedups by (message, location), so this surfaces once per run.
    warnings.warn(
        f"profile_gemm: fused engine cannot take this GEMM ({reason}); using "
        "the slow numpy oracle. Exact full-stream profiling is the default; "
        "pass max_tiles/max_stream to bound large workloads.",
        ProfileDegradationWarning,
        stacklevel=4,
    )


def _resolve_backend(
    backend: str | None,
    a: np.ndarray,
    w: np.ndarray,
    rows: int,
    dataflow: str = "WS",
) -> str:
    backend = backend if backend is not None else DEFAULT_BACKEND
    if backend not in BACKENDS:
        raise ContractViolationError(
            f"unknown backend {backend!r}; expected one of {BACKENDS}"
        )
    if backend != "auto":
        return backend
    from repro_torch.kernels.activity_profile.ops import (
        MAX_FUSED_K,
        MAX_FUSED_LANES,
        MAX_FUSED_ROWS,
        operands_fit_fused,
    )

    # The one documented degradation, as on the reference: GEMMs outside
    # the fused engine's contract go to the numpy oracle.
    if dataflow == "OS":
        dims_ok = max(a.shape[0], w.shape[1]) < MAX_FUSED_LANES
    else:
        dims_ok = a.shape[1] + rows < MAX_FUSED_K and rows < MAX_FUSED_ROWS
    if not dims_ok:
        _warn_numpy_fallback("GEMM/array dims beyond fused-engine bounds")
        return "numpy"
    if not operands_fit_fused(a, w):
        _warn_numpy_fallback("operands wider than int16")
        return "numpy"
    if not torch.cuda.is_available():
        raise RuntimeError(
            "profile_gemm(backend='auto') runs on a CUDA device and none is "
            "available; pass backend='torch' (plain PyTorch on the CPU) or "
            "backend='numpy' (the oracle) to profile on the CPU"
        )
    return "cuda"


# --- content-keyed profile cache -------------------------------------------
# A profile is a pure function of (operands, geometry, plan), so memoize on
# content. Exact-mode keys ignore the seed (it only feeds the subsampler).
#
# Lookup is LAYERED: memory -> on-disk store -> compute.  The store
# (``repro_torch.core.profile_store``) shares the same keys across
# processes; it is enabled by ``configure_profile_store(path)`` or
# ``$REPRO_TORCH_PROFILE_STORE`` and stays off otherwise (in-process behavior
# is then the memory-only cache).

_KEY_VERSION = "v4"  # also the on-disk store's schema-version directory

_PROFILE_CACHE: OrderedDict[bytes, ActivityProfile] = OrderedDict()
_PROFILE_CACHE_CAPACITY = max(
    1, int(os.environ.get("REPRO_TORCH_PROFILE_CACHE_CAPACITY", "128"))
)
_PROFILE_CACHE_STATS = {"hits": 0, "misses": 0, "store_hits": 0, "evictions": 0}
_THRASH_WARNED = False

_PROFILE_STORE = None
_PROFILE_STORE_RESOLVED = False


def clear_profile_cache() -> None:
    """Drop the in-memory cache + reset its counters (the on-disk store, if
    configured, is NOT touched — it exists to outlive process state)."""
    global _THRASH_WARNED
    _PROFILE_CACHE.clear()
    for k in _PROFILE_CACHE_STATS:
        _PROFILE_CACHE_STATS[k] = 0
    _THRASH_WARNED = False


def profile_cache_info() -> dict:
    return {
        "size": len(_PROFILE_CACHE),
        "capacity": _PROFILE_CACHE_CAPACITY,
        **_PROFILE_CACHE_STATS,
    }


def set_profile_cache_capacity(capacity: int) -> int:
    """Set the in-memory LRU capacity (entries); returns the previous value.

    The default comes from ``$REPRO_TORCH_PROFILE_CACHE_CAPACITY`` (128 when
    unset).  A single network-scale batch that stores more profiles than
    this thrashes mid-workload (see ``CacheThrashWarning``)."""
    global _PROFILE_CACHE_CAPACITY
    if capacity < 1:
        raise ContractViolationError("cache capacity must be >= 1")
    prev = _PROFILE_CACHE_CAPACITY
    _PROFILE_CACHE_CAPACITY = int(capacity)
    while len(_PROFILE_CACHE) > _PROFILE_CACHE_CAPACITY:
        _PROFILE_CACHE.popitem(last=False)
        _PROFILE_CACHE_STATS["evictions"] += 1
    return prev


def configure_profile_store(path=None, *, max_bytes=None):
    """Enable (or with ``path=None`` disable) the on-disk profile store.

    ``path`` may also be an existing ``ProfileStore`` instance, installed
    as-is with its statistics intact (callers that temporarily swap stores
    restore the previous one this way).  Returns the active ``ProfileStore``
    (or None).  Overrides any ``$REPRO_TORCH_PROFILE_STORE`` environment
    configuration for this process."""
    global _PROFILE_STORE, _PROFILE_STORE_RESOLVED
    from repro_torch.core.profile_store import _DEFAULT_MAX_BYTES, ProfileStore

    _PROFILE_STORE_RESOLVED = True
    if path is None:
        _PROFILE_STORE = None
        return None
    if isinstance(path, ProfileStore):
        _PROFILE_STORE = path
        return _PROFILE_STORE
    _PROFILE_STORE = ProfileStore(
        path,
        max_bytes=_DEFAULT_MAX_BYTES if max_bytes is None else max_bytes,
        version=_KEY_VERSION,
    )
    return _PROFILE_STORE


def profile_store():
    """The active on-disk store: explicit configuration first, else lazily
    from ``$REPRO_TORCH_PROFILE_STORE`` (+
    ``$REPRO_TORCH_PROFILE_STORE_MAX_BYTES``), else None."""
    global _PROFILE_STORE, _PROFILE_STORE_RESOLVED
    if not _PROFILE_STORE_RESOLVED:
        _PROFILE_STORE_RESOLVED = True
        path = os.environ.get("REPRO_TORCH_PROFILE_STORE", "").strip()
        if path:
            max_bytes = os.environ.get("REPRO_TORCH_PROFILE_STORE_MAX_BYTES")
            configure_profile_store(
                path, max_bytes=int(max_bytes) if max_bytes else None
            )
    return _PROFILE_STORE


def profile_store_info() -> dict | None:
    store = profile_store()
    return None if store is None else store.info()


def _note_batch_stores(n_stored: int) -> None:
    """One-shot mid-workload thrash warning: a single batch stored more
    profiles than the memory cache holds, so jobs at the batch's end
    evicted entries its consumers (e.g. a design-space sweep re-reading
    every layer) still need."""
    global _THRASH_WARNED
    if _THRASH_WARNED or n_stored <= _PROFILE_CACHE_CAPACITY:
        return
    _THRASH_WARNED = True
    warnings.warn(
        f"one profiling batch stored {n_stored} profiles but the in-memory "
        f"cache holds only {_PROFILE_CACHE_CAPACITY}; mid-workload eviction "
        "will thrash re-reads. Raise REPRO_TORCH_PROFILE_CACHE_CAPACITY or call "
        "set_profile_cache_capacity() to fit the working set.",
        CacheThrashWarning,
        stacklevel=3,
    )


def _operand_digest(arr: np.ndarray) -> bytes:
    """Value-canonical sha256 of one operand matrix.

    int16-range data (the common case) hashes at 2 bytes/element instead of
    the upcast 8, and equal values hit the same digest regardless of input
    dtype: the same bytes as the reference package's digest.
    """
    h = hashlib.sha256()
    if arr.size and -32768 <= int(arr.min()) and int(arr.max()) <= 32767:
        arr = arr.astype(np.int16)
    h.update(arr.dtype.str.encode())
    h.update(np.ascontiguousarray(arr).tobytes())
    return h.digest()


def _cache_key(
    a: np.ndarray, w: np.ndarray, rows, cols, b_h, b_v, mode: tuple
) -> bytes:
    """Content cache key.  ``mode`` is ``(backend, dataflow, *plan)`` — the
    dataflow MUST be encoded: WS and OS profiles of identical operands and
    geometry measure different streams and must never alias.  The "v4" bump
    adds the lane-detail flag to the plan (lane-resolved profiles carry
    strictly more data than aggregate ones and must not alias them; it also
    retires any pre-lane "v3" entry shape)."""
    h = hashlib.sha256()
    h.update(
        repr((_KEY_VERSION, a.shape, w.shape, rows, cols, b_h, b_v, mode)).encode()
    )
    for arr in (a, w):
        h.update(_operand_digest(arr))
    return h.digest()


def _cache_get(key: bytes) -> tuple[ActivityProfile | None, str | None]:
    """Layered lookup (memory -> disk store); returns ``(profile, source)``
    with ``source`` in ``("memory", "store", None)``.  Hit/miss accounting
    is shared with the batch pipeline; a store hit is promoted into the
    memory LRU (without a write-back to disk)."""
    hit = _PROFILE_CACHE.get(key)
    if hit is not None:
        _PROFILE_CACHE_STATS["hits"] += 1
        _PROFILE_CACHE.move_to_end(key)
        return hit, "memory"
    store = profile_store()
    if store is not None:
        hit = store.get(key)
        if hit is not None:
            _PROFILE_CACHE_STATS["store_hits"] += 1
            _cache_put(key, hit, write_store=False)
            return hit, "store"
    _PROFILE_CACHE_STATS["misses"] += 1
    return None, None


def _cache_put(
    key: bytes, profile: ActivityProfile, *, write_store: bool = True
) -> None:
    _PROFILE_CACHE[key] = profile
    while len(_PROFILE_CACHE) > _PROFILE_CACHE_CAPACITY:
        _PROFILE_CACHE.popitem(last=False)
        _PROFILE_CACHE_STATS["evictions"] += 1
    if write_store:
        store = profile_store()
        if store is not None:
            store.put(key, profile)


def _profile_numpy(a, w, b_h, b_v, plan) -> tuple[float, float, int, int]:
    """The seed per-tile oracle loop (materializes (T, R, C) per tile)."""
    h_num = v_num = 0.0
    h_den = v_den = 0
    for k0, k1, n0, n1, t0, t1 in plan:
        ah, av, ht, vt = profile_tile(a[t0:t1, k0:k1], w[k0:k1, n0:n1], b_h, b_v)
        h_num += ah * ht
        v_num += av * vt
        h_den += ht
        v_den += vt
    a_h = h_num / h_den if h_den else 0.0
    a_v = v_num / v_den if v_den else 0.0
    return a_h, a_v, h_den, v_den


def _lane_profile_numpy(
    a: np.ndarray, w: np.ndarray, rows: int, cols: int, b_h: int, b_v: int
) -> tuple[np.ndarray, np.ndarray]:
    """Host-side WS per-lane oracle: exact (b_h,)/(b_v,) lane toggle totals.

    Materializes the per-tile (T, R, C) partial-sum tensor like the
    aggregate oracle: slow, kept as the verification reference for the
    lane passes of ``repro_torch.kernels.activity_profile.ops``.
    """
    m, k = a.shape
    n = w.shape[1]
    n_tiles = -(-n // cols) if n else 0
    h_lanes = stream_lane_toggles(a, b_h) * n_tiles
    v_lanes = np.zeros(b_v, np.int64)
    for k0 in range(0, k, rows):
        for n0 in range(0, n, cols):
            ps = vertical_partial_sums(a[:, k0 : k0 + rows], w[k0 : k0 + rows, n0 : n0 + cols])
            v_lanes += stream_lane_toggles(ps.reshape(m, -1), b_v)
    return h_lanes, v_lanes


def _lane_profile_numpy_os(
    a: np.ndarray, w: np.ndarray, rows: int, cols: int, b_h: int, b_v: int
) -> tuple[np.ndarray, np.ndarray]:
    """Host-side OS per-lane oracle (the lane form of ``_profile_numpy_os``)."""
    m, k = a.shape
    n = w.shape[1]
    if k < 2 or m == 0 or n == 0:
        return np.zeros(b_h, np.int64), np.zeros(b_v, np.int64)
    h_streams, v_streams = os_operand_streams(a, w)
    n_tiles = -(-n // cols)
    m_tiles = -(-m // rows)
    return (
        stream_lane_toggles(h_streams, b_h) * n_tiles,
        stream_lane_toggles(v_streams, b_v) * m_tiles,
    )


def os_stream_counts(
    base_h: int, base_v: int, m: int, k: int, n: int, rows: int, cols: int
) -> tuple[int, int, int, int]:
    """Fold per-lane OS stream totals into full-GEMM (h_tog, v_tog, h_trans,
    v_trans).

    Each output tile streams its A rows and W columns over the K axis, so
    the full-GEMM totals are the per-lane totals scaled by the orthogonal
    tile count (every nt repeats the A streams of its mt, and vice versa) —
    the scaling matches the transition denominators, so OS activities are
    geometry-invariant.  This is THE OS accounting identity; the numpy
    oracle and the fused engine both fold through it (only ``ref.py``
    recounts tile by tile, on purpose).
    """
    m_tiles = -(-m // rows) if m else 0
    n_tiles = -(-n // cols) if n else 0
    return (
        n_tiles * base_h,
        m_tiles * base_v,
        max(k - 1, 0) * m * n_tiles,
        max(k - 1, 0) * n * m_tiles,
    )


def _profile_numpy_os(a, w, rows, cols, b_h, b_v) -> tuple[float, float, int, int]:
    """Host-side OS oracle: per-lane operand-stream toggles, exact."""
    m, k = a.shape
    n = w.shape[1]
    if k < 2 or m == 0 or n == 0:
        _, _, h_trans, v_trans = os_stream_counts(0, 0, m, k, n, rows, cols)
        return 0.0, 0.0, h_trans, v_trans
    h_streams, v_streams = os_operand_streams(a, w)
    base_h = int(toggles_between(h_streams[:-1], h_streams[1:], b_h).sum())
    base_v = int(toggles_between(v_streams[:-1], v_streams[1:], b_v).sum())
    h_tog, v_tog, h_trans, v_trans = os_stream_counts(
        base_h, base_v, m, k, n, rows, cols
    )
    a_h = h_tog / (h_trans * b_h) if h_trans else 0.0
    a_v = v_tog / (v_trans * b_v) if v_trans else 0.0
    return a_h, a_v, h_trans, v_trans


def _profile_fused(
    a, w, rows, cols, b_h, b_v, plan, exact: bool, dataflow: str, engine: str
) -> tuple[float, float, int, int]:
    """The fused engine: exact whole-GEMM counts, or per-plan-entry for opt-in
    subsampling (each entry is a single-tile GEMM for the engine)."""
    from repro_torch.kernels.activity_profile.ops import ToggleCounts, profile_gemm_toggles

    if exact:
        counts = profile_gemm_toggles(
            a, w, rows, cols, b_h, b_v, dataflow=dataflow, engine=engine
        )
    else:
        counts = ToggleCounts(0, 0, 0, 0)
        for k0, k1, n0, n1, t0, t1 in plan:
            counts = counts + profile_gemm_toggles(
                a[t0:t1, k0:k1], w[k0:k1, n0:n1], k1 - k0, n1 - n0, b_h, b_v,
                engine=engine,
            )
    a_h, a_v = counts.activities(b_h, b_v)
    return a_h, a_v, counts.h_transitions, counts.v_transitions


def profile_gemm(
    a: np.ndarray,
    w: np.ndarray,
    rows: int,
    cols: int,
    b_h: int,
    b_v: int,
    max_tiles: int | None = None,
    max_stream: int | None = None,
    seed: int = 0,
    *,
    dataflow: str = "WS",
    backend: str | None = None,
    use_cache: bool = True,
    lane_detail: bool = False,
) -> ActivityProfile:
    """Profile the full GEMM ``a @ w`` tiled onto an R x C systolic array.

    Under ``dataflow="WS"`` the GEMM (M, K) x (K, N) is tiled into
    ceil(K/rows) * ceil(N/cols) weight tiles, each streaming all M input
    rows; under ``dataflow="OS"`` it is tiled into ceil(M/rows) *
    ceil(N/cols) output tiles, each streaming both operands over the K
    reduction axis (see the module docstring for what each bus carries).

    By default the profile is EXACT — every tile, every stream step (the
    fused engine makes this cheap). Pass ``max_tiles``/``max_stream`` to opt
    into the legacy WS subsampled estimate (consecutive stream windows —
    toggle statistics need adjacency); both backends then draw the identical
    subsample from ``seed``.  OS profiling is exact-only: its work is
    O(M*K + K*N) with no partial-sum tensor anywhere, so there is nothing
    worth subsampling (passing the limits with OS raises).

    ``backend`` is one of ``BACKENDS`` (see the module docstring); None
    takes ``$REPRO_TORCH_ACTIVITY_BACKEND``, else ``"auto"``.

    ``lane_detail=True`` additionally measures the exact per-bit-lane toggle
    totals (``ActivityProfile.h_lane_toggles``/``v_lane_toggles``; the
    aggregate activities are then derived from the lane sums, so aggregate
    and lanes can never disagree).  ``"cuda"`` runs the lane passes on the
    card, ``"torch"`` on the CPU, ``"numpy"`` the lane oracle.
    Lane-resolved profiling is exact-only (combining it with the subsample
    limits raises) and costs a pass per bus lane where the aggregate
    kernels run one popcount, so it is an explicit opt-in.
    """
    a = np.asarray(a, dtype=np.int64)
    w = np.asarray(w, dtype=np.int64)
    if a.ndim != 2 or w.ndim != 2 or a.shape[1] != w.shape[0]:
        raise ValueError(f"bad GEMM shapes {a.shape} x {w.shape}")
    if dataflow not in ("WS", "OS"):
        raise ValueError(f"unknown dataflow {dataflow!r}")
    if dataflow == "OS" and (max_tiles is not None or max_stream is not None):
        raise ValueError("OS profiling is exact-only; max_tiles/max_stream apply to WS")
    m, k = a.shape
    _, n = w.shape

    # "Effective" mode: subsampling limits that don't bind are exact.
    total_tiles = (-(-k // rows)) * (-(-n // cols))
    exact = not (
        (max_tiles is not None and total_tiles > max_tiles)
        or (max_stream is not None and m > max_stream)
    )
    if lane_detail and not exact:
        raise ValueError(
            "lane_detail requires exact profiling; drop max_tiles/max_stream"
        )
    mode: tuple = ("exact",) if exact else ("sub", max_tiles, max_stream, seed)
    if lane_detail:
        mode = (*mode, "lanes")

    # Resolve the backend BEFORE the cache lookup and key on it: an explicit
    # backend= request (oracle cross-checks, timing) must never be served
    # another backend's result.
    resolved = _resolve_backend(backend, a, w, rows, dataflow)

    key = None
    if use_cache:
        key = _cache_key(a, w, rows, cols, b_h, b_v, (resolved, dataflow, *mode))
        hit, _ = _cache_get(key)
        if hit is not None:
            return hit

    h_lanes = v_lanes = None
    if lane_detail:
        if resolved == "numpy":
            lane_fn = _lane_profile_numpy_os if dataflow == "OS" else _lane_profile_numpy
            h_lanes, v_lanes = lane_fn(a, w, rows, cols, b_h, b_v)
            if dataflow == "OS":
                _, _, h_den, v_den = os_stream_counts(0, 0, m, k, n, rows, cols)
            else:
                n_tiles = -(-n // cols) if n else 0
                h_den = max(m - 1, 0) * k * n_tiles
                v_den = max(m - 1, 0) * k * n
        else:
            from repro_torch.kernels.activity_profile.ops import profile_gemm_lane_toggles

            lc = profile_gemm_lane_toggles(
                a, w, rows, cols, b_h, b_v, dataflow=dataflow, engine=resolved
            )
            h_lanes = np.asarray(lc.h_lanes, np.int64)
            v_lanes = np.asarray(lc.v_lanes, np.int64)
            h_den, v_den = lc.h_transitions, lc.v_transitions
        a_h = int(h_lanes.sum()) / (h_den * b_h) if h_den else 0.0
        a_v = int(v_lanes.sum()) / (v_den * b_v) if v_den else 0.0
    elif resolved == "numpy":
        if dataflow == "OS":
            a_h, a_v, h_den, v_den = _profile_numpy_os(a, w, rows, cols, b_h, b_v)
        else:
            plan = _tile_plan(m, k, n, rows, cols, max_tiles, max_stream, seed)
            a_h, a_v, h_den, v_den = _profile_numpy(a, w, b_h, b_v, plan)
    else:
        plan = None
        if not exact:
            plan = _tile_plan(m, k, n, rows, cols, max_tiles, max_stream, seed)
        a_h, a_v, h_den, v_den = _profile_fused(
            a, w, rows, cols, b_h, b_v, plan, exact, dataflow, resolved
        )

    profile = ActivityProfile(
        a_h=a_h,
        a_v=a_v,
        b_h=b_h,
        b_v=b_v,
        h_transitions=h_den,
        v_transitions=v_den,
        input_zero_fraction=float(np.mean(a == 0)),
        input_elements=int(a.size),
        h_lane_toggles=None if h_lanes is None else tuple(int(v) for v in h_lanes),
        v_lane_toggles=None if v_lanes is None else tuple(int(v) for v in v_lanes),
    )
    if key is not None:
        _cache_put(key, profile)
    return profile


def profile_gemms(jobs, **kwargs):
    """Batch API: profile MANY GEMMs as a handful of device programs.

    ``jobs`` is a sequence of ``repro_torch.core.pipeline.ProfileJob`` (each
    carrying its own dataflow); returns the profiles in input order. Jobs
    are deduped against the content-keyed cache, bucketed into shared padded
    shape classes, dispatched asynchronously (device work overlaps the next
    bucket's host-side operand synthesis), and identical operands profiled
    across several (rows, cols) geometries share one device pass (OS jobs
    share geometry-FREE operand-stream passes).  Counts are bit-exact vs
    per-job ``profile_gemm``.  See ``repro_torch.core.pipeline``
    (``run_profile_batch`` returns scheduling statistics as well).
    """
    from repro_torch.core.pipeline import run_profile_batch

    profiles, _ = run_profile_batch(jobs, **kwargs)
    return profiles


def combine_profiles(profiles: Iterable[ActivityProfile]) -> ActivityProfile:
    """Weighted average of several per-layer profiles.

    Activities are transition-count-weighted; ``input_zero_fraction`` is
    element-count-weighted (a 10-element layer must not count as much as a
    10M-element one). If ANY profile lacks an element count
    (``input_elements == 0``, e.g. hand-built), the zero fraction falls back
    to an unweighted mean over all profiles — no profile is silently
    dropped from it.  Per-bit-lane toggle totals combine by elementwise sum
    (lane counts are additive) when EVERY profile carries them at matching
    widths, else the combined profile drops them.
    """
    profiles = list(profiles)
    if not profiles:
        raise ValueError("no profiles to combine")
    b_h, b_v = profiles[0].b_h, profiles[0].b_v

    def _sum_lanes(attr):
        vals = [getattr(p, attr) for p in profiles]
        if any(v is None for v in vals) or len({len(v) for v in vals}) != 1:
            return None
        total = np.sum([np.asarray(v, np.int64) for v in vals], axis=0)
        return tuple(int(v) for v in total)

    h_den = sum(p.h_transitions for p in profiles)
    v_den = sum(p.v_transitions for p in profiles)
    a_h = sum(p.a_h * p.h_transitions for p in profiles) / max(h_den, 1)
    a_v = sum(p.a_v * p.v_transitions for p in profiles) / max(v_den, 1)
    if all(p.input_elements > 0 for p in profiles):
        elems = sum(p.input_elements for p in profiles)
        zf = sum(p.input_zero_fraction * p.input_elements for p in profiles) / elems
    else:
        # Unweighted fallback: report elements as unknown (0) so a nested
        # combine doesn't element-weight a fraction that never was.
        elems = 0
        zf = float(np.mean([p.input_zero_fraction for p in profiles]))
    return ActivityProfile(
        a_h=a_h,
        a_v=a_v,
        b_h=b_h,
        b_v=b_v,
        h_transitions=h_den,
        v_transitions=v_den,
        input_zero_fraction=float(zf),
        input_elements=elems,
        h_lane_toggles=_sum_lanes("h_lane_toggles"),
        v_lane_toggles=_sum_lanes("v_lane_toggles"),
    )
