"""Toggle-counting kernels of the activity profiler and their plain versions.

Six kernels, written for Hopper.  Two per-GEMM kernels:

  * K1 ``ws_activity_toggles`` (``csrc/activity_profile.cu``) replaces
    ``activity_profile_pallas``
    (``src/repro/kernels/activity_profile/kernel.py``): exact (h, v) toggle
    totals of a whole weight-stationary GEMM.
  * K4 ``operand_stream_toggles`` replaces ``operand_stream_toggles_pallas``
    (same file): the exact toggle total of a (T, L) bundle of independent
    operand lane streams, the per-GEMM work of the output-stationary
    dataflow.  That is K5's function on an int32 stream, so its wrapper
    launches K5's kernel (``csrc/toggle_count.cu`` ``stream_toggles``) and
    keeps a count of its own.

two batched kernels of the profiling pipeline, over the stacked
seeded windows of ``repro_torch.kernels.activity_profile.batch``:

  * K2 ``ws_task_toggles`` (``csrc/activity_batch.cu``) replaces
    ``activity_profile_pallas_tasks``: the vertical-bus toggles of each
    stacked weight-stationary segment task.
  * K3 ``strip_toggles`` replaces ``stream_strips_toggles_pallas``: the
    toggles of each stacked stream window (OS operand streams, and the WS
    horizontal pass).  A window is a (T1, L) stream whose row 0 seeds it,
    so K3 runs K5's column walk over each window
    (``csrc/toggle_count.cu`` ``strip_toggles``).

and two per-lane kernels of the lane-resolved profile
(``csrc/lane_toggles.cu``), whose reference is an XLA program, not a
Pallas kernel:

  * L1 ``ws_lane_toggles`` computes what ``_v_lane_toggles_xla``
    (``src/repro/kernels/activity_profile/ops.py``) does: the toggles of
    each bit lane of every weight-stationary partial-sum bus.
  * L2 ``stream_lane_toggles`` computes what ``_h_lane_toggles_xla`` does:
    the toggles of each bit lane of a (T, L) bundle of lane streams (the WS
    horizontal pass and both OS operand streams).

The note at the top of each source says what bounds each kernel on the
card and what its design does about it.  Each wrapper takes int32 tensors
and returns int64 counts on the operands' device.  For CPU tensors it runs
the plain PyTorch version beside it; for CUDA tensors it launches the
kernel, adds one to its ``launches`` count, and raises if the launch is
refused.  The plain versions also run on CUDA tensors when called directly,
which is how the kernels are checked on the card.
"""

from __future__ import annotations

import torch

from repro_torch.kernels._engine import launch, on_cpu
from repro_torch.kernels.bitops import bus_mask, popcount64

__all__ = [
    "PLAIN_BLOCK_ELEMENTS",
    "DEFAULT_BLOCK_BUDGET",
    "MAX_BLOCK_T",
    "MIN_BLOCK_T",
    "TASK_CHUNK_BUDGET",
    "WS_KERNEL_STEPS",
    "WS_TASK_SHORT_STEPS",
    "WS_TASK_STEPS",
    "choose_block_t",
    "choose_task_chunk",
    "ws_task_toggles",
    "ws_task_toggles_plain",
    "strip_toggles",
    "strip_toggles_plain",
    "ws_activity_toggles",
    "ws_activity_toggles_plain",
    "operand_stream_toggles",
    "operand_stream_toggles_plain",
    "LANE_BLOCK_ELEMENTS",
    "compact_lanes",
    "ws_lane_toggles",
    "ws_lane_toggles_plain",
    "stream_lane_toggles",
    "stream_lane_toggles_plain",
]

# Largest int64 partial-sum block a plain version materializes at once.
PLAIN_BLOCK_ELEMENTS = 1 << 22

# Time transitions each K1 thread counts from its recomputed seed row
# (``kSteps`` in ``csrc/activity_profile.cu``); the plain version with
# ``block_t=WS_KERNEL_STEPS`` cuts time as the kernel does.
WS_KERNEL_STEPS = 15

# Time transitions each K2 thread counts from its recomputed seed row
# (``kLongRun`` / ``kShortRun`` in ``csrc/activity_batch.cu``): runs of 16,
# or of 8 where t_seg % 16 is 1 to 8; the plain version with ``run_t`` set
# to the same cuts time as the kernel does.
WS_TASK_STEPS = 16
WS_TASK_SHORT_STEPS = 8

# The reference engine's time-block budget: block_t * rows * cols plane
# elements.  Not a limit of the kernels here; the batched pipeline's shape
# classes (``core.pipeline._bucket_key``) are sized by it, so the port
# buckets, and counts its passes, exactly as the reference does.
DEFAULT_BLOCK_BUDGET = 1 << 20
MAX_BLOCK_T = 512
MIN_BLOCK_T = 8

# Tasks per step of K2's plain version: one step carries a
# (chunk, t_seg + 1, cols) int64 partial-sum plane of about this many
# elements.  On the CPU a small plane keeps its temporaries in a core's
# cache; on the card, where every elementwise step is a launch, a large one
# keeps the launch count down.
TASK_CHUNK_BUDGET = {"cpu": 1 << 17, "cuda": 1 << 20}


def choose_block_t(rows: int, cols: int, budget: int = DEFAULT_BLOCK_BUDGET) -> int:
    """Time-block size: as many steps as the element budget allows, 8-aligned."""
    bt = budget // max(rows * cols, 1)
    bt = max(MIN_BLOCK_T, min(MAX_BLOCK_T, bt))
    return bt - (bt % MIN_BLOCK_T)


def choose_task_chunk(num_tasks: int, t_seg1: int, cols: int, device_type: str = "cpu") -> int:
    """Tasks per step of K2's plain version on a ``device_type`` device,
    balanced so that the last step is not mostly empty."""
    chunk = max(8, TASK_CHUNK_BUDGET[device_type] // max(t_seg1 * cols, 1))
    if num_tasks <= chunk:
        return max(1, num_tasks)
    steps = -(-num_tasks // chunk)
    return -(-num_tasks // steps)


def _check_bits(*bits: int) -> None:
    if not all(1 <= b <= 64 for b in bits):
        raise ValueError("bus widths must be in [1, 64]")


def _check_operand(x: torch.Tensor, name: str, device: torch.device, ndim: int = 2) -> None:
    if not isinstance(x, torch.Tensor) or x.ndim != ndim:
        raise ValueError(f"{name} must be a {ndim}-D tensor")
    if x.dtype != torch.int32:
        raise TypeError(f"{name} must be int32, got {x.dtype}")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if max(x.shape) >= 2**31:
        raise ValueError(f"{name} is too large for 32-bit extents")


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
    if on_cpu(a, "ws_activity_toggles"):
        return ws_activity_toggles_plain(a, w, rows, cols, b_h, b_v)
    m, k = a.shape
    n = w.shape[1]
    if m < 2 or k == 0 or n == 0:
        return torch.zeros(2, dtype=torch.int64, device=a.device)
    out = torch.empty(2, dtype=torch.int64, device=a.device)  # the C entry zeroes it
    launch(
        "activity_profile", "ws_activity_toggles", a.device,
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
    device.  Lane l carries x[:, l]; lanes never mix.

    On the card this launches K5's kernel (``stream_toggles`` of
    ``csrc/toggle_count.cu``) and counts the launch here, not on K5's
    wrapper."""
    _check_operand(x, "x", x.device)
    _check_bits(bits)
    if on_cpu(x, "operand_stream_toggles"):
        return operand_stream_toggles_plain(x, bits)
    t, lanes = x.shape
    if t < 2 or lanes == 0:
        return torch.zeros(1, dtype=torch.int64, device=x.device)
    out = torch.empty(1, dtype=torch.int64, device=x.device)  # the C entry zeroes it
    launch(
        "toggle_count", "stream_toggles", x.device,
        x.data_ptr(), out.data_ptr(), t, lanes, x.element_size(), bus_mask(bits) & (2**64 - 1),
    )
    operand_stream_toggles.launches += 1
    return out


operand_stream_toggles.launches = 0


def ws_task_toggles_plain(
    strips: torch.Tensor,
    w_tiles: torch.Tensor,
    strip_ids: torch.Tensor,
    w_ids: torch.Tensor,
    valid_r: torch.Tensor,
    b_v: int,
    *,
    task_chunk: int | None = None,
    run_t: int | None = None,
) -> torch.Tensor:
    """Plain PyTorch version of K2: (P,) int64 vertical-bus toggles per task.

    Walks the tasks ``task_chunk`` at a time (default ``choose_task_chunk``)
    and, within a chunk, the reduction rows, carrying the (chunk, t_seg + 1,
    cols) int64 partial-sum planes as the reference's task kernel does; row
    r counts only for tasks with r < valid_r.  ``run_t`` cuts each task's
    t_seg transitions into runs of that many, each carrying its own planes
    from its recomputed seed row, as the kernel's threads do (default: one
    run).  A task whose ids are out of range gets -1, as on the kernel.
    """
    num_tasks = strip_ids.shape[0]
    num_strips, t1, rows = strips.shape
    num_tiles, _, cols = w_tiles.shape
    out = torch.zeros(num_tasks, dtype=torch.int64, device=strips.device)
    if num_tasks == 0 or t1 < 2:
        return out
    sid = strip_ids.to(torch.int64)
    wid = w_ids.to(torch.int64)
    ok = (sid >= 0) & (sid < num_strips) & (wid >= 0) & (wid < num_tiles)
    sid = torch.where(ok, sid, 0)
    wid = torch.where(ok, wid, 0)
    vr = torch.where(ok, valid_r.to(torch.int64).clamp(0, rows), 0)
    if task_chunk is None:
        task_chunk = choose_task_chunk(num_tasks, t1, cols, strips.device.type)
    if run_t is None:
        run_t = t1 - 1
    mask = bus_mask(b_v)
    for p0 in range(0, num_tasks, task_chunk):
        sl = slice(p0, p0 + task_chunk)
        vr_c = vr[sl]
        depth = int(vr_c.max())  # rows past every task's valid_r count nothing
        if depth == 0:
            continue
        w = w_tiles[wid[sl]].to(torch.int64)  # (chunk, rows, cols)
        for t0 in range(1, t1, run_t):
            # (chunk, run_t + 1, rows): the run's seed row t0 - 1 and its steps
            a = strips[sid[sl], t0 - 1 : t0 + run_t].to(torch.int64)
            s = torch.zeros((a.shape[0], a.shape[1], cols), dtype=torch.int64, device=strips.device)
            for r in range(depth):
                s += a[:, :, r, None] * w[:, None, r, :]
                cnt = popcount64((s[:, 1:] ^ s[:, :-1]) & mask).sum(dim=(1, 2))
                out[sl] += torch.where(r < vr_c, cnt, 0)
    return torch.where(ok, out, -1)


def ws_task_toggles(
    strips: torch.Tensor,
    w_tiles: torch.Tensor,
    strip_ids: torch.Tensor,
    w_ids: torch.Tensor,
    valid_r: torch.Tensor,
    b_v: int,
) -> torch.Tensor:
    """K2: exact vertical-bus toggles of each stacked WS segment task, as a
    (P,) int64 tensor on ``strips``' device.

    ``strips`` is (S, t_seg + 1, rows), seeded windows of activation rows
    (row 0 of each is the value just before the window); ``w_tiles`` is
    (W, rows, cols); ``strip_ids``, ``w_ids`` and ``valid_r`` are (P,): task
    p runs strip ``strip_ids[p]`` through tile ``w_ids[p]`` and counts the
    partial sums of its first ``valid_r[p]`` reduction rows (the rest are K
    padding; ``valid_r == 0`` turns a task off).  All int32 with
    int16-range operand values.
    """
    device = strips.device
    _check_operand(strips, "strips", device, ndim=3)
    _check_operand(w_tiles, "w_tiles", device, ndim=3)
    for x, name in ((strip_ids, "strip_ids"), (w_ids, "w_ids"), (valid_r, "valid_r")):
        _check_operand(x, name, device, ndim=1)
        if x.shape[0] != strip_ids.shape[0]:
            raise ValueError("strip_ids, w_ids and valid_r must have one entry per task")
    if w_tiles.shape[1] != strips.shape[2]:
        raise ValueError(
            f"strips have {strips.shape[2]} rows but w_tiles {w_tiles.shape[1]}"
        )
    if strips.shape[1] < 2:
        raise ValueError("strips need a seed row and at least one time step")
    _check_bits(b_v)
    if on_cpu(strips, "ws_task_toggles"):
        return ws_task_toggles_plain(strips, w_tiles, strip_ids, w_ids, valid_r, b_v)
    num_tasks = strip_ids.shape[0]
    out = torch.empty(num_tasks, dtype=torch.int64, device=device)  # the C entry zeroes it
    if num_tasks == 0:
        return out
    num_strips, t1, rows = strips.shape
    num_tiles, _, cols = w_tiles.shape
    launch(
        "activity_batch", "ws_task_toggles", device,
        strips.data_ptr(), w_tiles.data_ptr(), strip_ids.data_ptr(), w_ids.data_ptr(),
        valid_r.data_ptr(), out.data_ptr(), num_tasks, num_strips, num_tiles, t1, rows, cols,
        b_v,
    )
    ws_task_toggles.launches += 1
    return out


ws_task_toggles.launches = 0


def strip_toggles_plain(strips: torch.Tensor, bits: int) -> torch.Tensor:
    """Plain PyTorch version of K3: (S,) int64 toggles per window, counting
    ``PLAIN_BLOCK_ELEMENTS`` elements at a time."""
    num_strips, t1, lanes = strips.shape
    out = torch.zeros(num_strips, dtype=torch.int64, device=strips.device)
    if num_strips == 0 or t1 < 2 or lanes == 0:
        return out
    mask = bus_mask(bits)
    step = max(1, PLAIN_BLOCK_ELEMENTS // (t1 * lanes))
    for s0 in range(0, num_strips, step):
        x = strips[s0 : s0 + step].to(torch.int64)
        out[s0 : s0 + step] = popcount64((x[:, 1:] ^ x[:, :-1]) & mask).sum(dim=(1, 2))
    return out


def strip_toggles(strips: torch.Tensor, bits: int) -> torch.Tensor:
    """K3: exact toggle total of each stacked stream window, as a (S,) int64
    tensor on ``strips``' device.

    ``strips`` is (S, T1, L) int32 with int16-range values: window s carries
    L independent lanes over T1 rows, row 0 its seed, and counts every
    lane's transitions between consecutive rows on a ``bits``-wide
    two's-complement bus.
    """
    _check_operand(strips, "strips", strips.device, ndim=3)
    _check_bits(bits)
    if on_cpu(strips, "strip_toggles"):
        return strip_toggles_plain(strips, bits)
    num_strips, t1, lanes = strips.shape
    if num_strips == 0 or t1 < 2 or lanes == 0:
        return torch.zeros(num_strips, dtype=torch.int64, device=strips.device)
    out = torch.empty(num_strips, dtype=torch.int64, device=strips.device)  # the kernel writes all
    launch(
        "toggle_count", "strip_toggles", strips.device,
        strips.data_ptr(), out.data_ptr(), num_strips, t1, lanes, bits,
    )
    strip_toggles.launches += 1
    return out


strip_toggles.launches = 0


# int64 elements of one block of a lane pass's plain version (32 MiB): a
# block of the WS partial-sum pass holds (block_t + 1, rows, N) partial
# sums, and each of the few temporaries of its lane counts is the same size.
LANE_BLOCK_ELEMENTS = 1 << 22


def compact_lanes(bits: int) -> int:
    """Lanes L2 counts on a ``bits``-wide bus: the min(bits, 32) value lanes
    and, past 32 bits, one sign lane (the bits above 31 of a sign-extended
    int32 all copy bit 31)."""
    return min(bits, 32) + (1 if bits > 32 else 0)


def _lane_counts(x: torch.Tensor, shifts) -> torch.Tensor:
    """(len(shifts),) int64: the set bits of ``x`` at each shift, summed."""
    return torch.stack([((x >> b) & 1).sum() for b in shifts])


def stream_lane_toggles_plain(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Plain PyTorch version of L2: (``compact_lanes(bits)``,) int64.

    Time blocks of at most ``LANE_BLOCK_ELEMENTS`` values, each seeded with
    the last row of the block before it; one shift, mask and sum a lane and
    a block."""
    t, lanes = x.shape
    shifts = list(range(min(bits, 32))) + ([31] if bits > 32 else [])
    out = torch.zeros(len(shifts), dtype=torch.int64, device=x.device)
    block_t = max(1, LANE_BLOCK_ELEMENTS // max(lanes, 1))
    for t0 in range(1, t, block_t):
        seg = x[t0 - 1 : min(t0 + block_t, t)]
        out += _lane_counts(seg[1:] ^ seg[:-1], shifts)
    return out


def stream_lane_toggles(x: torch.Tensor, bits: int) -> torch.Tensor:
    """L2: the toggles of each bit lane of the (T, L) int32 lane streams
    ``x`` on a ``bits``-wide two's-complement bus, summed over the L lanes
    and T - 1 transitions, as a (``compact_lanes(bits)``,) int64 tensor on
    ``x``'s device: lanes 0 to min(bits, 32) - 1, then, past 32 bits, the
    sign lane that every lane from 32 up repeats."""
    _check_operand(x, "x", x.device)
    _check_bits(bits)
    if on_cpu(x, "stream_lane_toggles"):
        return stream_lane_toggles_plain(x, bits)
    t, lanes = x.shape
    if t < 2 or lanes == 0:
        return torch.zeros(compact_lanes(bits), dtype=torch.int64, device=x.device)
    out = torch.empty(compact_lanes(bits), dtype=torch.int64, device=x.device)  # the C entry zeroes it
    launch("lane_toggles", "stream_lane_toggles", x.device, x.data_ptr(), out.data_ptr(), t, lanes,
           bits)
    stream_lane_toggles.launches += 1
    return out


stream_lane_toggles.launches = 0


def ws_lane_toggles_plain(a: torch.Tensor, w: torch.Tensor, rows: int, b_v: int) -> torch.Tensor:
    """Plain PyTorch version of L1: (b_v,) int64 on the operands' device.

    Column tiling regroups the partial-sum streams without changing them, so
    each k strip's (T, rows, N) sums are counted whole, ``block_t`` time
    steps at a time (``block_t * rows * N <= LANE_BLOCK_ELEMENTS``, or one
    step where a row alone is larger); the strip's last int64 partial-sum
    row carries from one block to the next.
    """
    m, k = a.shape
    n = w.shape[1]
    out = torch.zeros(b_v, dtype=torch.int64, device=a.device)
    a64 = a.to(torch.int64)
    w64 = w.to(torch.int64)
    for k0 in range(0, k, rows):
        a_strip = a64[:, k0 : k0 + rows]
        w_strip = w64[k0 : k0 + rows]
        block_t = max(1, LANE_BLOCK_ELEMENTS // (a_strip.shape[1] * n))
        prev = torch.cumsum(a_strip[0, :, None] * w_strip, dim=0)
        for t0 in range(1, m, block_t):
            s = torch.cumsum(a_strip[t0 : t0 + block_t, :, None] * w_strip[None], dim=1)
            lag = torch.cat([prev[None], s[:-1]])
            out += _lane_counts(s ^ lag, range(b_v))
            prev = s[-1]
    return out


def ws_lane_toggles(a: torch.Tensor, w: torch.Tensor, rows: int, b_v: int) -> torch.Tensor:
    """L1: the toggles of each bit lane b < ``b_v`` of every
    weight-stationary partial-sum bus of ``a @ w`` on a ``rows``-deep
    array, as a (b_v,) int64 tensor on ``a``'s device.

    ``a`` is (M, K) and ``w`` (K, N), int32 with int16-range values.  The
    partial sums are int64; every (t, r, c) transition of each k strip of
    ``rows`` reduction rows counts, the strip's first seeded at t = 0.
    Column tiling does not change them, so no ``cols`` is taken.
    """
    _check_operand(a, "a", a.device)
    _check_operand(w, "w", a.device)
    if a.shape[1] != w.shape[0]:
        raise ValueError(f"bad GEMM shapes {tuple(a.shape)} x {tuple(w.shape)}")
    if rows < 1:
        raise ValueError("rows must be positive")
    _check_bits(b_v)
    if on_cpu(a, "ws_lane_toggles"):
        return ws_lane_toggles_plain(a, w, rows, b_v)
    m, k = a.shape
    n = w.shape[1]
    if m < 2 or k == 0 or n == 0:
        return torch.zeros(b_v, dtype=torch.int64, device=a.device)
    out = torch.empty(b_v, dtype=torch.int64, device=a.device)  # the C entry zeroes it
    launch("lane_toggles", "ws_lane_toggles", a.device,
           a.data_ptr(), w.data_ptr(), out.data_ptr(), m, k, n, rows, b_v)
    ws_lane_toggles.launches += 1
    return out


ws_lane_toggles.launches = 0
