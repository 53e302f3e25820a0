"""Stacked segment-window batched engine: one device pass per shape class.

The per-GEMM engine (``ops.profile_gemm_toggles``) copies, launches and
reads back once per GEMM.  This module profiles MANY GEMMs with two kernel
launches per shape class by flattening every job into fixed-shape *segment
tasks*:

  * Each job's activation stream is chopped into windows of ``t_seg`` steps
    **plus one seed row**: the stream value right before the window (the
    window's own first row for the first segment, so the nonexistent first
    transition counts zero).  Toggle counts only ever compare consecutive
    stream values, so with the seed row included every window's count is
    independent: no carry between segments, and a job of ANY stream length
    becomes an integer number of identical (t_seg + 1, rows) strips.  Tail
    padding replicates the last row (repeated values toggle zero bits:
    count-neutral).
  * ``strips``  (S, t_seg + 1, rows) int32: every (job, k-strip, segment)
    window, K zero-padded.
  * ``w_tiles`` (W, rows, cols) int32: every job's distinct weight tiles
    (segments of one tile share a single copy).
  * per-task metadata (P,) int32: ``strip_ids``/``w_ids`` route each task
    to its operands; ``valid_r`` is the true K extent of each task's tile
    (K-padding rows would duplicate the previous row's count, so they are
    left out; zero-padded w COLUMNS hold their partial sums at zero and
    toggle nothing, needing no mask; ``valid_r == 0`` turns a task off).
    Totals stay bit-exact vs the unpadded numpy oracle.

Tasks, not jobs, are the batch axis, so jobs of different M/K/N never pad
each other beyond the <= 2x segment rounding (see ``repro_torch.core.pipeline``
for the bucketing).

Two engines, same counts (verified bit-exact in tests):

  * ``engine="cuda"`` (``"auto"`` means this one, and raises with no CUDA
    device): kernel K3 ``strip_toggles`` for the horizontal pass over the
    strips at ``b_h``, kernel K2 ``ws_task_toggles`` for the vertical pass
    over the tasks.  Both launch on the device's current stream.
  * ``engine="torch"``: their plain PyTorch versions, on the CPU.

Both return the per-strip / per-task counts as tensors without waiting for
the device, so callers can overlap the next bucket's host-side operand
synthesis; ``reduce_bucket_parts`` waits and converts.

Output-stationary jobs need none of the partial-sum machinery: both OS
buses carry raw operand streams over the K axis, so an OS job contributes
two strips-only passes (the A rows as (K, M) lane streams, the W columns as
(K, N)) to *stream buckets* dispatched by ``stream_bucket_parts``: the same
``segment_strips`` windows counted by K3 at the bus width, geometry-free
(the pipeline scales totals by the output-tile counts at collection).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from repro_torch.kernels.activity_profile import ops
from repro_torch.kernels.activity_profile.kernel import (
    TASK_CHUNK_BUDGET,
    choose_task_chunk,
    strip_toggles,
    ws_task_toggles,
)
from repro_torch.runtime.resilience import ContractViolationError

__all__ = [
    "ENGINES",
    "TASK_CHUNK_BUDGET",
    "choose_task_chunk",
    "segment_strips",
    "bucket_toggle_parts",
    "stream_bucket_parts",
    "reduce_bucket_parts",
    "reduce_stream_parts",
]

ENGINES = ("auto", "cuda", "torch")


def segment_strips(a: np.ndarray, rows: int, t_seg: int) -> list[np.ndarray]:
    """Chop one job's (M, K) stream into seeded (t_seg + 1, rows) windows.

    Returns k-strip-major windows: ``[strip0_seg0, strip0_seg1, ...,
    strip1_seg0, ...]``, ceil(K/rows) * ceil(M/t_seg) arrays.  K zero-pads
    to a strip multiple; M tail-pads by edge replication; each window's row
    0 is the stream value preceding the window (its own first row for
    segment 0).  All padding is count-neutral by construction.
    """
    m, k = a.shape
    if m < 1:
        raise ValueError("need at least one stream step")
    n_seg = max(1, -(-m // t_seg))
    pk = (-k) % rows
    a_pad = np.pad(a.astype(np.int32), ((0, n_seg * t_seg - m), (0, pk)), mode="edge")
    if pk:
        a_pad[:, k:] = 0
    out = []
    for kt in range(a_pad.shape[1] // rows):
        strip = a_pad[:, kt * rows : (kt + 1) * rows]
        for s in range(n_seg):
            t0 = s * t_seg
            seed = strip[t0 - 1 if s else t0]
            out.append(np.concatenate([seed[None], strip[t0 : t0 + t_seg]], axis=0))
    return out


def _engine_device(engine: str, device: torch.device | None) -> torch.device:
    """The device an engine runs on (``device``, else the engine's default);
    raises for an engine the host cannot run or a device that is not the
    engine's."""
    if engine == "auto":
        engine = "cuda"
    if device is None:
        return ops.engine_device(engine)
    want = {"cuda": "cuda", "torch": "cpu"}.get(engine)
    if want is None:
        # typed (still a ValueError subclass): an unknown engine is a caller
        # bug, not a retryable fault, so it raises in every on_error mode
        raise ContractViolationError(f"unknown engine {engine!r}; expected one of {ENGINES}")
    if device.type != want:
        raise ContractViolationError(f"engine={engine!r} runs on {want} tensors, not {device}")
    return device


def _on(device: torch.device):
    """Make ``device`` current for the launches inside (CUDA only)."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def _put(x: np.ndarray, device: torch.device) -> torch.Tensor:
    x = torch.from_numpy(np.ascontiguousarray(x, dtype=np.int32))
    return x.to(device)


def bucket_toggle_parts(
    strips: np.ndarray,
    w_tiles: np.ndarray,
    strip_ids: np.ndarray,
    w_ids: np.ndarray,
    valid_r: np.ndarray,
    *,
    rows: int,
    cols: int,
    b_h: int,
    b_v: int,
    engine: str = "auto",
    device: torch.device | None = None,
) -> tuple[torch.Tensor, torch.Tensor, int]:
    """Dispatch one WS bucket's two passes; do NOT wait for the device.

    Returns ``(h_parts, v_parts, num_tasks)``: per-strip and per-task int64
    counts on the engine's device, still computing on a CUDA device when
    this returns.  ``device`` places the bucket on one CUDA device (the
    pipeline spreads a bucket's task shards over the local devices); it
    defaults to the current one, and for ``engine="torch"`` is the CPU.
    """
    device = _engine_device(engine, device)
    num_tasks = int(strip_ids.shape[0])
    if strips.shape[2] != rows or w_tiles.shape[1:] != (rows, cols):
        raise ContractViolationError(
            f"bucket shapes {strips.shape} / {w_tiles.shape} are not a "
            f"{rows}x{cols} geometry"
        )
    ids = np.asarray(strip_ids, np.int64)
    wids = np.asarray(w_ids, np.int64)
    if num_tasks and (
        ids.min() < 0 or ids.max() >= strips.shape[0]
        or wids.min() < 0 or wids.max() >= w_tiles.shape[0]
    ):
        raise ContractViolationError("task ids out of range of the bucket's strips / tiles")
    with _on(device):
        args = [_put(x, device) for x in (strips, w_tiles, strip_ids, w_ids, valid_r)]
        h_parts = strip_toggles(args[0], b_h)
        v_parts = ws_task_toggles(*args, b_v)
    return h_parts, v_parts, num_tasks


def stream_bucket_parts(
    strips: np.ndarray,
    *,
    bits: int,
    engine: str = "auto",
    device: torch.device | None = None,
) -> torch.Tensor:
    """Dispatch one OPERAND-STREAM bucket's pass; do NOT wait.

    OS-dataflow jobs flatten each operand's per-lane streams into the same
    seeded (t_seg + 1, lane_chunk) windows as WS horizontal streams
    (``segment_strips`` on the time-major stream matrix); there is no
    partial-sum arithmetic at all, so a bucket is ONE strips-only pass, K3:
    per-strip toggle totals at the bus width ``bits``, as an (S,) int64
    tensor on the engine's device.
    """
    device = _engine_device(engine, device)
    with _on(device):
        return strip_toggles(_put(strips, device), bits)


def reduce_bucket_parts(
    h_parts: torch.Tensor, v_parts: torch.Tensor, num_tasks: int
) -> tuple[np.ndarray, np.ndarray]:
    """Wait for a bucket's passes; int64 per-strip / per-task totals."""
    return h_parts.cpu().numpy(), v_parts.cpu().numpy()[:num_tasks]


def reduce_stream_parts(parts: torch.Tensor) -> np.ndarray:
    """Wait for a stream bucket's pass; int64 per-strip totals."""
    return parts.cpu().numpy()
