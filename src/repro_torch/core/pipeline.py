"""Batched network-level profiling pipeline: jobs in, a few device passes out.

The per-GEMM entry point (``profile_gemm``) pays, per GEMM, a host-side
operand synthesis, a host-to-device copy, kernel launches and a blocking
device round-trip.  This module turns a LIST of profiling jobs into a
handful of batched device passes:

  1. **Dedup** — each job is checked against the content-keyed profile cache
     first; identical (operands, geometry) pairs inside one batch, and the
     same operands profiled across several (rows, cols) geometries, share a
     single device pass (``a``'s horizontal toggles are geometry-independent
     up to ceil(N/cols) scaling, and the vertical totals depend on ``rows``
     but not ``cols`` — tiling the columns differently regroups, never
     changes, the per-column partial-sum streams).
  2. **Bucketing** — schedulable jobs are grouped into a small set of padded
     shape classes: same (rows, cols, b_h, b_v) and time extents rounded up
     to a shared power-of-two block count (≤2x T padding, count-neutral).
     Each bucket is ONE stacked-tile device pass (kernels K3 then K2)
     regardless of how many GEMMs or how ragged their K/N are (tiles, not
     jobs, are the batch axis — see
     ``repro_torch.kernels.activity_profile.batch``).
  3. **Async dispatch** — bucket i's passes run on a worker thread, so the
     device crunches while the host synthesizes and quantizes bucket i+1's
     operands on a prefetch thread; results are pulled only in the final
     collection phase.

Dataflow is a first-class job axis: ``ProfileJob.dataflow`` selects the
stream model.  WS jobs run the partial-sum task machinery above; OS jobs
need none of it — both OS buses carry raw operand streams over the K axis,
so each OS job schedules two GEOMETRY-FREE operand-stream passes (the A
rows as (K, M) lane streams at width b_h, the W columns as (K, N) at b_v)
into strips-only *stream buckets*, and the totals are scaled by the
output-tile counts at collection (h by ceil(N/cols), v by ceil(M/rows) —
matching their transition denominators, so OS activities are geometry-
invariant and a layer profiled at ANY (rows, cols) shares the same passes).

Counts are bit-exact vs per-job ``profile_gemm`` (and the numpy oracle);
jobs the fused engine cannot take (operands beyond int16 range, degenerate
shapes, K/rows beyond the engine bounds, or an explicit numpy backend) fall
back to the serial path per job and are reported in ``BatchStats``.

Resilience
----------
Partial failure is a first-class outcome, not an abort.  Every failure is
classified into the typed taxonomy of ``repro_torch.runtime.resilience``
and the ``on_error`` knob picks the policy:

  * ``"raise"``   (default) — fail fast with a TYPED error;
  * ``"degrade"`` — recover each affected job individually down the backend
    ladder, with per-rung retry + deterministic-jitter backoff for transient
    dispatch-class faults.  The ladder never leaves the device the batch
    ran on: a CUDA job is recomputed alone on the card (the per-GEMM
    kernels), a job on the plain versions falls back to the numpy oracle.
    Every rung computes identical integer counts, so degradation is
    bit-exact, and every degraded job is recorded in ``BatchStats``;
  * ``"skip"``    — failed jobs yield ``None`` in the profile list; every
    successful job's profile is still returned.

Contract violations (malformed jobs, out-of-contract explicit requests)
raise in EVERY mode — they are programming errors that recur identically on
each rung, and silently skipping them would hide bugs.

Dispatch is bounded by ``timeout_s``: a device shard that hangs past it is
treated as lost — the device is evicted through a ``HealthMonitor`` and the
shard's task slice is resubmitted ONCE to a surviving device before the
per-job ladder takes over.  Whatever happened, ``BatchStats.failure_report``
enumerates each failure with its typed cause and the recovery action taken,
and layered cache lookups (memory → on-disk store → compute) record
quarantined-and-recomputed corrupt store entries there too.
"""

from __future__ import annotations

import dataclasses
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.core.switching import (
    ActivityProfile,
    _cache_get,
    _cache_key,
    _cache_put,
    _note_batch_stores,
    _operand_digest,
    _resolve_backend,
    BACKENDS,
    DEFAULT_BACKEND,
    os_stream_counts,
    profile_gemm,
    profile_store,
)
from repro_torch.runtime import faults
from repro_torch.runtime.health import HealthMonitor
from repro_torch.runtime.resilience import (
    CacheCorruptionError,
    ContractViolationError,
    DeviceDispatchError,
    FailureReport,
    ProfileError,
    RetryPolicy,
    call_with_retry,
    classify_exception,
    degradation_ladder,
)

__all__ = [
    "ProfileJob",
    "BatchStats",
    "run_profile_batch",
    "ON_ERROR_MODES",
]

ON_ERROR_MODES = ("raise", "degrade", "skip")

# A serving deployment pins a dispatch budget without touching call sites.
# The failure policy has no environment default: each caller picks it.
_env_timeout = os.environ.get("REPRO_TORCH_PROFILE_TIMEOUT_S", "").strip()
DEFAULT_TIMEOUT_S: float | None = float(_env_timeout) if _env_timeout else None


@dataclasses.dataclass
class ProfileJob:
    """One GEMM-on-array profiling request.

    Operands come either eagerly (``a``/``w``) or lazily (``make`` returning
    ``(a, w)`` plus the declared ``shape=(m, k, n)``) — lazy jobs let the
    pipeline overlap operand synthesis with device work, and let bucket
    planning see shapes without materializing anything.  ``dataflow``
    selects the stream model ("WS" partial sums / "OS" operand streams).
    """

    rows: int
    cols: int
    b_h: int
    b_v: int
    a: np.ndarray | None = None
    w: np.ndarray | None = None
    make: Callable[[], tuple[np.ndarray, np.ndarray]] | None = None
    shape: tuple[int, int, int] | None = None
    name: str = ""
    dataflow: str = "WS"

    def label(self, index: int) -> str:
        return self.name or f"job{index}"

    def gemm_shape(self) -> tuple[int, int, int]:
        """(M, K, N) without materializing lazy operands."""
        if self.a is not None and self.w is not None:
            return (self.a.shape[0], self.a.shape[1], self.w.shape[1])
        if self.shape is None:
            raise ContractViolationError(
                f"lazy job {self.name!r} needs shape=(m, k, n)", job=self.name
            )
        return tuple(self.shape)

    def operands(self) -> tuple[np.ndarray, np.ndarray]:
        """Materialize (and keep) int64 operands, validated against shape."""
        if self.a is None or self.w is None:
            if self.make is None:
                raise ContractViolationError(
                    f"job {self.name!r} has neither operands nor make",
                    job=self.name,
                )
            a, w = self.make()
            self.a, self.w = np.asarray(a), np.asarray(w)
        a = np.asarray(self.a, dtype=np.int64)
        w = np.asarray(self.w, dtype=np.int64)
        if a.ndim != 2 or w.ndim != 2 or a.shape[1] != w.shape[0]:
            raise ContractViolationError(
                f"bad GEMM shapes {a.shape} x {w.shape}", job=self.name
            )
        declared = (a.shape[0], a.shape[1], w.shape[1])
        if self.shape is not None and tuple(self.shape) != declared:
            raise ContractViolationError(
                f"job {self.name!r}: declared shape {tuple(self.shape)} != "
                f"materialized {declared}",
                job=self.name,
            )
        self.a, self.w = a, w
        return a, w


@dataclasses.dataclass
class BatchStats:
    """What the scheduler actually did (regression-tested invariants)."""

    jobs: int = 0
    cache_hits: int = 0
    store_hits: int = 0  # cache_hits served by the on-disk store layer
    passes: int = 0  # device operand-passes scheduled (strips + tiles)
    pass_reuse: int = 0  # jobs served by an already-scheduled pass
    buckets: int = 0  # padded shape classes == batched passes dispatched
    serial_fallbacks: int = 0
    tasks: int = 0  # stacked (tile, segment) device tasks across all buckets
    strips: int = 0  # stacked seeded stream windows across all buckets
    retries: int = 0  # extra attempts spent inside recovery ladders
    degraded: int = 0  # jobs recovered per-job after a batched-path failure
    skipped: int = 0  # jobs returned as None under on_error="skip"
    resubmits: int = 0  # device shards resubmitted after eviction
    failure_report: FailureReport = dataclasses.field(default_factory=FailureReport)

    def as_dict(self) -> dict:
        out = dataclasses.asdict(self)
        out["failure_report"] = self.failure_report.as_dict()
        return out


@dataclasses.dataclass
class _Pass:
    """One scheduled (a, w, rows) device pass inside a bucket."""

    bucket: int
    strip_lo: int
    strip_hi: int
    tile_lo: int
    tile_hi: int
    h_total: int | None = None
    v_total: int | None = None


@dataclasses.dataclass
class _Shard:
    """One dispatched slice of a bucket's task axis (resubmittable)."""

    label: str
    args: tuple  # (strips, w_tiles, ids, wids, vr)
    kwargs: dict
    device_index: int
    future: object
    resubmits: int = 0


@dataclasses.dataclass
class _Bucket:
    rows: int
    cols: int
    b_h: int
    b_v: int
    t_seg: int
    strips: list = dataclasses.field(default_factory=list)
    w_tiles: list = dataclasses.field(default_factory=list)
    strip_ids: list = dataclasses.field(default_factory=list)
    w_ids: list = dataclasses.field(default_factory=list)
    valid_r: list = dataclasses.field(default_factory=list)
    shards: list = dataclasses.field(default_factory=list)  # [_Shard]
    error: ProfileError | None = None


@dataclasses.dataclass
class _StreamPass:
    """One scheduled geometry-free operand-stream pass (OS jobs)."""

    bucket: int
    strip_lo: int
    strip_hi: int
    total: int | None = None


@dataclasses.dataclass
class _StreamBucket:
    """Strips-only shape class for OS operand streams: (bits, t_seg)."""

    bits: int
    t_seg: int
    strips: list = dataclasses.field(default_factory=list)
    future: object | None = None  # -> per-strip int64 totals
    error: ProfileError | None = None


def _next_pow2(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


# Segment-length ceiling. 128 keeps a task's (t_seg + 1, cols) partial-sum
# state small AND collapses every stream longer than one segment into the
# same shape class — short and long layers of one geometry share one pass
# (tail rounding stays <= 2x and count-neutral).
MAX_SEG_T = 128


# Lane width of OS operand-stream strips.  Purely a batching shape — OS lane
# streams are independent, so the chop never has to match the array geometry
# (zero-padded lanes toggle nothing) and one constant collapses every OS job
# of a given (bits, t_seg) onto one pass shape.
OS_LANE_CHUNK = 64


def _os_t_seg(k: int) -> int:
    """Stream-bucket segment length for a K-step OS operand stream."""
    return min(MAX_SEG_T, _next_pow2(max(1, -(-k // 8))) * 8)


def _bucket_key(job: ProfileJob) -> tuple:
    """Padded shape class: geometry + bus widths + pow2 segment length.

    ``t_seg`` is the segment ceiling (bounded further by the reference
    engine's block budget for huge geometries, so the classes are the
    reference's) capped to the job's own stream length
    rounded up to a power of two — so short-stream jobs don't pad to the
    long-stream class and a whole workload collapses into a couple of
    shape classes.  OS jobs class by bus widths + their K-axis segment
    length only: their stream passes are geometry-free.
    """
    from repro_torch.kernels.activity_profile.kernel import choose_block_t

    m, k, _ = job.gemm_shape()
    if job.dataflow == "OS":
        return ("OS", job.b_h, job.b_v, _os_t_seg(k))
    t_seg = min(
        MAX_SEG_T,
        choose_block_t(job.rows, job.cols),
        _next_pow2(max(1, -(-m // 8))) * 8,
    )
    return (job.rows, job.cols, job.b_h, job.b_v, t_seg)


def _fused_eligible(job: ProfileJob, a: np.ndarray, w: np.ndarray) -> bool:
    """Mirror of profile_gemm_toggles' contract checks (raise-free)."""
    from repro_torch.kernels.activity_profile.ops import (
        MAX_FUSED_K,
        MAX_FUSED_LANES,
        MAX_FUSED_ROWS,
        operands_fit_fused,
    )

    m, k, n = job.gemm_shape()
    if job.dataflow == "OS":
        if k < 2 or m == 0 or n == 0:
            return False  # zero transitions: serial path returns zeros instantly
        if max(m, n) >= MAX_FUSED_LANES:
            return False
        return operands_fit_fused(a, w)
    if m < 2 or k == 0 or n == 0:
        return False  # zero transitions: serial path returns zeros instantly
    if k + job.rows >= MAX_FUSED_K or job.rows >= MAX_FUSED_ROWS:
        return False
    return operands_fit_fused(a, w)


def _schedule_job(job, a, w, t_trim, bucket_map, buckets, pass_map, stats):
    """Attach one job to a (possibly shared) device pass, creating buckets
    and stacking segment strips / weight tiles / tasks as needed. Returns
    the job's pass key. ``t_trim`` caps the bucket's segment length at the
    class's actual longest stream (8-aligned) so short-stream classes don't
    compute their pow2 rounding."""
    from repro_torch.kernels.activity_profile.batch import segment_strips

    m, k, n = job.gemm_shape()
    # Shapes are part of the key: digests hash raw bytes, and the same bytes
    # reshaped to a different (M, K)/(K, N) are a different stream.
    pass_key = (
        _operand_digest(a), _operand_digest(w), (m, k, n),
        job.rows, job.b_h, job.b_v,
    )
    if pass_key in pass_map:
        stats.pass_reuse += 1
        return pass_key

    bkey = _bucket_key(job)
    if bkey not in bucket_map:
        bucket_map[bkey] = len(buckets)
        buckets.append(
            _Bucket(job.rows, job.cols, job.b_h, job.b_v, min(bkey[-1], t_trim))
        )
    bidx = bucket_map[bkey]
    bucket = buckets[bidx]
    rows, cols = job.rows, job.cols

    strip_lo = len(bucket.strips)
    bucket.strips.extend(segment_strips(a, rows, bucket.t_seg))
    n_seg = (len(bucket.strips) - strip_lo) // (-(-k // rows))

    pk = (-k) % rows
    pn = (-n) % cols
    w_pad = np.pad(w.astype(np.int32), ((0, pk), (0, pn)))
    k_tiles = -(-k // rows)
    n_tiles = -(-n // cols)
    w_lo = len(bucket.w_tiles)
    for kt in range(k_tiles):
        for nt in range(n_tiles):
            bucket.w_tiles.append(
                np.ascontiguousarray(
                    w_pad[kt * rows : (kt + 1) * rows, nt * cols : (nt + 1) * cols]
                )
            )
    task_lo = len(bucket.strip_ids)
    for kt in range(k_tiles):
        vr = min(rows, k - kt * rows)
        for nt in range(n_tiles):
            for s in range(n_seg):
                bucket.strip_ids.append(strip_lo + kt * n_seg + s)
                bucket.w_ids.append(w_lo + kt * n_tiles + nt)
                bucket.valid_r.append(vr)
    pass_map[pass_key] = _Pass(
        bidx, strip_lo, len(bucket.strips), task_lo, len(bucket.strip_ids)
    )
    stats.passes += 1
    return pass_key


def _schedule_os_job(
    job, a, w, stream_bucket_map, stream_buckets, stream_pass_map, stats
):
    """Attach one OS job to its two operand-stream passes (A rows at b_h,
    W columns at b_v), creating stream buckets as needed.  Pass keys carry
    NO geometry — OS per-lane stream totals are (rows, cols)-free; the
    collection phase scales them by each job's own tile counts.  Returns
    the (A-pass key, W-pass key) pair."""
    from repro_torch.kernels.activity_profile.batch import segment_strips

    m, k, n = job.gemm_shape()
    keys = []
    for tag, arr, shape, bits in (
        ("A", a, (m, k), job.b_h),
        ("W", w, (k, n), job.b_v),
    ):
        key = ("os", tag, _operand_digest(arr), shape, bits)
        keys.append(key)
        if key in stream_pass_map:
            stats.pass_reuse += 1
            continue
        # Stream matrices are time(K)-major: A rows transpose, W is already.
        stream = np.ascontiguousarray(arr.T) if tag == "A" else arr
        t_seg = _os_t_seg(k)
        bkey = (bits, t_seg)
        if bkey not in stream_bucket_map:
            stream_bucket_map[bkey] = len(stream_buckets)
            stream_buckets.append(_StreamBucket(bits, t_seg))
        bidx = stream_bucket_map[bkey]
        bucket = stream_buckets[bidx]
        strip_lo = len(bucket.strips)
        bucket.strips.extend(segment_strips(stream, OS_LANE_CHUNK, bucket.t_seg))
        stream_pass_map[key] = _StreamPass(bidx, strip_lo, len(bucket.strips))
        stats.passes += 1
    return tuple(keys)


def _ladder_recover(
    job: ProfileJob,
    label: str,
    cause: ProfileError,
    *,
    engine: str,
    use_cache: bool,
    store_key: bytes | None,
    policy: RetryPolicy,
    stats: BatchStats,
    report: FailureReport,
):
    """Recover ONE job down the backend ladder after a batched-path failure.

    Walks ``degradation_ladder(engine)`` rung by rung.  Dispatch-class
    faults (device loss, timeouts, runtime errors) are retried within a
    rung under ``policy``'s backoff; compile-class and contract faults
    descend immediately — they recur deterministically.  Every rung
    computes identical integer toggle counts, so whichever rung lands
    first yields the bit-exact profile.  The ladder never leaves the
    engine's device (on the card: the per-GEMM kernels only).  Returns
    ``(profile, None)`` or ``(None, last_error)`` if every rung failed.
    """
    from repro_torch.kernels.activity_profile.ops import profile_gemm_toggles

    try:
        a, w = job.operands()
    except Exception as exc:  # malformed job: nothing to degrade to
        return None, classify_exception(exc, job=label, stage="recover")

    inj = faults.active()
    last = cause
    for rung in degradation_ladder(engine):

        def attempt(rung=rung):
            if inj is not None:
                inj.maybe_fail_backend(f"ladder:{rung}", label)
                inj.maybe_lose_device(f"ladder:{rung}", label)
            if rung == "numpy":
                return profile_gemm(
                    a, w, job.rows, job.cols, job.b_h, job.b_v,
                    dataflow=job.dataflow, backend="numpy", use_cache=False,
                )
            counts = profile_gemm_toggles(
                a, w, job.rows, job.cols, job.b_h, job.b_v,
                dataflow=job.dataflow, engine=rung,
            )
            a_h, a_v = counts.activities(job.b_h, job.b_v)
            return ActivityProfile(
                a_h=a_h,
                a_v=a_v,
                b_h=job.b_h,
                b_v=job.b_v,
                h_transitions=counts.h_transitions,
                v_transitions=counts.v_transitions,
                input_zero_fraction=float(np.mean(a == 0)),
                input_elements=int(a.size),
            )

        try:
            profile, attempts, _ = call_with_retry(
                attempt,
                policy=policy,
                key=f"{label}:{rung}",
                retry_on=(DeviceDispatchError,),
            )
        except ProfileError as err:
            stats.retries += getattr(err, "attempts", 1) - 1
            last = err
            continue
        stats.retries += attempts - 1
        stats.degraded += 1
        # Record the ORIGINAL cause, not the last rung's failure: the report
        # answers "what fault made this job degrade", and intermediate rung
        # descents are bookkept in stats.retries.
        report.add(
            cause,
            action=f"degraded:{rung}",
            job=label,
            stage="recover",
            attempts=attempts,
        )
        if use_cache and store_key is not None:
            # Counts are rung-invariant, so the recovered profile is stored
            # under the job's ORIGINAL batched-path key: the next run hits
            # the cache instead of re-dispatching the batched passes.
            _cache_put(store_key, profile)
        return profile, None
    return None, last


def _devices(engine: str) -> list[torch.device]:
    """The devices a bucket's task shards spread over: every CUDA device for
    ``engine="cuda"``, the CPU for ``"torch"``."""
    if engine == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def run_profile_batch(
    jobs: Sequence[ProfileJob],
    *,
    backend: str | None = None,
    use_cache: bool = True,
    on_error: str = "raise",
    timeout_s: float | None = None,
    retry: RetryPolicy | None = None,
    health: HealthMonitor | None = None,
) -> tuple[list[ActivityProfile | None], BatchStats]:
    """Profile every job; returns (profiles in input order, scheduler stats).

    ``backend`` follows ``profile_gemm``: ``"numpy"`` runs the serial
    oracle per job (no device work at all); ``"auto"``/``"cuda"`` run the
    batched pipeline on the CUDA kernels (``"auto"`` raises with no CUDA
    device) and ``"torch"`` on their plain versions on the CPU, with per-job
    fallback to serial for operands the engine cannot take.  Profiles of
    batched jobs are cached under the engine that computed them (``"cuda"``
    or ``"torch"``).

    ``on_error`` selects the failure policy: ``"raise"`` (default) fails
    fast with a typed ``repro_torch.runtime.resilience.ProfileError``;
    ``"degrade"`` recovers each affected job individually down the backend
    ladder, which stays on the device the batch ran on (bit-exact — every
    rung computes the same integer counts); ``"skip"`` returns ``None`` for
    failed jobs and every successful profile.  Contract violations
    (malformed jobs) raise in all modes.  ``timeout_s`` (default
    ``$REPRO_TORCH_PROFILE_TIMEOUT_S`` or unbounded) bounds each dispatched
    shard; a shard that exceeds it has its device evicted via ``health``
    (a ``HealthMonitor``, created internally when not passed) and its task
    slice resubmitted once to a surviving device.  ``retry`` is the
    ``RetryPolicy`` for transient faults inside recovery ladders.
    ``BatchStats.failure_report`` enumerates every failure with its typed
    cause and the recovery action taken.
    """
    from repro_torch.kernels.activity_profile.batch import (
        bucket_toggle_parts,
        reduce_bucket_parts,
        reduce_stream_parts,
        stream_bucket_parts,
    )
    from repro_torch.kernels.activity_profile.ops import ToggleCounts

    jobs = list(jobs)
    stats = BatchStats(jobs=len(jobs))
    report = stats.failure_report
    requested = backend if backend is not None else DEFAULT_BACKEND
    mode = on_error
    if mode not in ON_ERROR_MODES:
        raise ContractViolationError(
            f"unknown on_error mode {mode!r}; know {ON_ERROR_MODES}"
        )
    if requested not in BACKENDS:
        raise ContractViolationError(
            f"unknown backend {requested!r}; expected one of {BACKENDS}"
        )
    engine = "torch" if requested in ("torch", "numpy") else "cuda"
    if timeout_s is None:
        timeout_s = DEFAULT_TIMEOUT_S
    policy = retry if retry is not None else RetryPolicy()
    store = profile_store()
    store_hits0 = store.stats["hits"] if store is not None else 0

    def _finish(profiles):
        if store is not None:
            stats.store_hits = store.stats["hits"] - store_hits0
            for hexkey in store.drain_quarantine_events():
                report.add(
                    CacheCorruptionError(
                        f"store entry {hexkey[:16]}… failed integrity "
                        "verification",
                        stage="store",
                    ),
                    action="quarantined:recomputed",
                    job=hexkey[:16],
                )
        if use_cache:
            _note_batch_stores(stats.jobs - stats.cache_hits)
        return profiles, stats

    def _serial_job(job, i, resolved_backend):
        """One serial-path profile under the active failure policy."""
        label = job.label(i)
        try:
            a, w = job.operands()
            inj = faults.active()
            if inj is not None and resolved_backend != "numpy":
                inj.maybe_fail_backend("serial", label)
            return profile_gemm(
                a, w, job.rows, job.cols, job.b_h, job.b_v,
                dataflow=job.dataflow, backend=resolved_backend,
                use_cache=use_cache,
            )
        except Exception as exc:
            err = classify_exception(exc, job=label, stage="serial")
            if mode == "raise" or isinstance(err, ContractViolationError):
                raise err from exc
            if mode == "degrade" and resolved_backend != "numpy":
                profile, ladder_err = _ladder_recover(
                    job, label, err,
                    engine=engine, use_cache=use_cache,
                    store_key=None, policy=policy, stats=stats, report=report,
                )
                if profile is not None:
                    return profile
                err = ladder_err
            stats.skipped += 1
            report.add(err, action="skipped", job=label, stage="serial")
            return None

    if requested == "numpy":
        # Serial oracle per job: no device or thread work at all (the
        # docstring's contract for numpy-only callers).
        stats.serial_fallbacks = len(jobs)
        profiles = [_serial_job(job, i, "numpy") for i, job in enumerate(jobs)]
        return _finish(profiles)

    # resolution[i]: ("cache", profile) | ("pass", key) | ("os_pass", keys)
    #             | ("serial", backend) | ("failed", typed error)
    resolution: list[tuple] = [None] * len(jobs)
    bucket_map: dict[tuple, int] = {}
    buckets: list[_Bucket] = []
    pass_map: dict[tuple, _Pass] = {}
    stream_bucket_map: dict[tuple, int] = {}
    stream_buckets: list[_StreamBucket] = []
    stream_pass_map: dict[tuple, _StreamPass] = {}

    # Group by shape class first (shapes are declared, operands still lazy),
    # then materialize + dispatch bucket by bucket: while bucket i is
    # uploaded (worker thread) and computes on the device, the prefetch
    # thread synthesizes bucket i+1's operands.
    order: dict[tuple, list[int]] = {}
    for i, job in enumerate(jobs):
        order.setdefault(_bucket_key(job), []).append(i)

    # Device fan-out: each bucket's TASK axis is sharded across the local
    # devices (contiguous slices) and the shards execute in parallel, one
    # worker thread each.  The serial per-GEMM path cannot do this: it
    # blocks on every layer's result.  With no CUDA device the list holds
    # one empty slot, and a bucket sent there fails (and is degraded,
    # skipped or raised per ``on_error``) instead of leaving the card.
    devices = _devices(engine) or [None]

    if health is None:
        health = HealthMonitor(range(len(devices)))

    executor = ThreadPoolExecutor(max_workers=max(2, len(devices)))

    def _run_shard(args, kw, device_index, site):
        """Executor task for one shard: fault hooks, upload + launches,
        BLOCKING reduce — so ``future.result(timeout=...)`` bounds the whole
        device round-trip, not just the launches."""
        inj = faults.active()
        if inj is not None:
            inj.maybe_fail_backend("bucket-dispatch", site)
            inj.maybe_hang("bucket-exec", site)
            inj.maybe_lose_device("bucket-shard", site)
        parts = bucket_toggle_parts(*args, device=devices[device_index], **kw)
        return reduce_bucket_parts(*parts)

    def _submit_bucket(bidx: int, b: _Bucket) -> list[_Shard]:
        """One executor task per shard; the shards run concurrently."""
        strips = np.stack(b.strips)
        w_tiles = np.stack(b.w_tiles)
        ids = np.asarray(b.strip_ids, np.int32)
        wids = np.asarray(b.w_ids, np.int32)
        vr = np.asarray(b.valid_r, np.int32)
        n_shards = min(len(devices), max(1, len(ids) // 64))
        kw = dict(rows=b.rows, cols=b.cols, b_h=b.b_h, b_v=b.b_v, engine=engine)
        if n_shards == 1:
            args = (strips, w_tiles, ids, wids, vr)
            site = f"b{bidx}s0d0"
            return [
                _Shard(site, args, kw, 0,
                       executor.submit(_run_shard, args, kw, 0, site))
            ]
        # Equal-length slices (tail padded with valid_r=0 dummies that count
        # zero), as on the reference. Only shard 0's h_parts are used at
        # collection — h is per-strip and every shard sees the full strips
        # array.
        per = -(-len(ids) // n_shards)
        pad = n_shards * per - len(ids)
        if pad:
            zeros = np.zeros(pad, np.int32)
            ids = np.concatenate([ids, zeros])
            wids = np.concatenate([wids, zeros])
            vr = np.concatenate([vr, zeros])
        shards = []
        for s in range(n_shards):
            args = (
                strips, w_tiles,
                ids[s * per : (s + 1) * per],
                wids[s * per : (s + 1) * per],
                vr[s * per : (s + 1) * per],
            )
            didx = s % len(devices)
            site = f"b{bidx}s{s}d{didx}"
            shards.append(
                _Shard(site, args, kw, didx,
                       executor.submit(_run_shard, args, kw, didx, site))
            )
        return shards

    def _run_stream(strips, bits, site):
        inj = faults.active()
        if inj is not None:
            inj.maybe_fail_backend("stream-dispatch", site)
            inj.maybe_hang("stream-exec", site)
        parts = stream_bucket_parts(strips, bits=bits, engine=engine)
        return reduce_stream_parts(parts)

    def _await_shard(shard: _Shard):
        """Block on one shard (bounded by ``timeout_s``); returns
        ``(h, v, error)``.  A dispatch-class failure evicts the shard's
        device through the health monitor and resubmits the task slice
        EXACTLY ONCE to a surviving device before giving up on the shard."""
        while True:
            t0 = time.monotonic()
            try:
                h, v = shard.future.result(timeout=timeout_s)
                health.heartbeat(shard.device_index, time.monotonic())
                health.report_step_time(
                    shard.device_index, time.monotonic() - t0
                )
                return h, v, None
            except Exception as exc:
                err = classify_exception(exc, stage="dispatch", job=shard.label)
                if mode == "raise":
                    raise err from exc
                if (
                    shard.resubmits == 0
                    and isinstance(err, DeviceDispatchError)
                    and len(devices) > 1
                ):
                    health.evict(shard.device_index)
                    alive = health.alive_hosts()
                    if alive:
                        new_idx = alive[shard.resubmits % len(alive)]
                        report.add(
                            err,
                            action="device-evicted:resubmitted",
                            job=shard.label,
                            stage="dispatch",
                        )
                        shard.resubmits += 1
                        shard.device_index = new_idx
                        stats.resubmits += 1
                        shard.future = executor.submit(
                            _run_shard, shard.args, shard.kwargs, new_idx,
                            shard.label,
                        )
                        continue
                return None, None, err

    prefetch_pool = ThreadPoolExecutor(max_workers=1)
    try:
        # Materialize lazy operands a bounded window ahead on a side thread
        # (numpy synthesis releases the GIL), in the same order the group
        # loop consumes them — the window keeps host memory at a few jobs'
        # operands, not the whole workload's.
        consume_order = [i for members in order.values() for i in members]
        prefetched: dict[int, object] = {}
        window = 3

        def _advance_prefetch():
            while consume_order and len(prefetched) < window:
                nxt = consume_order.pop(0)
                prefetched[nxt] = prefetch_pool.submit(jobs[nxt].operands)

        _advance_prefetch()

        for bkey, members in order.items():
            t_trim = max(
                -(-jobs[i].gemm_shape()[0] // 8) * 8 for i in members
            )
            for i in members:
                job = jobs[i]
                try:
                    a, w = prefetched.pop(i).result()
                except Exception as exc:
                    # Malformed jobs are programming errors: typed, and
                    # raised in EVERY mode (skipping them would hide bugs).
                    raise classify_exception(
                        exc, job=job.label(i), stage="schedule"
                    ) from exc
                _advance_prefetch()
                resolved = _resolve_backend(backend, a, w, job.rows, job.dataflow)
                batched = resolved != "numpy" and _fused_eligible(job, a, w)
                if use_cache:
                    # A batched job's profile is keyed by the engine that
                    # computes it (see store_key below).
                    key = _cache_key(
                        a, w, job.rows, job.cols, job.b_h, job.b_v,
                        (engine if batched else resolved, job.dataflow, "exact"),
                    )
                    hit, _source = _cache_get(key)
                    if hit is not None:
                        resolution[i] = ("cache", hit)
                        stats.cache_hits += 1
                        continue
                if not batched:
                    if requested == "cuda" and resolved != "numpy":
                        # match profile_gemm(backend="cuda"): loud contract
                        # failure instead of a silent oracle detour
                        from repro_torch.kernels.activity_profile.ops import (
                            profile_gemm_toggles,
                        )

                        profile_gemm_toggles(
                            a, w, job.rows, job.cols, job.b_h, job.b_v,
                            dataflow=job.dataflow, engine=engine,
                        )
                    resolution[i] = ("serial", resolved)
                    stats.serial_fallbacks += 1
                    continue
                if job.dataflow == "OS":
                    keys = _schedule_os_job(
                        job, a, w, stream_bucket_map, stream_buckets,
                        stream_pass_map, stats,
                    )
                    kind = "os_pass"
                else:
                    keys = _schedule_job(
                        job, a, w, t_trim, bucket_map, buckets, pass_map, stats
                    )
                    kind = "pass"
                # Record the operand statistics (and the content-cache store
                # key) now and release lazy jobs' operands: the buckets hold
                # the (int32) strip copies, so keeping every job's int64
                # operands alive until collection would scale host memory
                # with the whole workload.  The profile is stored under the
                # engine that computes it, so a later profile_gemm with that
                # backend hits it.
                store_key = (
                    _cache_key(
                        a, w, job.rows, job.cols, job.b_h, job.b_v,
                        (engine, job.dataflow, "exact"),
                    )
                    if use_cache
                    else None
                )
                resolution[i] = (
                    kind,
                    (keys, float(np.mean(a == 0)), int(a.size), store_key),
                )
                if job.make is not None:
                    job.a = job.w = None
            # Hand every bucket this shape class produced to a worker:
            # stacking + upload + launches happen off-thread.
            for bidx in {pass_map[r[1][0]].bucket for j in members
                         if (r := resolution[j])[0] == "pass"}:
                b = buckets[bidx]
                if not b.shards and b.strip_ids:
                    b.shards = _submit_bucket(bidx, b)
        # Stream buckets are submitted only after ALL groups are scheduled:
        # unlike WS buckets (whose bucket key IS the group key), one
        # (bits, t_seg) stream bucket can collect strips from several
        # (b_h, b_v) job groups, so an early submit would freeze it before
        # later groups append.  They are strips-only passes — a trivial
        # fraction of the device work — so the lost overlap is small.
        for sidx, b in enumerate(stream_buckets):
            if b.future is None and b.strips:
                b.future = executor.submit(
                    _run_stream, np.stack(b.strips), b.bits, f"sb{sidx}"
                )

        stats.buckets = len(buckets) + len(stream_buckets)
        stats.tasks = sum(len(b.strip_ids) for b in buckets)
        stats.strips = sum(len(b.strips) for b in buckets) + sum(
            len(b.strips) for b in stream_buckets
        )

        # Collection: block on each bucket once (each shard bounded by
        # timeout_s), fold per-pass totals.  Sharded buckets: h comes from
        # shard 0 (identical in all shards), v concatenates the contiguous
        # task slices back together.  A bucket whose shards cannot be
        # recovered records its typed error; its jobs are degraded or
        # skipped per job below.
        reduced = []
        for b in buckets:
            if not b.shards:
                reduced.append(None)
                continue
            h_tot = None
            v_chunks = []
            for si, shard in enumerate(b.shards):
                h, v, err = _await_shard(shard)
                if err is not None:
                    b.error = err
                    break
                if si == 0:
                    h_tot = h
                v_chunks.append(v)
            if b.error is not None:
                reduced.append(None)
                continue
            reduced.append(
                (h_tot, np.concatenate(v_chunks)[: len(b.strip_ids)])
            )
        stream_reduced = []
        for b in stream_buckets:
            if b.future is None:
                stream_reduced.append(None)
                continue
            try:
                stream_reduced.append(b.future.result(timeout=timeout_s))
            except Exception as exc:
                err = classify_exception(exc, stage="dispatch")
                if mode == "raise":
                    raise err from exc
                b.error = err
                stream_reduced.append(None)
    finally:
        executor.shutdown(wait=True)
        prefetch_pool.shutdown(wait=True)
    for p in pass_map.values():
        if reduced[p.bucket] is None:
            continue  # failed bucket: totals stay None, jobs recover below
        h_tot, v_tot = reduced[p.bucket]
        p.h_total = int(h_tot[p.strip_lo : p.strip_hi].sum())
        p.v_total = int(v_tot[p.tile_lo : p.tile_hi].sum())
    for sp in stream_pass_map.values():
        if stream_reduced[sp.bucket] is None:
            continue
        sp.total = int(stream_reduced[sp.bucket][sp.strip_lo : sp.strip_hi].sum())

    def _recover_or_skip(i, job, cause, store_key):
        """Per-job policy application after a batched-path failure."""
        label = job.label(i)
        if mode == "degrade":
            profile, err = _ladder_recover(
                job, label, cause,
                engine=engine, use_cache=use_cache,
                store_key=store_key, policy=policy, stats=stats, report=report,
            )
            if profile is not None:
                return profile
            cause = err
        stats.skipped += 1
        report.add(cause, action="skipped", job=label, stage="collect")
        return None

    profiles: list[ActivityProfile | None] = []
    for i, job in enumerate(jobs):
        kind, payload = resolution[i]
        if kind == "cache":
            profiles.append(payload)
            continue
        if kind == "serial":
            profiles.append(_serial_job(job, i, payload))
            continue
        key, zero_fraction, elements, store_key = payload
        m, k, n = job.gemm_shape()
        n_tiles = -(-n // job.cols)
        if kind == "os_pass":
            key_a, key_w = key
            sps = (stream_pass_map[key_a], stream_pass_map[key_w])
            if any(sp.total is None for sp in sps):
                cause = next(
                    stream_buckets[sp.bucket].error
                    for sp in sps
                    if sp.total is None
                )
                profiles.append(_recover_or_skip(i, job, cause, store_key))
                continue
            # Geometry-free stream totals fold through the shared OS
            # accounting identity with each job's own output tiling.
            counts = ToggleCounts(
                *os_stream_counts(
                    sps[0].total, sps[1].total, m, k, n, job.rows, job.cols
                )
            )
            a_h, a_v = counts.activities(job.b_h, job.b_v)
            profiles.append(
                _store_profile(
                    job, counts, a_h, a_v, zero_fraction, elements, store_key
                )
            )
            continue
        p = pass_map[key]
        if p.h_total is None:
            profiles.append(
                _recover_or_skip(i, job, buckets[p.bucket].error, store_key)
            )
            continue
        counts = ToggleCounts(
            n_tiles * p.h_total,
            p.v_total,
            max(m - 1, 0) * k * n_tiles,
            max(m - 1, 0) * k * n,
        )
        a_h, a_v = counts.activities(job.b_h, job.b_v)
        profiles.append(
            _store_profile(job, counts, a_h, a_v, zero_fraction, elements, store_key)
        )
    return _finish(profiles)


def _store_profile(
    job: ProfileJob, counts, a_h, a_v, zero_fraction, elements, store_key
) -> ActivityProfile:
    """Build one job's profile from folded counts; memoize if keyed."""
    profile = ActivityProfile(
        a_h=a_h,
        a_v=a_v,
        b_h=job.b_h,
        b_v=job.b_v,
        h_transitions=counts.h_transitions,
        v_transitions=counts.v_transitions,
        input_zero_fraction=zero_fraction,
        input_elements=elements,
    )
    if store_key is not None:
        _cache_put(store_key, profile)
    return profile
