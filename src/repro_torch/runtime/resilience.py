"""Failure taxonomy + recovery primitives for the profiling/evaluation stack.

A failed kernel build, a CUDA fault, a lost device or a corrupted cache
entry would otherwise surface as a bare ``Exception`` somewhere inside
``run_profile_batch``, aborting (or worse, silently poisoning) a whole
workload.  This module gives every failure mode a TYPE, and gives the
pipeline the three recovery primitives it composes them with:

  * the **taxonomy** — ``ProfileError`` subclasses, one per failure class
    (backend-compile, device-dispatch, device-loss, timeout,
    contract-violation, cache-corruption) and the evaluation-layer classes
    (guard-violation, cross-engine-mismatch — see ``core.sweep``), plus
    ``classify_exception`` to
    lift foreign exceptions (kernel build failures, CUDA runtime errors,
    ``TimeoutError``, bare ``ValueError``) into it;
  * the **retry policy** — exponential backoff with DETERMINISTIC jitter
    (seeded per (site, attempt): reproducible schedules, no thundering
    herd) via ``RetryPolicy`` / ``call_with_retry``;
  * the **degradation ladder** — ``degradation_ladder()`` enumerates the
    per-job backend rungs below a failed batched pass, on the same device
    (the per-GEMM CUDA kernels on the card; the plain PyTorch versions
    then the numpy oracle on the CPU);
    every rung computes identical integer toggle counts (regression-tested
    across the stack), so degrading is bit-exact, never approximate;
  * the **failure report** — ``FailureRecord``/``FailureReport``: a
    machine-readable account of what failed, why (typed), and what recovery
    action was taken, returned in ``BatchStats.failure_report`` instead of
    being lost in a log line.

Nothing here imports torch: the taxonomy must be importable on hosts where
the backend itself is what's broken.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import hashlib
import time
from typing import Callable

__all__ = [
    "ProfileError",
    "BackendCompileError",
    "DeviceDispatchError",
    "DeviceLossError",
    "ProfileTimeoutError",
    "ContractViolationError",
    "CacheCorruptionError",
    "EvaluationError",
    "GuardViolationError",
    "CrossEngineMismatchError",
    "ProfileDegradationWarning",
    "CacheThrashWarning",
    "classify_exception",
    "RetryPolicy",
    "call_with_retry",
    "LADDER_RUNGS",
    "degradation_ladder",
    "EVAL_LADDER_RUNGS",
    "evaluation_ladder",
    "FailureRecord",
    "FailureReport",
]


# --- taxonomy ---------------------------------------------------------------


class ProfileError(RuntimeError):
    """Base of the profiling failure taxonomy.

    ``kind`` is the stable machine-readable class name (what failure
    reports and tests key on); ``job`` names the profiling job (when known)
    and ``stage`` the pipeline stage that observed the failure.
    """

    kind = "profile-error"

    def __init__(self, message: str, *, job: str = "", stage: str = ""):
        super().__init__(message)
        self.job = job
        self.stage = stage

    def describe(self) -> str:
        where = f" [job={self.job}]" if self.job else ""
        return f"{self.kind}{where}: {self}"


class BackendCompileError(ProfileError):
    """The fused engine failed to build or load (``nvcc`` missing or
    failing, no kernel image for the card) — before any device work ran."""

    kind = "backend-compile"


class DeviceDispatchError(ProfileError):
    """Device execution failed after a successful compile (runtime fault,
    OOM, transfer error)."""

    kind = "device-dispatch"


class DeviceLossError(DeviceDispatchError):
    """A device disappeared mid-workload (preemption, fleet scale-in,
    hardware fault).  Recoverable by eviction + resubmission."""

    kind = "device-loss"


class ProfileTimeoutError(DeviceDispatchError):
    """A dispatched program exceeded its wall-clock budget (hang, runaway
    autotuner, dead interconnect).  Treated like device loss: evict, then
    resubmit the slice elsewhere."""

    kind = "timeout"


class ContractViolationError(ProfileError, ValueError):
    """The request itself is invalid (bad GEMM shapes, unknown engine or
    dataflow, operands beyond an engine contract).  NOT retryable — the
    same request fails on every rung, so the only actions are "raise" or
    "skip and report".  Subclasses ``ValueError`` so pre-taxonomy callers
    (and tests) catching ``ValueError`` keep working."""

    kind = "contract-violation"


class CacheCorruptionError(ProfileError):
    """A cache/store entry failed integrity verification (bit rot, torn
    write from a crashed process, tampering).  The store quarantines the
    entry and the pipeline recomputes — this error is raised only if a
    caller explicitly asks the store to be strict."""

    kind = "cache-corruption"


class EvaluationError(ProfileError):
    """Base of the EVALUATION-layer failure classes (design-space/layout
    sweep chunks), distinct from the profiling classes above: an evaluation
    failure concerns derived physics (powers, optima, savings), not toggle
    measurement.  ``job`` names the chunk, ``stage`` the rung/site."""

    kind = "evaluation-error"


class GuardViolationError(EvaluationError):
    """A chunk's outputs violated a physical-contract guard (non-finite
    value, non-positive power, coded activity above raw, saving above 1,
    argmin outside the aspect envelope...).  ``violations`` lists every
    failed guard.  Recoverable by re-evaluating the chunk down the
    engine -> numpy -> scalar ladder; raised only when the last rung still
    violates (a silently wrong cell must never reach the Pareto front)."""

    kind = "guard-violation"

    def __init__(
        self,
        message: str,
        *,
        violations: tuple[str, ...] | list[str] = (),
        job: str = "",
        stage: str = "",
    ):
        super().__init__(message, job=job, stage=stage)
        self.violations = tuple(violations)


class CrossEngineMismatchError(GuardViolationError):
    """A sampled cross-engine agreement check failed: the chunk's batched
    results diverged from an independent reference evaluation (scalar
    closed forms for the design engine, explicit segment enumeration for
    the layout engine) beyond the rung's tolerance."""

    kind = "cross-engine-mismatch"


class ProfileDegradationWarning(RuntimeWarning):
    """A profiling request silently degraded to a slower-but-exact backend
    (the old ad-hoc ``RuntimeWarning``s, now typed so callers can filter)."""


class CacheThrashWarning(RuntimeWarning):
    """A single batch stored more profiles than the in-memory cache can
    hold — later jobs evict entries earlier jobs of the SAME workload still
    need.  Raise ``REPRO_TORCH_PROFILE_CACHE_CAPACITY`` (or call
    ``set_profile_cache_capacity``) to fit the working set."""


# Messages of the port's own kernel build (``kernels/_build.py``) and of a
# card the kernels were not built for.  Checked before the CUDA runtime
# markers below: "no kernel image" arrives as a "CUDA error: ..." message.
_BUILD_MARKERS = (
    "kernel build failed",
    "nvcc not found",
    "no kernel image is available",
)

# A CUDA fault after a successful build.  Matched BEFORE the generic compile
# markers: every PyTorch CUDA error message ends with "Compile with
# `TORCH_USE_CUDA_DSA` to enable device-side assertions", which the "compil"
# marker would otherwise misread as a build failure.
_CUDA_RUNTIME_TYPES = ("OutOfMemoryError", "AcceleratorError")
_CUDA_RUNTIME_MARKERS = ("cuda error", "cuda out of memory")

_COMPILE_MARKERS = (
    "compil",  # "compilation", "compile failed"
    "lower",
    "unsupported",
    "ptxas",
)


def classify_exception(
    exc: BaseException, *, job: str = "", stage: str = ""
) -> ProfileError:
    """Lift an arbitrary exception into the taxonomy (idempotent).

    Already-typed errors pass through (annotating job/stage if unset).
    ``TimeoutError`` (incl. ``concurrent.futures.TimeoutError``) maps to
    ``ProfileTimeoutError``; ``ValueError``/``TypeError`` are contract
    violations; a failed kernel build or a card without a kernel image is
    a backend-compile error; CUDA runtime errors (``torch.OutOfMemoryError``,
    ``RuntimeError("CUDA error: ...")``) are device-dispatch errors; other
    messages split on compile-ish markers; the rest default to
    device-dispatch (the retryable class: misclassifying an
    exotic error as retryable costs a few retries, misclassifying it as
    fatal would abort a recoverable workload).
    """
    if isinstance(exc, ProfileError):
        exc.job = exc.job or job
        exc.stage = exc.stage or stage
        return exc
    msg = f"{type(exc).__name__}: {exc}"
    # concurrent.futures.TimeoutError is a distinct class before py3.11
    if isinstance(exc, (TimeoutError, concurrent.futures.TimeoutError)):
        return ProfileTimeoutError(msg, job=job, stage=stage)
    if isinstance(exc, (ValueError, TypeError, ZeroDivisionError)):
        return ContractViolationError(msg, job=job, stage=stage)
    if isinstance(exc, (ImportError, NotImplementedError)):
        return BackendCompileError(msg, job=job, stage=stage)
    low = msg.lower()
    if any(m in low for m in _BUILD_MARKERS):
        return BackendCompileError(msg, job=job, stage=stage)
    if {c.__name__ for c in type(exc).__mro__} & set(_CUDA_RUNTIME_TYPES) or any(
        m in low for m in _CUDA_RUNTIME_MARKERS
    ):
        return DeviceDispatchError(msg, job=job, stage=stage)
    if any(m in low for m in _COMPILE_MARKERS):
        return BackendCompileError(msg, job=job, stage=stage)
    return DeviceDispatchError(msg, job=job, stage=stage)


# --- retry policy -----------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff with deterministic, seeded jitter.

    ``delay(attempt, key)`` for attempt 0, 1, ... is
    ``min(max_delay_s, base_delay_s * multiplier**attempt)`` scaled by a
    jitter factor in ``[1, 1 + jitter]`` drawn from sha256(seed, key,
    attempt) — the schedule is a pure function of its inputs, so tests and
    chaos CI runs reproduce byte-identical behavior, while distinct jobs
    (distinct keys) still decorrelate.
    """

    max_attempts: int = 3
    base_delay_s: float = 0.05
    multiplier: float = 2.0
    jitter: float = 0.5
    max_delay_s: float = 2.0
    seed: int = 0

    def delay(self, attempt: int, key: str = "") -> float:
        raw = min(self.max_delay_s, self.base_delay_s * self.multiplier**attempt)
        h = hashlib.sha256(f"{self.seed}|{key}|{attempt}".encode()).digest()
        u = int.from_bytes(h[:8], "big") / float(1 << 64)
        return raw * (1.0 + self.jitter * u)


def call_with_retry(
    fn: Callable[[], object],
    *,
    policy: RetryPolicy,
    key: str = "",
    retry_on: tuple = (BackendCompileError, DeviceDispatchError),
    sleep: Callable[[float], None] = time.sleep,
) -> tuple[object, int, ProfileError | None]:
    """Run ``fn`` under ``policy``; returns ``(result, attempts, last_error)``.

    Exceptions are classified first; only taxonomy classes in ``retry_on``
    are retried (contract violations never are — the same request fails
    identically forever).  On success ``last_error`` is the error of the
    last FAILED attempt (None if the first attempt succeeded); on
    exhaustion the classified error is raised with ``attempts`` recorded on
    it as ``error.attempts``.
    """
    last: ProfileError | None = None
    for attempt in range(max(1, policy.max_attempts)):
        try:
            return fn(), attempt + 1, last
        except BaseException as exc:  # noqa: BLE001 - classified right below
            err = classify_exception(exc, stage="retry")
            last = err
            if not isinstance(err, retry_on) or attempt + 1 >= policy.max_attempts:
                err.attempts = attempt + 1
                raise err from exc
            sleep(policy.delay(attempt, key))
    raise AssertionError("unreachable")  # pragma: no cover


# --- degradation ladder -----------------------------------------------------

# Per-JOB backend rungs, most- to least-accelerated.  Every rung computes
# the same integer toggle counts (bit-exactness across backends is the
# stack's standing regression contract), so stepping down trades speed for
# nothing else.
LADDER_RUNGS: tuple[str, ...] = ("cuda", "torch", "numpy")


def degradation_ladder(engine: str = "auto") -> tuple[str, ...]:
    """The rung sequence for a job that requested device rendering ``engine``.

    Work never leaves the device it was asked to run on: ``"cuda"``/``"auto"``
    has the one rung ``"cuda"`` (the job recomputed alone through the
    per-GEMM kernels on the card, retried there); a job that still fails is
    raised or skipped, never moved to the CPU.  ``engine="torch"`` (the
    plain versions, on the CPU) ends at the numpy oracle, which has no
    device, no compiler, and no contract narrower than "ints fit in 64
    bits".
    """
    if engine == "torch":
        return ("torch", "numpy")
    if engine in ("auto", "cuda"):
        return ("cuda",)
    raise ContractViolationError(f"unknown engine {engine!r}; know {LADDER_RUNGS[:2]}")


# Per-CHUNK evaluation rungs of the design-space/layout sweep runner
# (``core.sweep``), most- to least-accelerated.  The first rung is the
# evaluator's engine: "cuda" (the float64 program on the card) or "torch"
# (the same program on the CPU); "numpy" is the identical code in float64
# numpy (the reference's eager rung), "scalar" a per-point numpy evaluation
# (the oracle rung: no batching, no fusion, nothing shared across points
# that could smear one bad cell into its neighbors).  Every rung computes
# float64, but the rungs are NOT bit-identical (torch's and numpy's
# elementwise functions differ in the last bits) — they agree to the
# engines' cross-checked tolerances, and a chunk recomputed on a lower rung
# is recorded in the sweep report.
EVAL_LADDER_RUNGS: tuple[str, ...] = ("cuda", "torch", "numpy", "scalar")


def evaluation_ladder(start: str = "cuda") -> tuple[str, ...]:
    """The rung sequence for a sweep chunk starting at ``start``.

    A device engine (``"cuda"`` or ``"torch"``) steps down to ``"numpy"``
    and then ``"scalar"``; ``start="numpy"`` begins below both.  The scalar
    rung is always last — it exercises none of the machinery (batching,
    devices, broadcasting) that the guards exist to distrust, so it is the
    rung of last resort."""
    if start not in EVAL_LADDER_RUNGS:
        raise ContractViolationError(
            f"unknown evaluation rung {start!r}; know {EVAL_LADDER_RUNGS}"
        )
    if start in ("cuda", "torch"):
        return (start, "numpy", "scalar")
    return EVAL_LADDER_RUNGS[EVAL_LADDER_RUNGS.index(start):]


# --- failure report ---------------------------------------------------------


@dataclasses.dataclass
class FailureRecord:
    """One observed failure and what was done about it.

    ``error`` is the taxonomy kind; ``action`` the recovery outcome, drawn
    from a small stable vocabulary: ``"retried"``, ``"degraded:<rung>"``,
    ``"device-evicted:resubmitted"``, ``"quarantined:recomputed"``,
    ``"skipped"``, ``"raised"``.
    """

    job: str
    stage: str
    error: str
    message: str
    action: str
    attempts: int = 1

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class FailureReport:
    """Machine-readable account of every failure a batch observed."""

    records: list[FailureRecord] = dataclasses.field(default_factory=list)

    def add(
        self,
        error: ProfileError,
        *,
        action: str,
        job: str = "",
        stage: str = "",
        attempts: int = 1,
    ) -> FailureRecord:
        rec = FailureRecord(
            job=job or error.job,
            stage=stage or error.stage,
            error=error.kind,
            message=str(error),
            action=action,
            attempts=attempts,
        )
        self.records.append(rec)
        return rec

    def __bool__(self) -> bool:
        return bool(self.records)

    def __len__(self) -> int:
        return len(self.records)

    def counts(self) -> dict[str, int]:
        """Record count per taxonomy kind."""
        out: dict[str, int] = {}
        for r in self.records:
            out[r.error] = out.get(r.error, 0) + 1
        return out

    def actions(self) -> dict[str, int]:
        """Record count per recovery action."""
        out: dict[str, int] = {}
        for r in self.records:
            out[r.action] = out.get(r.action, 0) + 1
        return out

    def for_job(self, job: str) -> list[FailureRecord]:
        return [r for r in self.records if r.job == job]

    def summary(self) -> str:
        if not self.records:
            return "no failures"
        kinds = ", ".join(f"{k}x{n}" for k, n in sorted(self.counts().items()))
        acts = ", ".join(f"{a}x{n}" for a, n in sorted(self.actions().items()))
        return f"{len(self.records)} failures ({kinds}) -> ({acts})"

    def as_dict(self) -> dict:
        return {
            "records": [r.as_dict() for r in self.records],
            "counts": self.counts(),
            "actions": self.actions(),
        }
