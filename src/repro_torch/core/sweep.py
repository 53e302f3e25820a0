"""Checkpointed, self-validating execution of design-space/layout sweeps.

The exploration engines (``core.design_space.evaluate_design_space``,
``layout.power.evaluate_layout_space``) evaluate their whole grid in one
program: fast, but a multi-hour sweep that dies at 80% restarts from zero,
and a silently wrong cell (a NaN, an engine/closed-form divergence)
corrupts the Pareto frontier with no error at all.  This module is the
resilience layer between those engines and their callers — both take a
``sweep=`` keyword that routes evaluation through here.

Chunking & resume
-----------------
The point axis P is split into deterministic fixed-shape chunks of
``SweepConfig.chunk_size`` (the last chunk clamp-pads by repeating the
final point, so every chunk has one shape).  Chunking along P is
mathematically safe: every engine reduction runs along the workload axis
W, never across points.  Each completed chunk is committed to a crash-safe
content-addressed ``core.store.ContentStore`` (atomic tmp+fsync+rename,
per-entry sha256, quarantine-on-corruption — the machinery the profile
store uses) under ``sha256(spec | chunk_index)``, where the spec digest
covers every input that determines the chunk's bytes (grid arrays,
activities, weights, config, gss iterations, chunk size, starting rung).
A killed sweep re-keyed over the same inputs serves completed chunks from
the store — the stored arrays round-trip as raw dtype+shape+base64 bytes,
so a resumed run reproduces the uninterrupted run BIT-identically (JSON
float text could not: it cannot even represent a NaN payload).  The store
has its own version (``SWEEP_STORE_VERSION``), so a store directory the
JAX package wrote never serves this one.

Validation & degradation
------------------------
Every chunk (freshly evaluated or resumed) passes a guard harness before
it is accepted:

  * physical contracts — all fields finite; powers positive where activity
    is; coded activity <= raw; savings <= 1; argmin aspects inside the
    envelope; infeasible layout cells priced ``inf`` and only those;
  * cross-engine agreement — the batched golden-section argmin against the
    closed-form Eq. 6 optimum (f64 power-shape comparison), and a seeded
    random sample of cells re-derived through the SCALAR oracles
    (``optimize.bus_invert_activity``, ``floorplan.bus_power``,
    ``layout.power.segment_bus_power``).

Every rung computes float64 (the card's too), so every rung and every
stored chunk is held to one tolerance row — the reference's strict row.

A violated chunk raises a typed ``GuardViolationError`` /
``CrossEngineMismatchError`` (``runtime.resilience`` taxonomy) and is
re-evaluated down the ladder (``resilience.evaluation_ladder``): the
evaluator's engine (``"cuda"`` on the card, ``"torch"`` on the CPU), then
the same math in float64 numpy (``"numpy"``), then per-point scalar
evaluation (``"scalar"``) with nothing batched that could smear one bad
cell into its neighbors.  Every event lands in the machine-readable
``SweepReport`` (chunk records + a ``resilience.FailureReport``): a
healthy run on the card reports every chunk on ``"cuda"``.

Fault tolerance
---------------
Fresh chunks of a device engine are sharded round-robin across its devices
(every visible CUDA device for ``"cuda"``, the CPU for ``"torch"``); each
worker thread makes its device current and synchronizes before it
returns, so ``timeout_s`` bounds the device round-trip.  A
dispatch-class failure (timeout, device loss) evicts the device through
``runtime.health.HealthMonitor`` and resubmits the chunk once to a
survivor — the same semantics the profiling pipeline uses.  Evaluator-site
fault hooks (``runtime.faults``: backend raise, hang, device loss, NaN/Inf
poison, chunk-store bitflip, commit-boundary abort) let chaos CI prove
every one of these paths actually runs.
"""

from __future__ import annotations

import base64
import dataclasses
import functools
import hashlib
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from repro_torch.core.store import ContentStore
from repro_torch.runtime import faults
from repro_torch.runtime.health import HealthMonitor
from repro_torch.runtime.resilience import (
    BackendCompileError,
    CacheCorruptionError,
    ContractViolationError,
    CrossEngineMismatchError,
    DeviceDispatchError,
    EvaluationError,
    FailureReport,
    GuardViolationError,
    ProfileError,
    RetryPolicy,
    call_with_retry,
    classify_exception,
    evaluation_ladder,
)

__all__ = [
    "SweepConfig",
    "ChunkRecord",
    "SweepReport",
    "SweepInterrupted",
    "SWEEP_STORE_VERSION",
    "run_design_sweep",
    "run_layout_sweep",
]

# Chunk-store key schema version: a bump orphans old chunks rather than
# mis-serving them (same rule the profile store follows).  The port's own
# name: the JAX package's chunks ("sweep-v3") live in another directory of
# the same store root and are never read here.
SWEEP_STORE_VERSION = "torch-sweep-v1"

# The exact output field sets of the two engines — chunk payloads carry all
# of them, and a stored chunk missing (or growing) a field fails decode.
_DESIGN_FIELDS = (
    "a_v_eff",
    "aspect_opt",
    "aspect_opt_gss",
    "bus_power_opt",
    "bus_power_sym",
    "aspect_robust",
    "max_regret",
    "bus_power_robust",
    "bus_power_square",
    "interconnect_saving",
    "total_saving",
    "area_um2",
    "bus_energy_per_mac_j",
    "neg_macs_per_cycle",
)
_LAYOUT_FIELDS = (
    "feasible",
    "aspect_lo",
    "aspect_hi",
    "aspect_opt",
    "bus_power_opt",
    "aspect_robust",
    "bus_power_robust",
    "overhead_w",
    "wirelength_um",
)
# Objective-mode layout sweeps (an ``ObjectiveSpec`` was priced) carry the
# fused J/op outputs on top of the wire-power schema.
_OBJECTIVE_FIELDS = _LAYOUT_FIELDS + (
    "utilization",
    "j_per_mac",
    "j_per_mac_robust",
)

# The rungs that run the evaluator's torch program on a device.
_DEVICE_RUNGS = ("cuda", "torch")

# Chunks are pure compute (no device queue contention like profiling), so
# the default retry budget is small and fast.
_DEFAULT_RETRY = RetryPolicy(max_attempts=2, base_delay_s=0.01, max_delay_s=0.1)

_ON_VIOLATION = ("degrade", "raise")

# The guards' tolerances (the reference's strict, float64 row): relative
# slack of the contract checks, of the aspect envelope, of the golden-section
# cross-check and of the design and layout scalar oracles.
_EPS = 1e-8
_EPS_ASPECT = 1e-9
_RTOL_GSS = 1e-6
_RTOL_ORACLE = 1e-6
_RTOL_SEGMENTS = 1e-5
_TINY = 1e-30


@dataclasses.dataclass(frozen=True)
class SweepConfig:
    """Knobs of the chunked sweep runner (``sweep=`` on the evaluators).

    ``store`` is a directory path or a ``ContentStore``; ``None`` runs
    chunked + validated but unpersisted.  ``max_chunks`` bounds how many
    PENDING chunks this call evaluates (the kill-and-resume test harness:
    a truncated sweep raises ``SweepInterrupted`` after committing them).
    ``on_violation="degrade"`` walks a guard-violating chunk down the
    engine -> numpy -> scalar ladder; ``"raise"`` surfaces the first
    violation.  ``oracle_cells`` is the per-chunk scalar-oracle sample size
    (0 keeps only the vectorized contract guards).  ``timeout_s`` bounds
    one chunk's device round-trip (default ``$REPRO_TORCH_SWEEP_TIMEOUT_S``,
    else unbounded); ``devices``/``health`` override device discovery (a
    sequence of ``torch.device``) and the eviction monitor (tests inject
    simulated fleets).
    """

    chunk_size: int = 256
    store: object | None = None
    resume: bool = True
    validate: bool = True
    oracle_cells: int = 4
    seed: int = 0
    max_chunks: int | None = None
    on_violation: str = "degrade"
    timeout_s: float | None = None
    retry: RetryPolicy | None = None
    devices: tuple | None = None
    health: object | None = None

    def __post_init__(self):
        if int(self.chunk_size) < 1:
            raise ContractViolationError("chunk_size must be >= 1")
        if self.on_violation not in _ON_VIOLATION:
            raise ContractViolationError(
                f"on_violation must be one of {_ON_VIOLATION}"
            )
        if self.max_chunks is not None and int(self.max_chunks) < 1:
            raise ContractViolationError("max_chunks must be >= 1 (or None)")


@dataclasses.dataclass
class ChunkRecord:
    """Per-chunk outcome: where its points came from and on which rung."""

    index: int
    points: int
    status: str  # "evaluated" | "resumed"
    rung: str  # evaluation rung that produced the accepted result
    guard: str  # "pass" | "skipped"
    attempts: int = 1

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class SweepReport:
    """Machine-readable account of one chunked sweep.

    ``records`` has one ``ChunkRecord`` per chunk (in index order);
    ``failures`` is the shared ``resilience.FailureReport`` vocabulary —
    every retry, degradation, eviction, quarantine, and raise is a typed
    record, so chaos CI can assert zero silent corruptions by set-matching
    injected faults against it.
    """

    kind: str
    n_points: int
    chunk_size: int
    chunks_total: int
    chunks_evaluated: int = 0
    chunks_resumed: int = 0
    chunks_quarantined: int = 0
    guard_checks: int = 0
    guard_failures: int = 0
    resubmits: int = 0
    records: list = dataclasses.field(default_factory=list)
    failures: FailureReport = dataclasses.field(default_factory=FailureReport)

    def rung_counts(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for r in self.records:
            out[r.rung] = out.get(r.rung, 0) + 1
        return out

    def guard_verdicts(self) -> dict[str, int]:
        """{"pass": n, "skipped": n, "fail": n} — fails counted from the
        guard_failures tally (a failed check never yields a chunk record)."""
        out = {"pass": 0, "skipped": 0, "fail": self.guard_failures}
        for r in self.records:
            out[r.guard] = out.get(r.guard, 0) + 1
        return out

    def summary(self) -> str:
        rungs = ", ".join(f"{k}x{n}" for k, n in sorted(self.rung_counts().items()))
        line = (
            f"{self.kind} sweep: {self.n_points} points in {self.chunks_total} "
            f"chunks of {self.chunk_size} — {self.chunks_evaluated} evaluated, "
            f"{self.chunks_resumed} resumed, {self.chunks_quarantined} "
            f"quarantined ({rungs or 'none'}); guards: {self.guard_checks} "
            f"checks, {self.guard_failures} violations"
        )
        if self.resubmits:
            line += f"; {self.resubmits} device resubmissions"
        if self.failures:
            line += f"; {self.failures.summary()}"
        return line

    def as_dict(self) -> dict:
        return {
            "kind": self.kind,
            "n_points": self.n_points,
            "chunk_size": self.chunk_size,
            "chunks_total": self.chunks_total,
            "chunks_evaluated": self.chunks_evaluated,
            "chunks_resumed": self.chunks_resumed,
            "chunks_quarantined": self.chunks_quarantined,
            "guard_checks": self.guard_checks,
            "guard_failures": self.guard_failures,
            "resubmits": self.resubmits,
            "rung_counts": self.rung_counts(),
            "guard_verdicts": self.guard_verdicts(),
            "records": [r.as_dict() for r in self.records],
            "failures": self.failures.as_dict(),
        }


class SweepInterrupted(EvaluationError):
    """A sweep stopped early on purpose (``max_chunks``) — completed chunks
    are committed, the partial ``SweepReport`` rides on ``.report``."""

    kind = "sweep-interrupted"

    def __init__(self, message: str, *, report: SweepReport, job="", stage=""):
        super().__init__(message, job=job, stage=stage)
        self.report = report


# ---------------------------------------------------------------------------
# Chunk payload codec — raw array bytes, NOT JSON floats: base64 of the
# exact buffer round-trips every bit pattern (including a poisoned NaN on
# its way into quarantine), which is what "resume bit-identically" means.
# ---------------------------------------------------------------------------


def _encode_field(arr) -> dict:
    arr = np.ascontiguousarray(arr)
    return {
        "dtype": arr.dtype.str,
        "shape": list(arr.shape),
        "data": base64.b64encode(arr.tobytes()).decode("ascii"),
    }


def _decode_field(doc: dict) -> np.ndarray:
    arr = np.frombuffer(base64.b64decode(doc["data"]), dtype=np.dtype(doc["dtype"]))
    return arr.reshape([int(s) for s in doc["shape"]]).copy()


def _encode_chunk(kind: str, index: int, rung: str, out: dict) -> dict:
    return {
        "kind": kind,
        "chunk": index,
        "rung": rung,
        "fields": {k: _encode_field(v) for k, v in out.items()},
    }


def _decode_chunk(payload: dict, kind: str, index: int, fields) -> tuple[dict, str]:
    if payload.get("kind") != kind or payload.get("chunk") != index:
        raise ValueError(
            f"chunk entry is for {payload.get('kind')}#{payload.get('chunk')}, "
            f"wanted {kind}#{index}"
        )
    docs = payload.get("fields")
    if not isinstance(docs, dict) or set(docs) != set(fields):
        raise ValueError("chunk entry field set does not match the engine schema")
    return {k: _decode_field(docs[k]) for k in fields}, str(payload.get("rung", "?"))


# ---------------------------------------------------------------------------
# Deterministic keying
# ---------------------------------------------------------------------------


def _digest(parts) -> bytes:
    h = hashlib.sha256()
    for tag, val in parts:
        h.update(tag.encode())
        h.update(b"=")
        h.update(val if isinstance(val, bytes) else str(val).encode())
        h.update(b";")
    return h.digest()


def _grid_parts(grid) -> list:
    return [
        ("rows", np.asarray(grid.rows, np.int64).tobytes()),
        ("cols", np.asarray(grid.cols, np.int64).tobytes()),
        ("b_h", np.asarray(grid.b_h, np.int64).tobytes()),
        ("b_v", np.asarray(grid.b_v, np.int64).tobytes()),
        ("b_v_data", np.asarray(grid.b_v_data, np.int64).tobytes()),
        ("bus_invert", np.asarray(grid.bus_invert, np.uint8).tobytes()),
        ("dataflow_os", np.asarray(grid.dataflow_os, np.uint8).tobytes()),
        ("pe_area", np.asarray(grid.pe_area_um2, np.float64).tobytes()),
        ("aspect_lo", repr(float(grid.aspect_lo))),
        ("aspect_hi", repr(float(grid.aspect_hi))),
    ]


def _spec_key(kind, grid, a_h, a_v, weights, extra) -> bytes:
    """Digest over everything that determines a chunk's bytes.  The starting
    rung is included deliberately: ``"cuda"``, ``"torch"`` and ``"numpy"``
    runs must not share chunks — they agree to tolerance, not bit for bit."""
    parts = [
        ("store", SWEEP_STORE_VERSION),
        ("kind", kind),
        *_grid_parts(grid),
        ("a_h", np.asarray(a_h, np.float64).tobytes()),
        ("a_v", np.asarray(a_v, np.float64).tobytes()),
        ("w", np.asarray(weights, np.float64).tobytes()),
        *extra,
    ]
    return _digest(parts)


def _chunk_key(spec: bytes, index: int) -> bytes:
    return hashlib.sha256(spec + b"|chunk|" + str(index).encode()).digest()


def _chunk_idx(index: int, chunk_size: int, n: int) -> np.ndarray:
    """Point indices of chunk ``index`` — clamp-padded to ``chunk_size`` by
    repeating the last point, so every chunk has one shape."""
    return np.minimum(np.arange(index * chunk_size, (index + 1) * chunk_size), n - 1)


def _chunk_points(index: int, chunk_size: int, n: int) -> int:
    return min(chunk_size, n - index * chunk_size)


def _on_device(fn, device: torch.device):
    """Run ``fn`` with ``device`` current; a CUDA device is synchronized
    before returning, so a dispatch timeout bounds the device round-trip."""
    if device.type != "cuda":
        return fn()
    with torch.cuda.device(device):
        out = fn()
        torch.cuda.synchronize(device)
    return out


def _concat_points(parts: list[dict], fields) -> dict:
    return {f: np.concatenate([p[f] for p in parts], axis=-1) for f in fields}


# ---------------------------------------------------------------------------
# Design-space engine adapter (evaluate + validate closures)
# ---------------------------------------------------------------------------


def _design_eval_factory(grid, a_h, a_v_eff, w, cfg, gss_iters, cs, n):
    from repro_torch.core.design_space import _evaluate_core, _run_core

    rows = np.asarray(grid.rows, float)
    cols = np.asarray(grid.cols, float)
    b_h = np.asarray(grid.b_h, float)
    b_v = np.asarray(grid.b_v, float)
    area = np.asarray(grid.pe_area_um2, float)
    lo, hi = float(grid.aspect_lo), float(grid.aspect_hi)
    core = functools.partial(_evaluate_core, gss_iters=gss_iters)

    def args_for(idx):
        return (
            rows[idx], cols[idx], b_h[idx], b_v[idx], area[idx],
            a_h[:, idx], a_v_eff[:, idx], w, lo, hi,
            cfg.vdd, cfg.freq_hz, cfg.wire_cap_f_per_um,
            cfg.non_bus_interconnect_fraction, cfg.interconnect_share_of_total,
        )

    def eval_chunk(rung, index, device=None):
        idx = _chunk_idx(index, cs, n)
        if rung in _DEVICE_RUNGS:
            return _on_device(lambda: _run_core(core, args_for(idx), device), device)
        if rung == "numpy":
            return _run_core(core, args_for(idx), None)
        # scalar rung: one point per call — nothing batched that could smear
        # one bad cell into its neighbors.
        parts = [_run_core(core, args_for(idx[j : j + 1]), None) for j in range(len(idx))]
        return _concat_points(parts, _DESIGN_FIELDS)

    return eval_chunk


def _design_validate_factory(grid, a_h, a_v, w, cfg, spec, oracle_cells, oracle_seed, cs, n):
    from repro_torch.core.floorplan import BusActivity, bus_power, optimal_aspect_power_arr
    from repro_torch.core.optimize import _power_shape, bus_invert_activity

    b_h = np.asarray(grid.b_h, float)
    b_v = np.asarray(grid.b_v, float)
    b_v_data = np.asarray(grid.b_v_data, np.int64)
    bi = np.asarray(grid.bus_invert, bool)
    lo, hi = float(grid.aspect_lo), float(grid.aspect_hi)
    has_one = lo <= 1.0 <= hi  # the square layout is inside the envelope
    eps, eps_a, tiny = _EPS, _EPS_ASPECT, _TINY

    def validate(out, index):
        idx = _chunk_idx(index, cs, n)
        v: list[str] = []

        missing = [f for f in _DESIGN_FIELDS if f not in out]
        if missing:
            return [f"missing fields {missing}"]
        for f in _DESIGN_FIELDS:
            if not np.isfinite(np.asarray(out[f], float)).all():
                v.append(f"non-finite values in {f}")
        if v:
            return v  # every further check is meaningless on NaN/Inf

        ave = np.asarray(out["a_v_eff"], float)
        avs = a_v[:, idx]
        ahs = a_h[:, idx]
        bi_c = bi[idx]
        if (ave < -eps).any() or (ave > 1 + eps).any():
            v.append("a_v_eff outside [0, 1]")
        if bi_c.any() and (ave[:, bi_c] > avs[:, bi_c] + 1e-6 + eps).any():
            v.append("coded activity exceeds raw (a_v_eff > a_v on BI points)")
        unc = ~bi_c
        if unc.any() and (
            np.abs(ave[:, unc] - avs[:, unc]) > 1e-6 + eps * np.abs(avs[:, unc])
        ).any():
            v.append("a_v_eff differs from a_v on uncoded points")

        for f in ("aspect_opt", "aspect_opt_gss"):
            a = np.asarray(out[f], float)
            if (a < lo * (1 - eps_a)).any() or (a > hi * (1 + eps_a)).any():
                v.append(f"{f} outside the aspect envelope [{lo}, {hi}]")
        ar = np.asarray(out["aspect_robust"], float)
        if (ar < lo * (1 - eps_a)).any() or (ar > hi * (1 + eps_a)).any():
            v.append("aspect_robust outside the aspect envelope")

        active_wp = ahs + np.maximum(ave, 0.0) > 1e-6  # (W, P)
        active_p = (w[:, None] * (ahs + np.maximum(ave, 0.0))).sum(0) > 1e-6
        for f, active in (
            ("bus_power_opt", active_wp),
            ("bus_power_sym", active_wp),
            ("bus_power_robust", active_p),
            ("bus_power_square", active_p),
        ):
            p = np.asarray(out[f], float)
            if (p < -tiny).any():
                v.append(f"negative power in {f}")
            elif (p[active] <= 0).any():
                v.append(f"zero power in {f} on cells with switching activity")

        if (np.asarray(out["max_regret"], float) < -eps).any():
            v.append("negative worst-case regret")
        for f in ("interconnect_saving", "total_saving"):
            if (np.asarray(out[f], float) > 1 + eps).any():
                v.append(f"{f} exceeds 1")
        if (np.asarray(out["area_um2"], float) <= 0).any():
            v.append("non-positive area")
        if has_one:
            # aspect_opt minimizes per-(workload, point) power over an
            # envelope containing the square layout, so it can never lose
            # to it.  (No analogous bound holds for interconnect_saving:
            # aspect_robust minimizes minimax REGRET, not weighted power.)
            p_opt = np.asarray(out["bus_power_opt"], float)
            p_sym = np.asarray(out["bus_power_sym"], float)
            if (p_opt > p_sym * (1 + 10 * eps) + tiny).any():
                v.append("bus_power_opt exceeds the square layout's power")

        # Cross-engine: the batched golden-section argmin must agree with
        # the closed-form Eq. 6 optimum — compared through the f64 power
        # shape at each aspect (aspect comparison is ill-conditioned: the
        # minimum is flat).
        ao = np.asarray(out["aspect_opt"], float)
        ag = np.asarray(out["aspect_opt_gss"], float)
        bh_c, bv_c = b_h[idx], b_v[idx]
        ave_cl = np.clip(ave, 0.0, 1.0)
        p_cf = _power_shape(bh_c, bv_c, ahs, ave_cl, ao, np)
        p_gs = _power_shape(bh_c, bv_c, ahs, ave_cl, ag, np)
        denom = np.maximum(np.minimum(p_cf, p_gs), tiny)
        if (np.abs(p_cf - p_gs) > _RTOL_GSS * denom + tiny).any():
            v.append(
                "cross-engine:gss-vs-closed-form optimal aspects disagree "
                f"(rtol {_RTOL_GSS})"
            )

        # Cross-engine: seeded random cells re-derived through the scalar
        # API (float64, no batching, no device) — the oracle of last resort.
        if oracle_cells > 0:
            rtol = _RTOL_ORACLE
            n_w = a_h.shape[0]
            for t in range(oracle_cells):
                h = hashlib.sha256(
                    spec + f"|oracle|{oracle_seed}|{index}|{t}".encode()
                ).digest()
                wi = int.from_bytes(h[:4], "big") % n_w
                j = int.from_bytes(h[4:8], "big") % len(idx)
                pj = int(idx[j])
                ah_s, av_s = float(a_h[wi, pj]), float(a_v[wi, pj])
                ave_ref = (
                    bus_invert_activity(av_s, int(b_v_data[pj]))
                    if bi[pj]
                    else av_s
                )
                cell = f"[{wi},{pj}]"
                if abs(float(ave[wi, j]) - ave_ref) > rtol * max(ave_ref, 1e-9) + 1e-7:
                    v.append(f"cross-engine:a_v_eff{cell} vs scalar bus_invert_activity")
                opt_ref = float(
                    optimal_aspect_power_arr(
                        b_h[pj], b_v[pj], ah_s, ave_ref, lo=lo, hi=hi, xp=np
                    )
                )
                if abs(float(ao[wi, j]) - opt_ref) > rtol * opt_ref + 1e-7:
                    v.append(f"cross-engine:aspect_opt{cell} vs scalar Eq. 6")
                p_ref = bus_power(
                    grid.geometry(pj),
                    BusActivity(ah_s, min(max(ave_ref, 0.0), 1.0)),
                    opt_ref,
                    vdd=cfg.vdd,
                    freq_hz=cfg.freq_hz,
                    wire_cap_f_per_um=cfg.wire_cap_f_per_um,
                )
                got_p = float(np.asarray(out["bus_power_opt"], float)[wi, j])
                if abs(got_p - p_ref) > rtol * max(p_ref, tiny):
                    v.append(f"cross-engine:bus_power_opt{cell} vs scalar bus_power")
        return v

    return validate


# ---------------------------------------------------------------------------
# Layout engine adapter
# ---------------------------------------------------------------------------


def _slice_objective(objective, sub_idx):
    """Per-chunk view of an ``ObjectiveSpec``: the lowered partition arrays
    and static power sliced along the point axis (all shapes end in P)."""
    from repro_torch.layout.coeffs import LoweredTensors
    from repro_torch.layout.power import ObjectiveSpec

    host = {
        k: np.ascontiguousarray(v[..., sub_idx])
        for k, v in objective.partition.host.items()
    }
    return ObjectiveSpec(
        partition=LoweredTensors(None, host),
        static_w=np.ascontiguousarray(
            np.asarray(objective.static_w, float)[:, sub_idx]
        ),
    )


def _layout_eval_factory(
    grid, a_h, a_v, layouts, h_lanes, v_lanes, w, cfg, gss_iters, cs, n,
    objective=None,
):
    from repro_torch.layout.coeffs import (
        DEVICE_FIELDS,
        lower_coding_multipliers,
        lower_layout_coeffs,
    )
    from repro_torch.layout.power import _mask_infeasible, _price, evaluate_layout_space

    fields = _OBJECTIVE_FIELDS if objective is not None else _LAYOUT_FIELDS
    coeffs = lower_layout_coeffs(
        grid,
        layouts,
        max_envelope_aspect=cfg.max_envelope_aspect,
        repeater_spacing_um=cfg.repeater_spacing_um,
    )
    coding = (
        lower_coding_multipliers(grid, a_v)
        if bool(np.any(np.asarray(grid.bus_invert)))
        else None
    )
    # Per-SWEEP device residency (made on a device's first chunk): the full
    # grid's tables and activities are copied to each device exactly once,
    # and every chunk gathers its points there.
    resident: dict = {}
    lock = threading.Lock()

    def tensors_on(device):
        def put(x):
            return None if x is None else torch.tensor(
                np.asarray(x, float), dtype=torch.float64, device=device)

        with lock:
            if device not in resident:
                st = {
                    "tables": coeffs.device(device),
                    "a_h": put(a_h),
                    "a_v": put(a_v),
                    "h_lanes": put(h_lanes),
                    "v_lanes": put(v_lanes),
                    "w": put(w),
                    "act_mult": None if coding is None else coding.device(device)["act_mult"],
                }
                if objective is not None:
                    dv = objective.partition.device(device)
                    rows_f = np.asarray(grid.rows, float)
                    st["obj"] = (
                        dv["utilization"],
                        dv["spill_words_per_mac"],
                        dv["trunk_words_per_mac"],
                        put(rows_f),
                        put(rows_f * np.asarray(grid.cols, float)),
                        put(objective.static_w),
                    )
                resident[device] = st
            return resident[device]

    def run_device(idx, device):
        st = tensors_on(device)
        ji = torch.as_tensor(idx, device=device)

        def take(t, dim=-1):
            return None if t is None else t.index_select(dim, ji)

        tables = {k: take(st["tables"][k]) for k in DEVICE_FIELDS}
        obj_args = (None,) * 6 if objective is None else tuple(take(t) for t in st["obj"])
        out = _price(
            tables, take(st["a_h"]), take(st["a_v"]), take(st["h_lanes"], 1),
            take(st["v_lanes"], 1), st["w"], take(st["act_mult"]), obj_args,
            cfg=cfg, rep_idx=coeffs.rep_idx, gss_iters=gss_iters, device=device,
        )
        out = _mask_infeasible(
            out,
            coeffs.host["feasible"][:, idx],
            None if objective is None else np.ascontiguousarray(
                objective.partition.host["utilization"][..., idx]),
        )
        out["feasible"] = coeffs.host["feasible"][:, idx]
        out["aspect_lo"] = coeffs.host["lo"][:, idx]
        out["aspect_hi"] = coeffs.host["hi"][:, idx]
        return out

    def run_numpy(sub_idx):
        ev = evaluate_layout_space(
            grid.select(sub_idx),
            a_h[:, sub_idx],
            a_v[:, sub_idx],
            layouts=layouts,
            h_lanes=None if h_lanes is None else h_lanes[:, sub_idx, :],
            v_lanes=None if v_lanes is None else v_lanes[:, sub_idx, :],
            weights=w,
            cfg=cfg,
            engine="numpy",
            gss_iters=gss_iters,
            objective=(
                None if objective is None else _slice_objective(objective, sub_idx)
            ),
        )
        return {f: np.asarray(getattr(ev, f)) for f in fields}

    def eval_chunk(rung, index, device=None):
        idx = _chunk_idx(index, cs, n)
        if rung in _DEVICE_RUNGS:
            return _on_device(lambda: run_device(idx, device), device)
        if rung == "numpy":
            return run_numpy(idx)
        return _concat_points([run_numpy(idx[j : j + 1]) for j in range(len(idx))], fields)

    return eval_chunk


def _layout_validate_factory(
    grid, a_h, a_v, layouts, h_lanes, v_lanes, w, cfg, spec, oracle_cells,
    oracle_seed, cs, n, objective=None,
):
    fields = _OBJECTIVE_FIELDS if objective is not None else _LAYOUT_FIELDS
    eps_a, tiny = _EPS_ASPECT, _TINY

    def validate(out, index):
        idx = _chunk_idx(index, cs, n)
        v: list[str] = []

        missing = [f for f in fields if f not in out]
        if missing:
            return [f"missing fields {missing}"]
        feas = np.asarray(out["feasible"], bool)
        infeas = ~feas
        for f in ("bus_power_robust", "overhead_w", "wirelength_um"):
            arr = np.asarray(out[f], float)
            if np.isnan(arr).any():
                v.append(f"NaN values in {f}")
                continue
            if infeas.any() and not np.isinf(arr[infeas]).all():
                v.append(f"{f} finite on infeasible cells")
            if feas.any() and not np.isfinite(arr[feas]).all():
                v.append(f"{f} non-finite on feasible cells")
        po = np.asarray(out["bus_power_opt"], float)
        if np.isnan(po).any():
            v.append("NaN values in bus_power_opt")
        else:
            if infeas.any() and not np.isinf(po[:, infeas]).all():
                v.append("bus_power_opt finite on infeasible cells")
            if feas.any() and not np.isfinite(po[:, feas]).all():
                v.append("bus_power_opt non-finite on feasible cells")
        for f in ("aspect_lo", "aspect_hi", "aspect_opt", "aspect_robust"):
            if not np.isfinite(np.asarray(out[f], float)).all():
                v.append(f"non-finite values in {f}")
        if v:
            return v

        alo = np.asarray(out["aspect_lo"], float)
        ahi = np.asarray(out["aspect_hi"], float)
        ao = np.asarray(out["aspect_opt"], float)
        ar = np.asarray(out["aspect_robust"], float)
        bad = feas[None] & ((ao < alo[None] * (1 - eps_a)) | (ao > ahi[None] * (1 + eps_a)))
        if bad.any():
            v.append("aspect_opt outside the per-cell aspect window")
        bad = feas & ((ar < alo * (1 - eps_a)) | (ar > ahi * (1 + eps_a)))
        if bad.any():
            v.append("aspect_robust outside the per-cell aspect window")

        pr = np.asarray(out["bus_power_robust"], float)
        ov = np.asarray(out["overhead_w"], float)
        wl = np.asarray(out["wirelength_um"], float)
        active = (w[:, None] * (a_h[:, idx] + a_v[:, idx])).sum(0) > 1e-9  # (P,)
        if (pr[feas] < -tiny).any():
            v.append("negative power in bus_power_robust")
        elif (feas & active[None] & (pr <= 0)).any():
            v.append("zero bus_power_robust on cells with switching activity")
        if (ov[feas] < -tiny).any():
            v.append("negative overhead power")
        if (wl[feas] <= 0).any():
            v.append("non-positive wirelength on feasible cells")

        # J/op contracts (objective mode): utilization is a pure pass-through
        # of the lowered partition arrays (bit-exact), and j_per_mac must be
        # finite and positive exactly on live cells — a NaN anywhere in the
        # objective fields is a poisoned/miscomputed chunk.
        if objective is not None:
            util = np.asarray(out["utilization"], float)
            jpm = np.asarray(out["j_per_mac"], float)
            jpr = np.asarray(out["j_per_mac_robust"], float)
            if np.isnan(util).any():
                v.append("NaN values in utilization")
            elif (util < -tiny).any() or (util > 1.0 + 1e-6).any():
                v.append("utilization outside [0, 1]")
            elif not np.array_equal(
                util, objective.partition.host["utilization"][..., idx]
            ):
                v.append(
                    "utilization differs from the lowered partition arrays"
                )
            if np.isnan(jpm).any():
                v.append("NaN values in j_per_mac")
            else:
                dead = (~feas[None]) | (util <= 0.0)
                if dead.any() and not np.isinf(jpm[dead]).all():
                    v.append("j_per_mac finite on infeasible/zero-MAC cells")
                live = ~dead
                if live.any():
                    if not np.isfinite(jpm[live]).all():
                        v.append("j_per_mac non-finite on live cells")
                    elif (jpm[live] <= 0).any():
                        v.append("non-positive j_per_mac on live cells")
            if np.isnan(jpr).any():
                v.append("NaN values in j_per_mac_robust")
            else:
                if infeas.any() and not np.isinf(jpr[infeas]).all():
                    v.append("j_per_mac_robust finite on infeasible cells")
                if feas.any():
                    if not np.isfinite(jpr[feas]).all():
                        v.append("j_per_mac_robust non-finite on feasible cells")
                    elif (jpr[feas] < -tiny).any():
                        v.append("negative j_per_mac_robust")

        if oracle_cells > 0 and feas.any():
            from repro_torch.core.floorplan import BusActivity
            from repro_torch.core.optimize import bus_invert_activity
            from repro_torch.layout.geometry import get_layout
            from repro_torch.layout.power import rollup_segments, segment_bus_power
            from repro_torch.layout.segments import enumerate_segments

            cells = np.argwhere(feas)
            n_w = a_h.shape[0]
            bi = np.asarray(grid.bus_invert, bool)
            b_v_data = np.asarray(grid.b_v_data, np.int64)
            # Cross-engine: seeded feasible cells re-priced through the
            # explicit per-segment enumeration (``segment_bus_power``) — the
            # segment engine's own scalar oracle.  On bus-invert points the
            # engine's coding multipliers scale every v-class activity by
            # coded/raw, which is exactly pricing the segments at the coded
            # activity — so the oracle codes its scalar a_v the same way.
            for t in range(oracle_cells):
                h = hashlib.sha256(
                    spec + f"|loracle|{oracle_seed}|{index}|{t}".encode()
                ).digest()
                li, j = cells[int.from_bytes(h[:4], "big") % len(cells)]
                wi = int.from_bytes(h[4:8], "big") % n_w
                li, j, pj = int(li), int(j), int(idx[int(j)])
                asp = float(ao[wi, li, j])
                av_s = float(a_v[wi, pj])
                if bi[pj]:
                    av_s = bus_invert_activity(av_s, int(b_v_data[pj]))
                ref = segment_bus_power(
                    get_layout(layouts[li]),
                    grid.geometry(pj),
                    BusActivity(float(a_h[wi, pj]), av_s),
                    asp,
                    dataflow="OS" if grid.dataflow_os[pj] else "WS",
                    h_lanes=None if h_lanes is None else h_lanes[wi, pj],
                    v_lanes=None if v_lanes is None else v_lanes[wi, pj],
                    cfg=cfg,
                )
                got = float(po[wi, li, j])
                if abs(got - ref) > _RTOL_SEGMENTS * max(ref, tiny):
                    v.append(
                        f"cross-engine:bus_power_opt[{wi},{li},{pj}] vs "
                        "segment enumeration"
                    )
            # Coefficient-protocol parity: the OVERHEAD side of the schema
            # (preload/drain/clk priced once at the robust aspect) re-priced
            # through the explicit enumeration — the loracle guard above
            # covers the data nets, this one everything else the coefficient
            # path folds.
            for t in range(oracle_cells):
                h = hashlib.sha256(
                    spec + f"|coparity|{oracle_seed}|{index}|{t}".encode()
                ).digest()
                li, j = cells[int.from_bytes(h[:4], "big") % len(cells)]
                li, j = int(li), int(j)
                pj = int(idx[j])
                geom = grid.geometry(pj)
                segs = enumerate_segments(
                    get_layout(layouts[li]),
                    geom.rows,
                    geom.cols,
                    geom.b_h,
                    geom.b_v,
                    geom.pe_area_um2,
                    float(ar[li, j]),
                    dataflow="OS" if grid.dataflow_os[pj] else "WS",
                    nets=("preload", "drain", "clk"),
                )
                ref = rollup_segments(segs, 0.0, 0.0, cfg=cfg)["overhead_w"]
                got = float(ov[li, j])
                if abs(got - ref) > _RTOL_SEGMENTS * max(ref, tiny):
                    v.append(
                        f"coeff-parity:overhead_w[{li},{pj}] vs segment "
                        "enumeration"
                    )
        return v

    return validate


# ---------------------------------------------------------------------------
# The chunked runner
# ---------------------------------------------------------------------------


def _resolve_store(sweep: SweepConfig) -> ContentStore | None:
    if sweep.store is None:
        return None
    if isinstance(sweep.store, ContentStore):
        return sweep.store
    return ContentStore(
        sweep.store, version=SWEEP_STORE_VERSION, corrupt_site="chunk-store-read"
    )


def _local_devices(rung: str) -> list[torch.device]:
    """The devices a device rung's chunks spread over: every visible CUDA
    device for ``"cuda"``, the CPU for ``"torch"``."""
    if rung == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def _poisoned(out: dict, rung: str, index: int) -> dict:
    """Expose every result field to the NaN/Inf fault hook — the injected
    corruption is indistinguishable from a silent miscompute, so only the
    guards can catch it."""
    inj = faults.active()
    if inj is None:
        return out
    return {
        k: inj.maybe_poison(v, f"sweep-result:{rung}:{k}", f"chunk{index}")
        for k, v in out.items()
    }


def _guard_error(violations, *, job, stage):
    cls = (
        CrossEngineMismatchError
        if any(s.startswith("cross-engine") for s in violations)
        else GuardViolationError
    )
    return cls(
        "; ".join(violations), violations=violations, job=job, stage=stage
    )


def _run_chunked(
    kind, n, sweep, *, start_rung, spec, eval_chunk, validate_chunk, fields
):
    cs = int(sweep.chunk_size)
    chunks_total = -(-n // cs)
    report = SweepReport(
        kind=kind, n_points=n, chunk_size=cs, chunks_total=chunks_total
    )
    store = _resolve_store(sweep)
    policy = sweep.retry if sweep.retry is not None else _DEFAULT_RETRY
    timeout_s = sweep.timeout_s
    if timeout_s is None:
        env = os.environ.get("REPRO_TORCH_SWEEP_TIMEOUT_S", "").strip()
        timeout_s = float(env) if env else None

    # -- phase 0: resume — serve completed chunks from the store ------------
    results: dict[int, dict] = {}
    to_compute: list[int] = []
    if store is not None and sweep.resume:
        for i in range(chunks_total):
            payload = store.get_payload(_chunk_key(spec, i))
            if payload is None:
                to_compute.append(i)
                continue
            try:
                out, rung = _decode_chunk(payload, kind, i, fields)
            except Exception as exc:
                # sha-valid but schema-invalid (drift inside the version):
                # same semantics as corruption — recompute and overwrite.
                report.failures.add(
                    CacheCorruptionError(
                        f"stored chunk {i} failed decode: {exc}",
                        job=f"chunk{i}",
                        stage="sweep-resume",
                    ),
                    action="quarantined:recomputed",
                )
                report.chunks_quarantined += 1
                to_compute.append(i)
                continue
            if sweep.validate:
                report.guard_checks += 1
                viols = validate_chunk(out, i)
                if viols:
                    report.guard_failures += 1
                    report.failures.add(
                        _guard_error(viols, job=f"chunk{i}", stage="sweep-resume"),
                        action="quarantined:recomputed",
                    )
                    report.chunks_quarantined += 1
                    to_compute.append(i)
                    continue
            results[i] = out
            report.chunks_resumed += 1
            report.records.append(
                ChunkRecord(
                    i,
                    _chunk_points(i, cs, n),
                    "resumed",
                    rung,
                    "pass" if sweep.validate else "skipped",
                )
            )
        # Entries the store itself quarantined (sha mismatch on read) — the
        # get returned None, so their chunks are already queued to recompute.
        for key_hex in store.drain_quarantine_events():
            report.chunks_quarantined += 1
            report.failures.add(
                CacheCorruptionError(
                    f"chunk entry {key_hex} failed verification; quarantined",
                    stage="sweep-resume",
                ),
                action="quarantined:recomputed",
            )
    else:
        to_compute = list(range(chunks_total))

    # -- phase 1: bound this call's work (the kill-and-resume harness) ------
    interrupted = sweep.max_chunks is not None and len(to_compute) > sweep.max_chunks
    pending_after = 0
    if interrupted:
        pending_after = len(to_compute) - int(sweep.max_chunks)
        to_compute = to_compute[: int(sweep.max_chunks)]

    # -- phase 2: fresh device-rung chunks, sharded across its devices -------
    dev_out: dict[int, tuple[dict, int]] = {}
    dev_err: dict[int, ProfileError] = {}
    if start_rung in _DEVICE_RUNGS and to_compute:
        devices = (
            list(sweep.devices) if sweep.devices is not None
            else _local_devices(start_rung)
        )
        health = (
            sweep.health
            if sweep.health is not None
            else HealthMonitor(range(len(devices)))
        )

        def run_on(index, di):
            inj = faults.active()

            def attempt():
                if inj is not None:
                    inj.maybe_fail_backend(f"sweep-chunk:{start_rung}", f"chunk{index}")
                    inj.maybe_hang(f"sweep-chunk:d{di}", f"chunk{index}")
                    inj.maybe_lose_device(f"sweep-chunk:d{di}", f"chunk{index}")
                return _poisoned(
                    eval_chunk(start_rung, index, devices[di]), start_rung, index
                )

            # Only compile-class failures retry here: dispatch-class ones
            # (timeout, device loss) belong to the eviction layer below.
            res, attempts, last = call_with_retry(
                attempt,
                policy=policy,
                key=f"{kind}:chunk{index}:{start_rung}",
                retry_on=(BackendCompileError,),
            )
            if last is not None:
                report.failures.add(
                    last,
                    action="retried",
                    job=f"chunk{index}",
                    stage=f"sweep-{start_rung}",
                    attempts=attempts,
                )
            return res, attempts

        alive = health.alive_hosts() or [0]
        if timeout_s is not None or len(devices) > 1:
            with ThreadPoolExecutor(max_workers=max(2, len(devices))) as ex:
                subs = [
                    (i, alive[k % len(alive)]) for k, i in enumerate(to_compute)
                ]
                subs = [(i, di, ex.submit(run_on, i, di)) for i, di in subs]
                for i, di, fut in subs:
                    t0 = time.monotonic()
                    try:
                        dev_out[i] = fut.result(timeout=timeout_s)
                        health.heartbeat(di, time.monotonic())
                        health.report_step_time(di, time.monotonic() - t0)
                        continue
                    except faults.InjectedAbortError:
                        raise
                    except Exception as exc:
                        err = classify_exception(
                            exc, job=f"chunk{i}", stage="sweep-dispatch"
                        )
                    if isinstance(err, DeviceDispatchError):
                        # Evict the device and resubmit the chunk EXACTLY
                        # ONCE to a surviving device.
                        health.evict(di)
                        survivors = health.alive_hosts()
                        if survivors:
                            report.resubmits += 1
                            report.failures.add(
                                err,
                                action="device-evicted:resubmitted",
                                job=f"chunk{i}",
                                stage="sweep-dispatch",
                            )
                            try:
                                dev_out[i] = ex.submit(
                                    run_on, i, survivors[0]
                                ).result(timeout=timeout_s)
                                health.heartbeat(survivors[0], time.monotonic())
                                continue
                            except faults.InjectedAbortError:
                                raise
                            except Exception as exc2:
                                err = classify_exception(
                                    exc2, job=f"chunk{i}", stage="sweep-dispatch"
                                )
                    dev_err[i] = err
        else:
            for i in to_compute:
                try:
                    dev_out[i] = run_on(i, 0)
                except faults.InjectedAbortError:
                    raise
                except Exception as exc:
                    dev_err[i] = classify_exception(
                        exc, job=f"chunk{i}", stage=f"sweep-{start_rung}"
                    )

    # -- phase 3: validate, degrade down the ladder, commit -----------------
    ladder = evaluation_ladder(start_rung)
    for i in to_compute:
        out = None
        used = None
        attempts = 1
        last_err: ProfileError | None = None
        for ri, rung in enumerate(ladder):
            nxt = ladder[ri + 1] if ri + 1 < len(ladder) else None
            if rung in _DEVICE_RUNGS:
                if i in dev_out:
                    cand, attempts = dev_out[i]
                else:
                    last_err = dev_err.get(i) or EvaluationError(
                        f"{rung} chunk evaluation unavailable",
                        job=f"chunk{i}",
                        stage=f"sweep-{rung}",
                    )
                    report.failures.add(
                        last_err, action=f"degraded:{nxt}", job=f"chunk{i}"
                    )
                    continue
            else:
                inj = faults.active()

                def attempt(rung=rung, index=i, inj=inj):
                    if inj is not None:
                        inj.maybe_fail_backend(
                            f"sweep-chunk:{rung}", f"chunk{index}"
                        )
                    return _poisoned(eval_chunk(rung, index), rung, index)

                try:
                    cand, attempts, last = call_with_retry(
                        attempt,
                        policy=policy,
                        key=f"{kind}:chunk{i}:{rung}",
                        retry_on=(BackendCompileError, DeviceDispatchError),
                    )
                    if last is not None:
                        report.failures.add(
                            last,
                            action="retried",
                            job=f"chunk{i}",
                            stage=f"sweep-{rung}",
                            attempts=attempts,
                        )
                except faults.InjectedAbortError:
                    raise
                except Exception as exc:
                    last_err = classify_exception(
                        exc, job=f"chunk{i}", stage=f"sweep-{rung}"
                    )
                    if nxt is None:
                        report.failures.add(last_err, action="raised")
                        raise last_err from exc
                    report.failures.add(last_err, action=f"degraded:{nxt}")
                    continue
            if sweep.validate:
                report.guard_checks += 1
                viols = validate_chunk(cand, i)
                if viols:
                    report.guard_failures += 1
                    err = _guard_error(viols, job=f"chunk{i}", stage=f"sweep-{rung}")
                    last_err = err
                    if sweep.on_violation == "raise" or nxt is None:
                        report.failures.add(err, action="raised")
                        raise err
                    report.failures.add(err, action=f"degraded:{nxt}")
                    continue
            out, used = cand, rung
            break
        if out is None:  # pragma: no cover - every exit above raises
            raise last_err
        # Commit BEFORE the abort hook: an injected mid-sweep abort lands at
        # the chunk boundary, so exactly the committed chunks survive —
        # the resume path's contract.
        if store is not None:
            store.put_payload(_chunk_key(spec, i), _encode_chunk(kind, i, used, out))
        inj = faults.active()
        if inj is not None:
            inj.maybe_abort("sweep-commit", f"chunk{i}")
        results[i] = out
        report.chunks_evaluated += 1
        report.records.append(
            ChunkRecord(
                i,
                _chunk_points(i, cs, n),
                "evaluated",
                used,
                "pass" if sweep.validate else "skipped",
                attempts,
            )
        )

    if interrupted:
        raise SweepInterrupted(
            f"sweep stopped after {len(to_compute)} chunks (max_chunks="
            f"{sweep.max_chunks}); {pending_after} chunks remain — rerun with "
            "the same store to resume",
            report=report,
            stage="sweep",
        )

    # -- phase 4: assemble — concatenate chunks, trim the clamp padding -----
    assembled = {
        f: np.ascontiguousarray(
            np.concatenate(
                [np.asarray(results[i][f]) for i in range(chunks_total)], axis=-1
            )[..., :n]
        )
        for f in fields
    }
    return assembled, report


# ---------------------------------------------------------------------------
# Public entry points (called by the engines when ``sweep=`` is passed)
# ---------------------------------------------------------------------------


def run_design_sweep(grid, a_h, a_v, weights, *, cfg, gss_iters, engine, sweep):
    """Chunked, validated, resumable ``evaluate_design_space`` execution.

    Inputs arrive pre-normalized from the engine (activities broadcast to
    (W, P), weights normalized, ``engine`` checked); chunks start on the
    ``engine`` rung.  Returns ``(fields, SweepReport)`` where ``fields``
    carries exactly the ``DesignSpaceEval`` arrays.
    """
    n = grid.n_points
    if n == 0:
        raise ContractViolationError("cannot sweep an empty design grid")
    # Coding lowered ONCE over the full grid (exact host float64) — chunks
    # slice the effective activities, so the coding flag never reaches the
    # evaluator program and cannot change semantics between chunks.
    from repro_torch.core.design_space import _effective_a_v

    a_v_eff = _effective_a_v(grid, a_v)
    cs = int(sweep.chunk_size)
    spec = _spec_key(
        "design",
        grid,
        a_h,
        a_v,
        weights,
        extra=[
            ("cfg", repr(dataclasses.astuple(cfg))),
            ("gss_iters", int(gss_iters)),
            ("chunk_size", cs),
            ("start_rung", engine),
        ],
    )
    return _run_chunked(
        "design",
        n,
        sweep,
        start_rung=engine,
        spec=spec,
        eval_chunk=_design_eval_factory(
            grid, a_h, a_v_eff, weights, cfg, gss_iters, cs, n
        ),
        validate_chunk=_design_validate_factory(
            grid, a_h, a_v, weights, cfg, spec, int(sweep.oracle_cells),
            int(sweep.seed), cs, n,
        ),
        fields=_DESIGN_FIELDS,
    )


def run_layout_sweep(
    grid,
    a_h,
    a_v,
    weights,
    *,
    layouts,
    h_lanes,
    v_lanes,
    cfg,
    gss_iters,
    engine,
    sweep,
    objective=None,
):
    """Chunked, validated, resumable ``evaluate_layout_space`` execution.

    Returns ``(fields, SweepReport)`` with the ``LayoutSpaceEval`` arrays
    (including ``feasible`` and the per-cell aspect window).  With an
    ``ObjectiveSpec`` (``objective=``), chunks carry the fused J/op fields
    too, keyed as a distinct ``"objective"`` sweep kind — the spec digest
    additionally covers the lowered partition arrays (their content key)
    and the calibrated static power, so J/op chunks never alias wire-power
    chunks over the same grid.
    """
    n = grid.n_points
    if n == 0:
        raise ContractViolationError("cannot sweep an empty design grid")
    cs = int(sweep.chunk_size)
    layouts = tuple(layouts)
    kind = "layout" if objective is None else "objective"
    fields = _LAYOUT_FIELDS if objective is None else _OBJECTIVE_FIELDS
    extra = [
        ("layouts", ",".join(layouts)),
        (
            "h_lanes",
            b"none" if h_lanes is None else np.asarray(h_lanes, np.float64).tobytes(),
        ),
        (
            "v_lanes",
            b"none" if v_lanes is None else np.asarray(v_lanes, np.float64).tobytes(),
        ),
        ("cfg", repr(dataclasses.astuple(cfg))),
        ("gss_iters", int(gss_iters)),
        ("chunk_size", cs),
        ("start_rung", engine),
    ]
    if objective is not None:
        part = objective.partition
        part_key = part.key
        if part_key is None:  # a sliced/ad-hoc entry: key over content
            part_key = hashlib.sha256(
                b"".join(
                    np.ascontiguousarray(part.host[k]).tobytes()
                    for k in sorted(part.host)
                )
            ).hexdigest()
        extra += [
            ("partition", str(part_key)),
            ("static_w", np.asarray(objective.static_w, np.float64).tobytes()),
        ]
    spec = _spec_key(kind, grid, a_h, a_v, weights, extra=extra)
    return _run_chunked(
        kind,
        n,
        sweep,
        start_rung=engine,
        spec=spec,
        eval_chunk=_layout_eval_factory(
            grid, a_h, a_v, layouts, h_lanes, v_lanes, weights, cfg, gss_iters,
            cs, n, objective=objective,
        ),
        validate_chunk=_layout_validate_factory(
            grid, a_h, a_v, layouts, h_lanes, v_lanes, weights, cfg, spec,
            int(sweep.oracle_cells), int(sweep.seed), cs, n,
            objective=objective,
        ),
        fields=fields,
    )
