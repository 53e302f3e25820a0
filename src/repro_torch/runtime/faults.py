"""Deterministic fault injection for the profiling pipeline.

The resilience layer (retry ladder, device eviction, store quarantine) is
only trustworthy if every recovery path actually RUNS — so this module
plants seeded, reproducible faults at the pipeline's real failure sites:

  * ``backend``     — raise ``BackendCompileError`` where a fused program
                      would compile/dispatch (bucket, stream bucket, ladder
                      rungs);
  * ``hang``        — sleep at a dispatch site long enough to trip the
                      pipeline's dispatch timeout (drives eviction);
  * ``device_loss`` — raise ``DeviceLossError`` from a device shard
                      (drives eviction + resubmission);
  * ``bitflip``     — flip one bit of an on-disk store entry's payload as
                      it is read (drives integrity quarantine + recompute);
                      fires at every ``ContentStore`` read site, so it
                      covers the profile store AND the sweep chunk store;
  * ``nan``         — overwrite one element of an evaluator result array
                      with NaN/Inf (drives the sweep guard rails + the
                      engine -> numpy -> scalar evaluation ladder);
  * ``abort``       — raise ``InjectedAbortError`` (a ``BaseException``, so
                      recovery machinery cannot swallow it) at a sweep
                      commit boundary — models ``kill -9`` mid-sweep for
                      the resume path.

Determinism: each injection site draws from
``sha256(seed | kind | site | key | seq)`` where ``seq`` counts calls to
that exact (kind, site, key) — the Nth retry of the same job redraws, so
``rate < 1`` models transient faults, ``rate = 1`` permanent ones, and the
whole schedule is a pure function of the seed and the call sequence (no
wall clock, no global RNG).  ``FaultSpec.match`` pins a fault to sites/keys
containing a substring — tests aim a fault at one bucket or one device.

Activation: explicitly via ``install``/``injected(...)``, or from the
environment (``REPRO_TORCH_FAULTS="backend=0.1,hang=0.05,bitflip=1,seed=7"``)
so a chaos CI job can run the whole tier-1 suite under injection with zero
code changes.  The port's variables carry their own ``REPRO_TORCH_``
prefix: settings meant for the JAX package do not arm it.  ``active()`` is
the single lookup the pipeline uses; when nothing is installed and the env
var is unset it costs a None check.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import os
import threading
import time

import numpy as np

from repro_torch.runtime.resilience import (
    BackendCompileError,
    DeviceLossError,
)

__all__ = [
    "FaultSpec",
    "FaultInjector",
    "FireRecord",
    "InjectedAbortError",
    "install",
    "clear",
    "active",
    "injected",
    "from_env",
    "KINDS",
]

KINDS = ("backend", "hang", "bitflip", "device_loss", "nan", "abort")


class InjectedAbortError(BaseException):
    """An injected hard process death (``kill -9`` stand-in).

    Deliberately a ``BaseException``: the sweep runner's recovery paths
    catch ``Exception`` subclasses, so an injected abort tears through them
    exactly like a real SIGKILL would — only the crash-safe store commits
    made BEFORE the abort survive, which is precisely what the resume tests
    need to prove."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One injector class: fire with probability ``rate`` per opportunity.

    ``match`` (optional) restricts firing to sites where
    ``match in f"{site}|{key}"``; ``max_fires`` caps total fires (None =
    unlimited).
    """

    kind: str
    rate: float = 1.0
    match: str | None = None
    max_fires: int | None = None

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; know {KINDS}")
        if not 0.0 <= self.rate <= 1.0:
            raise ValueError("rate must be in [0, 1]")


@dataclasses.dataclass(frozen=True)
class FireRecord:
    """One fault that actually fired (the failure-report cross-check)."""

    kind: str
    site: str
    key: str
    seq: int


class FaultInjector:
    """Seeded injector evaluated at the pipeline's hook points.

    Thread-safe: dispatch workers draw concurrently.  ``fired`` is the
    append-only log of every fault that fired — benchmarks assert that each
    fired fault is accounted for in ``BatchStats.failure_report``.
    """

    def __init__(
        self,
        specs: list[FaultSpec] | tuple[FaultSpec, ...],
        *,
        seed: int = 0,
        hang_s: float = 0.25,
    ):
        self.specs = tuple(specs)
        self.seed = seed
        self.hang_s = hang_s
        self.fired: list[FireRecord] = []
        self._seq: dict[tuple, int] = {}
        self._fires_per_spec: dict[int, int] = {}
        self._lock = threading.Lock()

    def _draw(self, kind: str, site: str, key: str) -> bool:
        with self._lock:
            hit = False
            for i, spec in enumerate(self.specs):
                if spec.kind != kind:
                    continue
                if spec.match is not None and spec.match not in f"{site}|{key}":
                    continue
                if (
                    spec.max_fires is not None
                    and self._fires_per_spec.get(i, 0) >= spec.max_fires
                ):
                    continue
                sk = (kind, site, key)
                seq = self._seq.get(sk, 0)
                self._seq[sk] = seq + 1
                h = hashlib.sha256(
                    f"{self.seed}|{kind}|{site}|{key}|{seq}".encode()
                ).digest()
                u = int.from_bytes(h[:8], "big") / float(1 << 64)
                if u < spec.rate:
                    self._fires_per_spec[i] = self._fires_per_spec.get(i, 0) + 1
                    self.fired.append(FireRecord(kind, site, key, seq))
                    hit = True
                break  # first matching spec owns this (kind, site, key)
            return hit

    # -- hook points (no-ops unless a matching spec fires) -------------------

    def maybe_fail_backend(self, site: str, key: str = "") -> None:
        """Raise an injected compile/dispatch failure at ``site``."""
        if self._draw("backend", site, key):
            raise BackendCompileError(
                f"injected backend fault at {site} ({key})", stage=site
            )

    def maybe_hang(self, site: str, key: str = "") -> None:
        """Stall ``hang_s`` seconds at ``site`` (models a wedged dispatch)."""
        if self._draw("hang", site, key):
            time.sleep(self.hang_s)

    def maybe_lose_device(self, site: str, key: str = "") -> None:
        """Raise an injected device loss at ``site``."""
        if self._draw("device_loss", site, key):
            raise DeviceLossError(
                f"injected device loss at {site} ({key})", stage=site
            )

    def maybe_corrupt(self, payload: bytes, site: str, key: str = "") -> bytes:
        """Return ``payload`` with one deterministically-chosen bit flipped
        (when the fault fires), else unchanged."""
        if not payload or not self._draw("bitflip", site, key):
            return payload
        h = hashlib.sha256(f"{self.seed}|bit|{site}|{key}".encode()).digest()
        pos = int.from_bytes(h[:8], "big") % len(payload)
        bit = h[8] % 8
        out = bytearray(payload)
        out[pos] ^= 1 << bit
        return bytes(out)

    def maybe_poison(self, value, site: str, key: str = ""):
        """Return ``value`` (a float array) with one deterministically-chosen
        element overwritten by NaN or +Inf when the fault fires, else
        ``value`` unchanged.  The poisoned copy keeps dtype and shape — the
        corruption is indistinguishable from a real silent miscompute, which
        is the point: only a guard can catch it."""
        arr = np.asarray(value)
        if arr.size == 0 or not np.issubdtype(arr.dtype, np.floating):
            return value
        if not self._draw("nan", site, key):
            return value
        h = hashlib.sha256(f"{self.seed}|nan|{site}|{key}".encode()).digest()
        pos = int.from_bytes(h[:8], "big") % arr.size
        out = np.array(arr, copy=True)
        out.flat[pos] = np.nan if h[8] % 2 == 0 else np.inf
        return out

    def maybe_abort(self, site: str, key: str = "") -> None:
        """Raise an injected process abort at ``site`` (kill -9 stand-in)."""
        if self._draw("abort", site, key):
            raise InjectedAbortError(f"injected abort at {site} ({key})")

    def fired_kinds(self) -> set[str]:
        return {f.kind for f in self.fired}


# --- activation -------------------------------------------------------------

_ACTIVE: FaultInjector | None = None
_ENV_CHECKED = False


def install(injector: FaultInjector | None) -> None:
    """Make ``injector`` the process-wide active injector (None disables)."""
    global _ACTIVE, _ENV_CHECKED
    _ACTIVE = injector
    _ENV_CHECKED = True  # explicit install wins over the environment


def clear() -> None:
    """Disable injection (and re-arm env discovery for the next ``active``)."""
    global _ACTIVE, _ENV_CHECKED
    _ACTIVE = None
    _ENV_CHECKED = False


def active() -> FaultInjector | None:
    """The installed injector, else one parsed from ``$REPRO_TORCH_FAULTS`` (once)."""
    global _ACTIVE, _ENV_CHECKED
    if _ACTIVE is None and not _ENV_CHECKED:
        _ENV_CHECKED = True
        _ACTIVE = from_env()
    return _ACTIVE


@contextlib.contextmanager
def injected(
    specs: list[FaultSpec] | tuple[FaultSpec, ...],
    *,
    seed: int = 0,
    hang_s: float = 0.25,
):
    """Scoped injection: installs a fresh injector, yields it, restores."""
    prev, prev_checked = _ACTIVE, _ENV_CHECKED
    inj = FaultInjector(specs, seed=seed, hang_s=hang_s)
    install(inj)
    try:
        yield inj
    finally:
        install(prev)
        if prev is None and not prev_checked:
            clear()  # restore lazy env discovery, not an explicit None pin


def from_env(env: dict | None = None) -> FaultInjector | None:
    """Parse ``REPRO_TORCH_FAULTS`` into an injector.

    Format: comma-separated ``kind=rate`` terms plus optional ``seed=N``
    and ``hang_s=F``, e.g. ``"backend=0.1,hang=0.05,bitflip=1,seed=7"``.
    Unset/empty disables injection.  Malformed specs raise loudly —
    silently ignoring a typo'd chaos config would un-test every recovery
    path while claiming coverage.
    """
    env = os.environ if env is None else env
    raw = env.get("REPRO_TORCH_FAULTS", "").strip()
    if not raw:
        return None
    seed, hang_s = 0, 0.25
    specs: list[FaultSpec] = []
    for term in raw.split(","):
        term = term.strip()
        if not term:
            continue
        name, _, val = term.partition("=")
        name = name.strip()
        if name == "seed":
            seed = int(val)
        elif name == "hang_s":
            hang_s = float(val)
        else:
            specs.append(FaultSpec(kind=name, rate=float(val) if val else 1.0))
    if not specs:
        return None
    return FaultInjector(specs, seed=seed, hang_s=hang_s)
