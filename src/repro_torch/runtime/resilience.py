"""Typed errors and warnings raised by the switching-activity profiler.

Only the three types ``core.switching`` raises are here; the recovery
ladder, health checks and fault injection of the reference are not part of
this package yet.
"""

from __future__ import annotations

__all__ = ["ContractViolationError", "ProfileDegradationWarning", "CacheThrashWarning"]


class ContractViolationError(ValueError):
    """The request itself is invalid (bad GEMM shapes, unknown engine or
    dataflow, operands beyond an engine contract).  Not retryable: the same
    request fails on every backend.  Subclasses ``ValueError`` so callers
    catching ``ValueError`` keep working."""

    kind = "contract-violation"


class ProfileDegradationWarning(RuntimeWarning):
    """A profiling request degraded to a slower-but-exact backend (the numpy
    oracle), typed so callers can filter it from generic runtime noise."""


class CacheThrashWarning(RuntimeWarning):
    """A single batch stored more profiles than the in-memory cache can
    hold, so later jobs evict entries earlier jobs of the same workload
    still need."""
