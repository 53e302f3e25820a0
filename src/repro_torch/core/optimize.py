"""Beyond-paper design-space extensions of the floorplan optimization.

1. Robust multi-workload design points. The paper fixes ONE aspect ratio from
   average activities and notes: "for a real design, one needs to take into
   account the switching profiles of many applications". This module
   implements that: 'average' (the paper's method, transition-weighted),
   'weighted' (explicit workload mix), and 'minimax-regret' (minimize the
   worst-case power excess vs each workload's private optimum).

2. Output-stationary (OS) dataflow analysis. Under OS the partial sums never
   move — both streamed operands are input-width. The wirelength asymmetry
   (B_v > B_h) vanishes, and the remaining aspect lever is the measured
   activity ratio of the two operand streams: ``profile_gemm(...,
   dataflow="OS")`` measures a_h from the A rows and a_v from the W columns
   (both along the K axis), so a WS-vs-OS comparison runs on measured
   numbers for both dataflows.
   The paper's asymmetry is a *property of the weight-stationary dataflow*,
   not of systolic arrays per se.

3. Bus-invert coding (paper's ref [19]) as an activity transformer: with an
   extra invert line, a b-bit bus toggles min(d, b+1-d) bits for Hamming
   distance d. For i.i.d. per-bit toggle probability a, the expected coded
   activity is computable in closed form from the binomial pmf. Applying BI
   to the vertical bus lowers a_v (and widens B_v by 1), shifting Eq. 6 —
   the two techniques compose, and this module quantifies the joint win.

Array-first layout: the ``*_arr`` kernels (``regret_arr``,
``max_regret_arr``, ``minimax_aspect_arr``, ``bus_invert_activity_arr``)
broadcast over numpy arrays or float64 torch tensors of
geometry/activity/aspect values; the scalar API wraps their float64 numpy
path (see ``repro_torch.core.floorplan``).
"""

from __future__ import annotations

import dataclasses
from typing import Literal, Sequence

import numpy as np

from repro_torch.core.floorplan import (
    ASPECT_MAX,
    ASPECT_MIN,
    BusActivity,
    SystolicArrayGeometry,
    _xp,
    bus_power_arr,
    golden_section_minimize_arr,
    optimal_aspect_power_arr,
)
from repro_torch.core.switching import ActivityProfile, combine_profiles

__all__ = [
    "robust_design_point",
    "max_regret",
    "os_dataflow_geometry",
    "bus_invert_activity",
    "bus_invert_geometry",
    # vectorized kernels
    "regret_arr",
    "max_regret_arr",
    "minimax_aspect_arr",
    "bus_invert_activity_arr",
]

# Widest bus the toggle model supports (``switching._to_bus_repr`` contract);
# bounds the static binomial-support axis of the vectorized BI kernel.
_MAX_BUS_BITS = 64


# ---------------------------------------------------------------------------
# 1. Robust multi-workload design points
# ---------------------------------------------------------------------------


def _power_shape(b_h, b_v, a_h, a_v, aspect, xp):
    """Bus power up to the positive geometry prefactor: x sqrt(r) + y/sqrt(r).

    The prefactor (R C sqrt(A) c_wire V^2 f / 2) is aspect-independent, so
    ratios of this shape function equal ratios of ``bus_power_arr``.
    """
    s = xp.sqrt(aspect)
    return (b_h * a_h) * s + (b_v * a_v) / s


def regret_arr(b_h, b_v, a_h, a_v, aspect, lo=ASPECT_MIN, hi=ASPECT_MAX, xp=None):
    """P(aspect) / P(own envelope-clamped optimum) - 1, elementwise.

    Zero-activity elements (no dynamic power at any aspect) report zero
    regret.
    """
    xp = xp or _xp(b_h, b_v, a_h, a_v, aspect)
    own = optimal_aspect_power_arr(b_h, b_v, a_h, a_v, lo=lo, hi=hi, xp=xp)
    p = _power_shape(b_h, b_v, a_h, a_v, aspect, xp)
    p_own = _power_shape(b_h, b_v, a_h, a_v, own, xp)
    return xp.where(p_own > 0, p / xp.where(p_own > 0, p_own, 1.0) - 1.0, 0.0)


def max_regret_arr(
    b_h, b_v, a_h, a_v, aspect, lo=ASPECT_MIN, hi=ASPECT_MAX, axis=0, xp=None
):
    """Worst-case regret across the workload axis (default: axis 0)."""
    xp = xp or _xp(b_h, b_v, a_h, a_v, aspect)
    return xp.max(regret_arr(b_h, b_v, a_h, a_v, aspect, lo=lo, hi=hi, xp=xp), axis=axis)


def minimax_aspect_arr(
    b_h, b_v, a_h, a_v, lo=ASPECT_MIN, hi=ASPECT_MAX, iters: int = 64, xp=None
):
    """Batched minimax-regret aspect: per design point, the aspect minimizing
    the worst-case regret over the leading workload axis of ``a_h``/``a_v``.

    ``a_h``/``a_v`` have shape (W, ...); the result drops the workload axis.
    Golden-section search over log-aspect (the max of unimodal-in-log
    objectives with a shared minimum basin; cross-checked against dense grids
    in the tests).
    """
    xp = xp or _xp(b_h, b_v, a_h, a_v)
    log_lo = xp.log(xp.asarray(lo) + 0.0 * xp.max(a_h, axis=0))
    log_hi = xp.log(xp.asarray(hi) + 0.0 * xp.max(a_h, axis=0))

    def objective(log_a):
        return max_regret_arr(
            b_h, b_v, a_h, a_v, xp.exp(log_a)[None, ...], lo=lo, hi=hi, axis=0, xp=xp
        )

    return xp.exp(golden_section_minimize_arr(objective, log_lo, log_hi, iters=iters, xp=xp))


def max_regret(
    geom: SystolicArrayGeometry, acts: Sequence[BusActivity], aspect: float
) -> float:
    a_h = np.asarray([a.a_h for a in acts])
    a_v = np.asarray([a.a_v for a in acts])
    return float(max_regret_arr(geom.b_h, geom.b_v, a_h, a_v, aspect, xp=np))


def robust_design_point(
    geom: SystolicArrayGeometry,
    profiles: Sequence[ActivityProfile],
    strategy: Literal["average", "weighted", "minimax"] = "average",
    weights: Sequence[float] | None = None,
) -> float:
    """One aspect ratio serving many workloads.

    'average'  — Eq. 6 at the transition-weighted mean activities (paper).
    'weighted' — minimize the weighted mean bus power (explicit app mix).
    'minimax'  — minimize the worst-case regret over workloads.

    All strategies respect the practical aspect envelope
    ``[ASPECT_MIN, ASPECT_MAX]``.
    """
    if not profiles:
        raise ValueError("no workload profiles")
    a_h = np.asarray([p.a_h for p in profiles])
    a_v = np.asarray([p.a_v for p in profiles])
    if strategy == "average":
        from repro_torch.core.floorplan import optimal_aspect_power

        return optimal_aspect_power(geom, combine_profiles(profiles).as_bus_activity())
    if strategy == "weighted":
        w = np.asarray(weights if weights is not None else np.ones(len(profiles)), float)
        if w.shape != (len(profiles),):
            raise ValueError("weights/profiles length mismatch")

        def objective(log_a):
            p = bus_power_arr(
                geom.rows,
                geom.cols,
                geom.b_h,
                geom.b_v,
                geom.pe_area_um2,
                a_h,
                a_v,
                np.exp(log_a),
                xp=np,
            )
            return np.sum(w * p, axis=0)

        log_opt = golden_section_minimize_arr(
            objective, np.log(ASPECT_MIN), np.log(ASPECT_MAX), iters=80, xp=np
        )
        return float(np.exp(log_opt))
    if strategy == "minimax":
        return float(
            minimax_aspect_arr(geom.b_h, geom.b_v, a_h, a_v, iters=80, xp=np)
        )
    raise ValueError(f"unknown strategy {strategy!r}")


# ---------------------------------------------------------------------------
# 2. Output-stationary dataflow
# ---------------------------------------------------------------------------


def os_dataflow_geometry(
    input_bits: int, rows: int, cols: int, pe_area_um2: float = 1200.0
) -> SystolicArrayGeometry:
    """Bus geometry of an OUTPUT-stationary array of the same size.

    Under OS, A streams West->East and W streams North->South, both at the
    input width; the (wide) accumulators never cross PE boundaries (results
    drain once at the end, amortized over the whole K-reduction, which the
    steady-state bus model neglects exactly as the paper neglects weight
    preloading for WS). Hence B_h == B_v == input_bits.  Pair with
    activities measured by ``repro_torch.core.switching.profile_gemm(...,
    dataflow="OS")`` — a_v is the W-column stream activity, not a copy of
    a_h (that approximation is retired).
    """
    return SystolicArrayGeometry(
        rows=rows, cols=cols, b_h=input_bits, b_v=input_bits, pe_area_um2=pe_area_um2
    )


# ---------------------------------------------------------------------------
# 3. Bus-invert coding
# ---------------------------------------------------------------------------


def bus_invert_activity_arr(a, bits, xp=None):
    """Vectorized expected per-bit activity under bus-invert coding.

    Broadcasts over ``a`` (per-bit toggle probabilities in [0, 1]) and
    ``bits`` (data bus widths, <= 64).  The binomial pmf of the Hamming
    distance d ~ Binomial(b, a) is evaluated in LOG space —
    ``logC(b, d) + d log a + (b - d) log(1 - a)`` with the log-binomial
    built by a cumulative-sum recurrence — so activities arbitrarily close
    to 0 or 1 stay finite (the naive pmf recurrence seeds with
    ``(1-a)**b``, which underflows to exactly 0 for a near 1 and poisons
    every term).  The endpoints are exact: a=0 -> 0 coded activity,
    a=1 -> 1/(b+1) (the invert line toggles every cycle, the data lines
    never).
    """
    xp = xp or _xp(a, bits)
    a = xp.asarray(a) + 0.0
    b = xp.asarray(bits) + 0.0
    a, b = xp.broadcast_arrays(a, b)
    eps = xp.finfo(b.dtype).tiny
    a_in = xp.clip(a, eps, 1.0 - xp.finfo(b.dtype).eps)
    log_a = xp.log(a_in)
    log_1ma = xp.log1p(-a_in)

    # Stream the binomial support d = 1.._MAX_BUS_BITS (the widest bus the
    # toggle model takes), carrying the log-binomial recurrence
    # log C(b, d) = log C(b, d-1) + log(b - d + 1) - log(d) — entries beyond
    # each element's own b drop to log-probability -inf.  Streaming keeps the
    # working set at O(broadcast shape) instead of O(shape x 65), so million-
    # point design grids stay cheap.  The d = 0 term has cost min(0, b+1) = 0
    # and never contributes.
    def step(d, log_binom, acc):
        valid = d <= b
        log_binom = xp.where(
            valid, log_binom + xp.log(xp.where(valid, b - d + 1.0, 1.0)) - xp.log(d), -xp.inf
        )
        # BI transmits inverted data when d > (b+1)/2: the coded (b+1)-wire
        # bus toggles min(d, b+1-d) wires.  pmf is exactly 0 beyond d = b,
        # so the clamped cost there contributes nothing.
        pmf = xp.exp(log_binom + d * log_a + (b - d) * log_1ma)
        cost = xp.maximum(xp.minimum(d + 0.0 * b, b + 1.0 - d), 0.0)
        return log_binom, acc + pmf * cost

    log_binom = xp.zeros_like(b)
    acc = xp.zeros_like(b)
    for d in range(1, _MAX_BUS_BITS + 1):
        log_binom, acc = step(float(d), log_binom, acc)
    coded = acc / (b + 1.0)
    return xp.where(a <= 0.0, 0.0, xp.where(a >= 1.0, 1.0 / (b + 1.0), coded))


def bus_invert_activity(a: float, bits: int) -> float:
    """Expected per-bit activity of a b-bit bus under bus-invert coding.

    Model: bit flips are i.i.d. Bernoulli(a) per transition (d ~ Binomial).
    BI transmits inverted data when d > (b+1)/2, so the coded bus (b data
    lines + 1 invert line) toggles min(d, b+1-d) of its b+1 wires. Returns
    expected toggles / (b+1) wires — directly comparable to the uncoded a.
    Evaluated stably in log space (``bus_invert_activity_arr``); the result
    always satisfies ``coded <= a`` and the endpoints are exact.
    """
    if not 0.0 <= a <= 1.0:
        raise ValueError("activity must be in [0,1]")
    if not 1 <= bits <= _MAX_BUS_BITS:
        raise ValueError(f"bits must be in [1, {_MAX_BUS_BITS}]")
    return float(bus_invert_activity_arr(a, bits, xp=np))


def bus_invert_geometry(
    geom: SystolicArrayGeometry, act: BusActivity, code_vertical: bool = True
) -> tuple[SystolicArrayGeometry, BusActivity]:
    """Apply BI coding to the vertical (partial-sum) bus: B_v -> B_v + 1 wire,
    a_v -> coded activity. Returns the transformed (geometry, activities) to
    feed back into the aspect-ratio optimization — the techniques compose."""
    if not code_vertical:
        return geom, act
    a_v_coded = bus_invert_activity(act.a_v, geom.b_v)
    geom2 = dataclasses.replace(geom, b_v=geom.b_v + 1)
    return geom2, BusActivity(a_h=act.a_h, a_v=a_v_coded)
