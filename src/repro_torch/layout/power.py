"""Per-lane x per-segment switched-capacitance roll-up + batched evaluator.

Power model
-----------
Each wire segment of length L carrying an ``act_bits`` expected number of
switching wires per cycle dissipates

    P_seg = 0.5 * c_wire * L * rep(L) * act_bits * Vdd^2 * f

``rep(L) = 1 + repeater_overhead * max(0, L / repeater_spacing - 1)`` is a
simple repeater-aware length scaling: hops shorter than the repeater
spacing (every hop of every family at realistic PE areas) are plain wire,
longer runs (serpentine turnarounds, inter-pod trunks) pay the inserted
repeaters' input capacitance pro-rata.  The clock spine is exempt — clock
trees are explicitly buffered and their buffer power already lives in the
calibrated non-bus fraction of ``repro_torch.core.energy``.

``act_bits`` is where measured per-bit-lane switching enters: a segment
carrying lanes [lane0, lane0+width) of a profiled bus switches
``sum(lane_activity[lane0 : lane0+width])`` wires per transition.  With
only aggregate activities the roll-up falls back to ``a * width`` — the
MEAN-LANE approximation, exact whenever every segment carries the full bus
(the closed-form ``bus_switched_capacitance_arr`` is precisely this case)
and an approximation the moment widths vary per segment (WS multi-pod
interior buses carry only the low pod-accumulator lanes).  Fidelity caveat: the lane distribution is measured
on the FULL R-deep partial-sum stream; a pod-local bus physically carries
the (R/k)-deep sub-accumulation, whose low lanes toggle similarly but
whose boundary resets the measured stream does not model — the per-lane
roll-up is a better estimate than mean-lane for truncated buses, not
cycle-accurate ground truth.

Closed-form equivalence contract
--------------------------------
With the default config (no envelope limit, duty-cycled overhead nets off)
the uniform family's data-net power equals ``floorplan.bus_power_arr``
exactly and its argmin aspect the envelope-clamped Eq. 6 optimum — the
closed form is a verified special case of the segment model (tested).

Batched evaluation
------------------
``evaluate_layout_space`` broadcasts every registered family's fixed-schema
segment classes over a ``DesignGrid``, then runs ONE float64 program per
call, on the engine's device (``engine="cuda"``, the default, or
``"torch"``) or in numpy (``"numpy"``): per-(workload, layout, point) golden-section optimal aspects inside
the intersection of the PE-aspect envelope and the die-envelope constraint
(``max_envelope_aspect`` — the physical reason folded/podded families beat
the uniform rectangle: they realize extreme PE aspects inside a bounded
die), workload-weighted robust aspects, data-net powers, overhead powers
and wirelengths.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Sequence

import numpy as np

from repro_torch.core.design_space import (
    DesignGrid,
    _engine_device,
    _norm_activities,
    _run_core,
)
from repro_torch.core.floorplan import _xp
from repro_torch.layout.coeffs import (
    DATA_IS_H,
    DEVICE_FIELDS,
    OVER_IS_CLK,
    OVER_IS_DRAIN,
    OVER_IS_PRELOAD,
    V_CROSS_DATA_IDX,
    V_HOP_DATA_IDX,
    lower_coding_multipliers,
    lower_layout_coeffs,
)
from repro_torch.layout.segments import DATA_NETS, SegmentList, enumerate_segments

__all__ = [
    "LayoutPowerConfig",
    "LayoutSpaceEval",
    "ObjectiveSpec",
    "rollup_segments",
    "segment_bus_power",
    "segment_wirelength",
    "evaluate_layout_space",
]


@dataclasses.dataclass(frozen=True)
class LayoutPowerConfig:
    """Knobs of the segment power model (defaults = closed-form-equivalent).

    ``preload_duty``/``drain_duty`` default to 0: the steady-state bus model
    neglects weight preload and output drain exactly as the paper does
    (turn them on to price those chains as duty-cycled overhead nets).
    ``max_envelope_aspect`` bounds the ARRAY bounding box W/H (a die-fitting
    constraint, distinct from the per-PE envelope); ``None`` = unbounded.
    """

    vdd: float = 0.9
    freq_hz: float = 1.0e9
    wire_cap_f_per_um: float = 0.20e-15
    repeater_spacing_um: float = 200.0
    repeater_overhead: float = 0.3
    max_envelope_aspect: float | None = None
    preload_duty: float = 0.0
    preload_activity: float = 0.5
    drain_duty: float = 0.0
    drain_activity: float = 0.5
    clock_toggles_per_cycle: float = 2.0


def _repeater_scale(length, spacing, overhead, xp=np):
    return 1.0 + overhead * xp.maximum(length / spacing - 1.0, 0.0)


def _lane_sum(lanes: np.ndarray | None, lane0, width, agg, _unused=None):
    """Expected switching wires per transition for lanes [lane0, lane0+width).

    ``lanes`` is a per-lane activity array with the lane axis last — (n,)
    for one profile, (W, P, n) for a grid — or None for the aggregate
    mean-lane path (``agg * width``).  ``lane0``/``width`` broadcast over
    the non-lane axes.
    """
    width = np.asarray(width)
    if lanes is None:
        return np.asarray(agg) * width
    lanes = np.asarray(lanes, float)
    cs = np.concatenate(
        [np.zeros(lanes.shape[:-1] + (1,)), np.cumsum(lanes, axis=-1)], axis=-1
    )
    n = lanes.shape[-1]
    lo = np.clip(np.asarray(lane0, np.int64), 0, n)
    hi = np.clip(lo + np.asarray(width, np.int64), 0, n)
    if lanes.ndim == 1:
        return cs[hi] - cs[lo]
    tgt = cs.shape[:-1]
    lo_b = np.broadcast_to(lo, tgt)[..., None]
    hi_b = np.broadcast_to(hi, tgt)[..., None]
    return (
        np.take_along_axis(cs, hi_b, axis=-1) - np.take_along_axis(cs, lo_b, axis=-1)
    )[..., 0]


def _segment_act_bits(
    net: np.ndarray,
    width: np.ndarray,
    lane0: np.ndarray,
    a_h: float,
    a_v: float,
    cfg: LayoutPowerConfig,
    h_lanes: np.ndarray | None,
    v_lanes: np.ndarray | None,
) -> np.ndarray:
    act = np.zeros(width.shape, float)
    for m, lanes, agg in (("h", h_lanes, a_h), ("v", v_lanes, a_v)):
        sel = net == m
        if sel.any():
            act[sel] = _lane_sum(lanes, lane0[sel], width[sel], agg, None)
    act[net == "preload"] = (
        cfg.preload_duty * cfg.preload_activity * width[net == "preload"]
    )
    act[net == "drain"] = cfg.drain_duty * cfg.drain_activity * width[net == "drain"]
    act[net == "clk"] = cfg.clock_toggles_per_cycle * width[net == "clk"]
    return act


def rollup_segments(
    segs: SegmentList,
    a_h: float,
    a_v: float,
    *,
    h_lanes: np.ndarray | None = None,
    v_lanes: np.ndarray | None = None,
    cfg: LayoutPowerConfig = LayoutPowerConfig(),
) -> dict[str, float]:
    """Explicit per-segment power roll-up [W], by net.

    ``h_lanes``/``v_lanes`` are optional per-lane activity arrays (e.g.
    ``ActivityProfile.a_h_lanes``); without them each net uses its aggregate
    activity (the mean-lane approximation).  Returns per-net watts plus
    ``bus_w`` (the data nets — comparable to ``floorplan.bus_power``),
    ``overhead_w`` and ``total_w``.
    """
    act = _segment_act_bits(
        segs.net, segs.width.astype(float), segs.lane0, a_h, a_v, cfg, h_lanes, v_lanes
    )
    rep = _repeater_scale(
        segs.length, cfg.repeater_spacing_um, cfg.repeater_overhead, np
    )
    rep = np.where(segs.net == "clk", 1.0, rep)
    p_seg = (
        0.5 * cfg.wire_cap_f_per_um * segs.length * rep * act * cfg.vdd**2 * cfg.freq_hz
    )
    out = {net: float(p_seg[segs.net == net].sum()) for net in np.unique(segs.net)}
    bus = sum(out.get(n, 0.0) for n in DATA_NETS)
    overhead = sum(v for k, v in out.items() if k not in DATA_NETS)
    out["bus_w"] = bus
    out["overhead_w"] = overhead
    out["total_w"] = bus + overhead
    return out


def segment_bus_power(
    layout,
    geom,
    act,
    aspect: float,
    *,
    dataflow: str = "WS",
    h_lanes: np.ndarray | None = None,
    v_lanes: np.ndarray | None = None,
    cfg: LayoutPowerConfig = LayoutPowerConfig(),
) -> float:
    """Data-net (h+v) power [W] of ``layout`` at one aspect — the explicit
    segment model's answer to ``floorplan.bus_power`` (equal on uniform)."""
    segs = enumerate_segments(
        layout,
        geom.rows,
        geom.cols,
        geom.b_h,
        geom.b_v,
        geom.pe_area_um2,
        aspect,
        dataflow=dataflow,
        nets=DATA_NETS,
    )
    return rollup_segments(
        segs, act.a_h, act.a_v, h_lanes=h_lanes, v_lanes=v_lanes, cfg=cfg
    )["bus_w"]


def segment_wirelength(layout, geom, aspect: float, *, dataflow: str = "WS") -> float:
    """Total data-net wire length [um] — Eq. 3's unit (equal on uniform)."""
    segs = enumerate_segments(
        layout,
        geom.rows,
        geom.cols,
        geom.b_h,
        geom.b_v,
        geom.pe_area_um2,
        aspect,
        dataflow=dataflow,
        nets=DATA_NETS,
    )
    return segs.wire_length()


# ---------------------------------------------------------------------------
# Batched (design point x layout family) evaluator
# ---------------------------------------------------------------------------
#
# The coefficient protocol: every family's data-net power at PE aspect r
# collapses, per (workload, layout, point) cell, to a closed form in
# t = sqrt(r)
#
#     f(t) = A*t + B/t + C + sum_r c_r * len_r(t) * relu(len_r(t) - s)
#
# where (A, B, C) fold every data class's count * activity * length
# coefficients (alpha = len_w*sqrt(area) multiplies t, beta = len_h*
# sqrt(area) multiplies 1/t), s is the repeater spacing, c_r = (overhead/s)
# * count_r * act_r, and the sum runs over the FEW classes whose segments
# can outgrow s inside the aspect window (``coeffs.rep_idx`` — an exact
# prune, since len(t) is convex with its window maximum at an endpoint).
#
# f is globally convex in t: A*t + B/t + C is (A, B >= 0), and each
# penalty term is x*relu(x - s) — convex nondecreasing — composed with the
# convex positive len_r(t).  So the argmin needs no golden-section scan:
# derivative-sign bisection (carrying just the bracket) plus a few clipped
# Newton polish steps converges faster AND tighter, and the whole search
# touches three scalars per cell per iteration instead of streaming the
# full (layout, class, point) tensors.  That is the ~50x: the per-point
# segment re-enumeration is gone (lowering is memoized + device-resident,
# ``repro_torch.layout.coeffs``) and the inner loop is arithmetic on collapsed
# coefficients.
#
# The search runs over W+1 stacked slots: per-workload optima in slots
# [0, W) and the workload-weighted robust objective in slot W (weighted
# sums of (A, B, C, c_r) — the objective is linear in activity).  Every
# engine runs the SAME float64 algorithm.


def _search_iters(gss_iters: int) -> tuple[int, int]:
    """Map the legacy ``gss_iters`` knob onto (bisection, newton) counts.

    Kept as the API/sweep-spec knob for compatibility: 64 "iterations"
    resolve to a 2^-16 bracket plus 3 Newton steps — tighter than GSS-64
    (Newton is quadratic on the convex objective) at a quarter of the
    derivative evaluations.
    """
    return max(8, min(int(gss_iters) // 4, 24)), 3


def _lane_gather(xp, lanes, lane0_d, width_d):
    """Per-class lane-sum: sum(lanes[lane0 : lane0+width]) via one cumsum.

    ``lanes`` (W, P, n); ``lane0_d``/``width_d`` (L, Cd, P).  Returns
    (W, L, Cd, P).
    """
    n = lanes.shape[-1]
    cs = xp.cumsum(lanes, axis=-1)
    cs = xp.concatenate([xp.zeros(lanes.shape[:-1] + (1,), cs.dtype), cs], axis=-1)
    lo = xp.clip(lane0_d, 0, n)
    hi = xp.clip(lo + xp.asarray(width_d, dtype=lane0_d.dtype), 0, n)
    cs_e = cs[:, None, None, :, :]  # (W, 1, 1, P, n+1)
    take = lambda idx: xp.take_along_axis(cs_e, idx[None, ..., None], axis=-1)[..., 0]
    return take(hi) - take(lo)


def _fold_data_activities(xp, a_h, a_v, h_lanes, v_lanes, width_d, lane0_d):
    """Switching wires per transition for every data class: (W, L, Cd, P).

    Aggregate path: ``a * width`` (the mean-lane approximation); per-lane
    path: the cumsum-gather over the class's lane range — both inside the
    evaluator program, so lane profiles ride the same program.
    """
    is_h = xp.asarray(DATA_IS_H.reshape(1, 1, -1, 1))
    if h_lanes is None:
        act_h = a_h[:, None, None, :] * width_d[None]
    else:
        act_h = _lane_gather(xp, h_lanes, lane0_d, width_d)
    if v_lanes is None:
        act_v = a_v[:, None, None, :] * width_d[None]
    else:
        act_v = _lane_gather(xp, v_lanes, lane0_d, width_d)
    return is_h * act_h + (1.0 - is_h) * act_v


def _coeff_eval_core(
    count_d,  # (L, Cd, P) data-class counts
    alpha_d,  # (L, Cd, P) len(t) = alpha*t + beta/t + gamma
    beta_d,
    gamma_d,
    ca,  # (L, Cd, P) count * alpha   (linear-collapse products)
    cb,
    cg,
    cwidth_d,  # (L, Cd, P) count * width (wirelength roll-up)
    width_d,  # (L, Cd, P)
    lane0_d,  # (L, Cd, P) int
    count_o,  # (L, Co, P) overhead-class tensors
    width_o,
    alpha_o,
    beta_o,
    gamma_o,
    t_lo,  # (L, P) sqrt-aspect window
    t_hi,
    a_h,  # (W, P) aggregate activities
    a_v,
    h_lanes,  # (W, P, n) or None
    v_lanes,
    weights,  # (W,)
    vdd,
    freq_hz,
    wire_cap,
    spacing,
    overhead,
    preload_coef,  # preload_duty * preload_activity
    drain_coef,
    clk_coef,
    # Coding axis: (W, Cd, P) per-class activity multipliers, or None for
    # the identity (coding-free grids skip the multiply entirely).
    act_mult=None,
    # J/op objective inputs (all None => wire-power-only evaluation):
    util=None,  # (W, L, P) useful-MAC fraction from the partition lowering
    spill_wpm=None,  # (W, L, P) off-array spill words per MAC
    trunk_wpm=None,  # (W, L, P) reduction-trunk gutter crossings per MAC
    rows_arr=None,  # (P,) array rows (spill words traverse 2*rows hops)
    rc_arr=None,  # (P,) rows * cols
    static_w=None,  # (W, P) calibrated fixed-interconnect + compute watts
    *,
    rep_idx: tuple,
    nb: int,
    nn: int,
):
    xp = _xp(ca, a_h)
    pref = 0.5 * wire_cap * vdd * vdd * freq_hz

    act = _fold_data_activities(xp, a_h, a_v, h_lanes, v_lanes, width_d, lane0_d)
    if act_mult is not None:
        act = act * act_mult[:, None, :, :]
    wcol = weights[:, None, None]

    def stack(arr):  # (W, L, P) -> (W+1, L, P): per-workload slots + weighted
        return xp.concatenate([arr, xp.sum(wcol * arr, axis=0, keepdims=True)], 0)

    As = stack(xp.sum(act * ca[None], axis=2))
    Bs = stack(xp.sum(act * cb[None], axis=2))
    Cs = stack(xp.sum(act * cg[None], axis=2))
    kap = overhead / spacing
    reps = [
        (
            alpha_d[:, j],
            beta_d[:, j],
            gamma_d[:, j],
            stack(kap * count_d[:, j][None] * act[:, :, j]),
        )
        for j in rep_idx
    ]

    def grad(t):
        v = 1.0 / t
        v2 = v * v
        v3 = v2 * v
        g = As - Bs * v2
        h = 2.0 * Bs * v3
        for al, be, ga, crs in reps:
            ln = al * t + be * v + ga
            d = al - be * v2
            on = ln > spacing
            g = g + xp.where(on, crs * (2.0 * ln - spacing) * d, 0.0)
            h = h + xp.where(
                on, crs * (2.0 * d * d + (2.0 * ln - spacing) * 2.0 * be * v3), 0.0
            )
        return g, h

    # Derivative-sign bisection: f is convex, so sign(f') brackets the argmin.
    a = t_lo[None] + 0.0 * As
    b = t_hi[None] + 0.0 * As
    for _ in range(nb):
        m = 0.5 * (a + b)
        g, _ = grad(m)
        pos = g > 0.0
        a = xp.where(pos, a, m)
        b = xp.where(pos, m, b)
    x = 0.5 * (a + b)
    # Clipped Newton polish inside the (still-shrinking) bracket.
    for _ in range(nn):
        g, h = grad(x)
        pos = g > 0.0
        a = xp.where(pos, a, x)
        b = xp.where(pos, x, b)
        xn = x - g / xp.maximum(h, 1e-30)
        xn = xp.clip(xn, a, b)
        x = xp.where(xp.isfinite(xn), xn, 0.5 * (a + b))

    f = As * x + Bs / x + Cs
    for al, be, ga, crs in reps:
        ln = al * x + be / x + ga
        f = f + crs * ln * xp.maximum(ln - spacing, 0.0)
    aspect = x * x

    # Overhead nets + wirelength: one full-schema evaluation at the robust
    # aspect (slot W) — outside the search loop, so no collapse needed.
    tr = x[-1][:, None, :]  # (L, 1, P)
    ln_o = alpha_o * tr + beta_o / tr + gamma_o
    exempt = xp.asarray(OVER_IS_CLK.reshape(1, -1, 1))  # clk trees are explicitly buffered
    rep_o = 1.0 + (1.0 - exempt) * overhead * xp.maximum(ln_o / spacing - 1.0, 0.0)
    act_o = width_o * (
        xp.asarray(OVER_IS_PRELOAD.reshape(1, -1, 1)) * preload_coef
        + xp.asarray(OVER_IS_DRAIN.reshape(1, -1, 1)) * drain_coef
        + exempt * clk_coef
    )
    overhead_w = pref * xp.sum(count_o * ln_o * rep_o * act_o, axis=1)
    ln_d = alpha_d * tr + beta_d / tr + gamma_d
    wirelength = xp.sum(cwidth_d * ln_d, axis=1)

    out = {
        "aspect_opt": aspect[:-1],
        "bus_power_opt": pref * f[:-1],
        "aspect_robust": aspect[-1],
        "bus_power_robust": pref * f[-1],
        "overhead_w": overhead_w,
        "wirelength_um": wirelength,
    }

    if util is not None:
        # Fused J/op objective — everything priced at the ROBUST aspect
        # (the chip is floorplanned once, then serves the whole fleet).
        # Per-workload data-net power re-evaluated at t_robust:
        tr2 = x[-1][None]  # (1, L, P)
        f_r = As * tr2 + Bs / tr2 + Cs
        for al, be, ga, crs in reps:
            ln = al * tr2 + be / tr2 + ga
            f_r = f_r + crs * ln * xp.maximum(ln - spacing, 0.0)
        p_bus_r = pref * f_r[:-1]  # (W, L, P)

        # Word-traffic energies through the same switched-cap roll-up:
        # a spilled partial sum drains + reloads over 2*rows vertical hops,
        # a K-split partial crosses one gutter trunk.  ``act`` rows carry
        # switching-wires-per-word (coding multipliers already applied).
        ln_vh = ln_d[:, V_HOP_DATA_IDX]  # (L, P) hop length at t_robust
        ln_vx = ln_d[:, V_CROSS_DATA_IDX]
        rep_vh = 1.0 + overhead * xp.maximum(ln_vh / spacing - 1.0, 0.0)
        rep_vx = 1.0 + overhead * xp.maximum(ln_vx / spacing - 1.0, 0.0)
        e_len = pref / freq_hz  # J per (um * switching wire * transfer)
        e_spill = 2.0 * rows_arr * e_len * ln_vh * rep_vh * act[:, :, V_HOP_DATA_IDX, :]
        e_trunk = e_len * ln_vx * rep_vx * act[:, :, V_CROSS_DATA_IDX, :]

        # J/op = power x cycles / useful MACs; utilization folds rounds and
        # ragged-tile idling.  util == 0 (zero-MAC GEMM, infeasible mapping)
        # prices inf per-workload and drops out of the MAC-weighted fleet
        # slot (its weight is zero under MAC weighting).
        denom = freq_hz * rc_arr * util  # (W, L, P)
        p_tot = p_bus_r + overhead_w[None] + static_w[:, None, :]
        jpm = (
            p_tot / xp.maximum(denom, 1e-30)
            + spill_wpm * e_spill
            + trunk_wpm * e_trunk
        )
        jpm = xp.where(util > 0.0, jpm, xp.inf)
        live = (wcol > 0.0) & (util > 0.0)
        out["j_per_mac"] = jpm
        out["j_per_mac_robust"] = xp.sum(
            wcol * xp.where(live, jpm, 0.0), axis=0
        )

    return out


@dataclasses.dataclass(frozen=True, eq=False)
class ObjectiveSpec:
    """Inputs that turn the wire-power program into a J/op objective.

    ``partition`` is the memoized ``lower_partition_coeffs`` entry — per
    (GEMM workload, layout, point) utilization and spill/trunk words per
    MAC.  ``static_w`` is the (W, P) calibrated non-bus power (fixed
    interconnect + first-order PE/register compute term).  Passing one to
    ``evaluate_layout_space`` makes the evaluator program emit
    ``j_per_mac``/``j_per_mac_robust`` alongside the wire-power outputs.
    """

    partition: object  # LoweredTensors from lower_partition_coeffs
    static_w: np.ndarray  # (W, P)


@dataclasses.dataclass(frozen=True)
class LayoutSpaceEval:
    """(layout L, point P) evaluation of a design grid across families.

    Workload-axis outputs are (W, L, P); per-(layout, point) outputs (L, P).
    Infeasible (layout, point) pairs — family/grid divisibility or an empty
    aspect window under ``max_envelope_aspect`` — carry ``inf`` powers.
    The J/op fields are populated only when an ``ObjectiveSpec`` was priced
    (``objective=``), else None.
    """

    grid: DesignGrid
    layouts: tuple[str, ...]
    feasible: np.ndarray  # (L, P) bool
    aspect_lo: np.ndarray  # (L, P) effective lower aspect bound
    aspect_hi: np.ndarray  # (L, P)
    aspect_opt: np.ndarray  # (W, L, P)
    bus_power_opt: np.ndarray  # (W, L, P) data-net power at aspect_opt [W]
    aspect_robust: np.ndarray  # (L, P)
    bus_power_robust: np.ndarray  # (L, P) workload-weighted at aspect_robust
    overhead_w: np.ndarray  # (L, P) clk (+duty-cycled preload/drain)
    wirelength_um: np.ndarray  # (L, P) data-net wire length at aspect_robust
    utilization: np.ndarray | None = None  # (W, L, P) useful-MAC fraction
    j_per_mac: np.ndarray | None = None  # (W, L, P) total J per useful MAC
    j_per_mac_robust: np.ndarray | None = None  # (L, P) MAC-weighted fleet J/op
    # MACs per served token of the workload mix (serving co-design: a
    # traffic model's MAC/s over tokens/s) — turns J/op answers into J/token
    macs_per_token: float | None = None
    sweep_report: object | None = None  # SweepReport when run via ``sweep=``

    @property
    def n_points(self) -> int:
        return self.grid.n_points

    @property
    def total_w(self) -> np.ndarray:
        return self.bus_power_robust + self.overhead_w

    @property
    def best_layout(self) -> np.ndarray:
        """(P,) index into ``layouts`` minimizing robust bus + overhead."""
        return np.argmin(self.total_w, axis=0)

    def best_layout_name(self, i: int) -> str:
        return self.layouts[int(self.best_layout[i])]

    @property
    def best_layout_jpo(self) -> np.ndarray:
        """(P,) index into ``layouts`` minimizing fleet J per useful MAC."""
        if self.j_per_mac_robust is None:
            raise ValueError(
                "no J/op objective on this eval; pass objective= (an "
                "ObjectiveSpec) to evaluate_layout_space"
            )
        return np.argmin(self.j_per_mac_robust, axis=0)

    @property
    def j_per_token_robust(self) -> np.ndarray:
        """(L, P) joules per served token: J/op x MACs/token.

        Requires both a priced J/op objective and a ``macs_per_token``
        aggregation slot (a serving traffic mix).
        """
        if self.j_per_mac_robust is None or self.macs_per_token is None:
            raise ValueError(
                "J/token needs a priced J/op objective AND macs_per_token "
                "(the MACs per token of a serving traffic mix)"
            )
        return np.asarray(self.j_per_mac_robust) * float(self.macs_per_token)


def _price(tables, a_h, a_v, h_lanes, v_lanes, w, act_mult, obj_args, *,
           cfg: LayoutPowerConfig, rep_idx: tuple, gss_iters: int, device):
    """One ``_coeff_eval_core`` run on ``device`` (None: numpy) over the
    lowered ``tables`` (``DEVICE_FIELDS``) and the activities; every output
    comes back as a float64 numpy array.  The unchunked evaluator and the
    sweep runner's device rungs share it."""
    nb, nn = _search_iters(gss_iters)
    scalars = (
        cfg.vdd,
        cfg.freq_hz,
        cfg.wire_cap_f_per_um,
        cfg.repeater_spacing_um,
        cfg.repeater_overhead,
        cfg.preload_duty * cfg.preload_activity,
        cfg.drain_duty * cfg.drain_activity,
        cfg.clock_toggles_per_cycle,
    )
    out = _run_core(
        functools.partial(_coeff_eval_core, rep_idx=rep_idx, nb=nb, nn=nn),
        (*(tables[k] for k in DEVICE_FIELDS), a_h, a_v, h_lanes, v_lanes, w, *scalars,
         act_mult, *obj_args),
        device,
    )
    return {k: np.asarray(v, float) for k, v in out.items()}


def _mask_infeasible(out: dict, feasible: np.ndarray, utilization) -> dict:
    """Price infeasible (layout, point) cells ``inf`` and attach the
    objective's utilization, a pure pass-through of the host partition
    table (``None`` without an objective)."""
    bad = ~feasible
    for key in ("bus_power_robust", "overhead_w", "wirelength_um"):
        out[key] = np.where(bad, np.inf, out[key])
    out["bus_power_opt"] = np.where(bad[None], np.inf, out["bus_power_opt"])
    if utilization is not None:
        out["j_per_mac"] = np.where(bad[None], np.inf, out["j_per_mac"])
        out["j_per_mac_robust"] = np.where(bad, np.inf, out["j_per_mac_robust"])
        out["utilization"] = utilization
    return out


def evaluate_layout_space(
    grid: DesignGrid,
    a_h,
    a_v,
    *,
    layouts: Sequence[str] = ("uniform", "serpentine2", "pods2x2"),
    h_lanes: np.ndarray | None = None,
    v_lanes: np.ndarray | None = None,
    weights: Sequence[float] | None = None,
    cfg: LayoutPowerConfig = LayoutPowerConfig(),
    engine: str = "cuda",
    gss_iters: int = 64,
    sweep=None,
    objective: ObjectiveSpec | None = None,
) -> LayoutSpaceEval:
    """Evaluate every (design point, layout family) pair in one program.

    ``a_h``/``a_v`` are (W, P)-broadcastable aggregate activities (measured:
    ``workloads.measured_design_activities``); ``h_lanes``/``v_lanes`` are
    optional (W, P, n_lanes) per-lane activity arrays (measured:
    ``workloads.measured_design_lane_activities``) — with them, variable-
    width segments (multi-pod pod buses) are priced from the true lane
    distribution instead of the mean-lane approximation.

    Bus-invert points are priced through the lowered coding multipliers
    (``repro_torch.layout.coeffs.lower_coding_multipliers``): the schema's
    v-net classes carry the coded/raw activity ratio inside the same
    program.  Lane arrays describe physical uncoded buses, so lanes and a
    coded grid are mutually exclusive.

    ``objective`` (an ``ObjectiveSpec``) additionally fuses the pod-
    partition model into the program — ``j_per_mac``/``j_per_mac_robust``
    outputs.

    ``engine`` is one of ``repro_torch.core.design_space.ENGINES``: float64
    tensors on the current CUDA device (``"cuda"``, the default; the lowered
    tables are copied there once and kept), on the CPU (``"torch"``), or
    numpy (``"numpy"``).

    ``sweep`` (a ``repro_torch.core.sweep.SweepConfig``) routes evaluation
    through the chunked, checkpointed, guard-validated runner (see
    ``evaluate_design_space``); the returned eval carries ``sweep_report``.
    """
    p = grid.n_points
    a_h, a_v = _norm_activities(a_h, a_v, p)
    n_w = a_h.shape[0]
    w = np.asarray(weights if weights is not None else np.ones(n_w), float)
    if w.shape != (n_w,):
        raise ValueError("weights must match the workload axis")
    if w.sum() <= 0:
        raise ValueError("weights must sum to a positive value")
    w = w / w.sum()
    has_bi = bool(np.any(np.asarray(grid.bus_invert)))
    if has_bi and (h_lanes is not None or v_lanes is not None):
        raise ValueError(
            "per-lane activities describe physical (uncoded) buses; drop the "
            "lane arrays or expand the space with bus_invert=(False,)"
        )
    for lanes, name in ((h_lanes, "h_lanes"), (v_lanes, "v_lanes")):
        if lanes is not None and (lanes.ndim != 3 or lanes.shape[:2] != (n_w, p)):
            raise ValueError(f"{name} must be (workloads, points, n_lanes)")

    layout_names = tuple(layouts)
    if objective is not None:
        part_host = objective.partition.host
        if part_host["utilization"].shape != (n_w, len(layout_names), p):
            raise ValueError(
                "objective.partition does not match (workloads, layouts, "
                "points); lower it with the same grid/layouts/gemms"
            )
        static_w = np.asarray(objective.static_w, float)
        if static_w.shape != (n_w, p):
            raise ValueError("objective.static_w must be (workloads, points)")
    device = _engine_device(engine)
    if sweep is not None:
        from repro_torch.core.sweep import run_layout_sweep

        out, report = run_layout_sweep(
            grid, a_h, a_v, w, layouts=layout_names, h_lanes=h_lanes,
            v_lanes=v_lanes, cfg=cfg, gss_iters=gss_iters, engine=engine,
            sweep=sweep, objective=objective,
        )
        return LayoutSpaceEval(
            grid=grid, layouts=layout_names, sweep_report=report, **out
        )
    coeffs = lower_layout_coeffs(
        grid,
        layout_names,
        max_envelope_aspect=cfg.max_envelope_aspect,
        repeater_spacing_um=cfg.repeater_spacing_um,
    )
    coding = lower_coding_multipliers(grid, a_v) if has_bi else None
    # The lowered tables on the engine: the host float64 arrays for numpy,
    # else the entry's copies on the device (made once, kept in the cache).
    tables = coeffs.host if device is None else coeffs.device(device)
    act_mult = None
    if coding is not None:
        act_mult = (coding.host if device is None else coding.device(device))["act_mult"]
    obj_args = (None,) * 6
    utilization = None
    if objective is not None:
        part = part_host if device is None else objective.partition.device(device)
        rows_arr = np.asarray(grid.rows, float)
        obj_args = (
            part["utilization"],
            part["spill_words_per_mac"],
            part["trunk_words_per_mac"],
            rows_arr,
            rows_arr * np.asarray(grid.cols, float),
            static_w,
        )
        utilization = part_host["utilization"]
    lanes = [None if x is None else np.asarray(x, float) for x in (h_lanes, v_lanes)]
    out = _price(
        tables, a_h, a_v, *lanes, w, act_mult, obj_args,
        cfg=cfg, rep_idx=coeffs.rep_idx, gss_iters=gss_iters, device=device,
    )
    feasible = coeffs.host["feasible"]
    out = _mask_infeasible(out, feasible, utilization)
    return LayoutSpaceEval(
        grid=grid,
        layouts=layout_names,
        feasible=feasible,
        aspect_lo=coeffs.host["lo"],
        aspect_hi=coeffs.host["hi"],
        **out,
    )
