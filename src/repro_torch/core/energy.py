"""Calibrated SA power model: reproduces the paper's Fig. 4 / Fig. 5 split.

Decomposition (per Section I of the paper):

  P_total = P_interconnect + P_compute_and_regs
  P_interconnect = P_bus(aspect) + P_fixed_interconnect

``P_bus`` is the aspect-ratio-dependent H/V data-bus power computed from first
principles (``repro_torch.core.floorplan.bus_power``). The two calibration fractions
below fold in what a 28 nm physical flow measures but an analytical model
cannot (clock tree, PE-local nets, cell-internal power); they are FITTED to the
paper's aggregate claims and documented in DESIGN.md §2:

  * NON_BUS_INTERCONNECT_FRACTION: share of interconnect power that does NOT
    scale with PE aspect ratio. At the paper's operating point the optimal
    rectangle cuts bus power by 18.7%; the paper measures a 9.1% cut in total
    interconnect power, hence 1 - 0.091/0.187 ≈ 0.513 of interconnect power is
    aspect-invariant.
  * INTERCONNECT_SHARE_OF_TOTAL: interconnect share of total SA power; the
    paper's 9.1% interconnect cut shows up as a 2.1% total cut, hence
    0.021/0.091 ≈ 0.231.

Everything *relative* across layers/aspects is computed, not fitted.

Array-first layout: ``power_breakdown_arr`` / ``compare_sym_asym_arr`` are
broadcastable kernels over numpy arrays or float64 torch tensors of
geometry/activity/aspect values; the scalar dataclass API wraps their
float64 numpy path (see ``repro_torch.core.floorplan``).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.core.floorplan import (
    BusActivity,
    SystolicArrayGeometry,
    _xp,
    bus_power_arr,
    optimal_aspect_power,
    optimal_aspect_power_arr,
)

__all__ = [
    "EnergyModelConfig",
    "PowerBreakdown",
    "calibration_split_arr",
    "power_breakdown",
    "power_breakdown_arr",
    "compare_sym_asym",
    "compare_sym_asym_arr",
    "average_comparison",
    "SymAsymComparison",
]

NON_BUS_INTERCONNECT_FRACTION = 0.513
INTERCONNECT_SHARE_OF_TOTAL = 0.231


@dataclasses.dataclass(frozen=True)
class EnergyModelConfig:
    vdd: float = 0.9
    freq_hz: float = 1.0e9
    wire_cap_f_per_um: float = 0.20e-15
    non_bus_interconnect_fraction: float = NON_BUS_INTERCONNECT_FRACTION
    interconnect_share_of_total: float = INTERCONNECT_SHARE_OF_TOTAL


@dataclasses.dataclass(frozen=True)
class PowerBreakdown:
    """Absolute power [W] of one SA configuration on one workload."""

    aspect: float
    bus_w: float
    fixed_interconnect_w: float
    compute_w: float

    @property
    def interconnect_w(self) -> float:
        return self.bus_w + self.fixed_interconnect_w

    @property
    def total_w(self) -> float:
        return self.interconnect_w + self.compute_w


def calibration_split_arr(
    bus_ref_sq,
    non_bus_interconnect_fraction=NON_BUS_INTERCONNECT_FRACTION,
    interconnect_share_of_total=INTERCONNECT_SHARE_OF_TOTAL,
):
    """(fixed_interconnect, compute) watts anchored to a square-layout
    reference bus power — the ONE home of the DESIGN.md §2 calibration
    anchoring, shared by the scalar breakdown and the design-space engine."""
    f_nb = non_bus_interconnect_fraction
    interconnect_ref_sq = bus_ref_sq / (1.0 - f_nb)
    fixed = interconnect_ref_sq * f_nb
    total_ref_sq = interconnect_ref_sq / interconnect_share_of_total
    compute = total_ref_sq - interconnect_ref_sq
    return fixed, compute


def power_breakdown_arr(
    rows,
    cols,
    b_h,
    b_v,
    pe_area,
    a_h,
    a_v,
    aspect,
    *,
    vdd=0.9,
    freq_hz=1.0e9,
    wire_cap_f_per_um=0.20e-15,
    non_bus_interconnect_fraction=NON_BUS_INTERCONNECT_FRACTION,
    interconnect_share_of_total=INTERCONNECT_SHARE_OF_TOTAL,
    ref_a_h=None,
    ref_a_v=None,
    xp=None,
) -> dict:
    """Vectorized power breakdown: ``{"bus_w", "fixed_interconnect_w",
    "compute_w"}`` arrays broadcast over every input.

    The fixed (non-bus) interconnect power and the compute power are anchored
    to the *square* layout under the reference activities (default: the
    workload activities themselves) — see ``power_breakdown``.
    """
    xp = xp or _xp(rows, pe_area, a_h, aspect)
    r_h = a_h if ref_a_h is None else ref_a_h
    r_v = a_v if ref_a_v is None else ref_a_v
    bus_ref_sq = bus_power_arr(
        rows, cols, b_h, b_v, pe_area, r_h, r_v, 1.0, vdd, freq_hz, wire_cap_f_per_um, xp=xp
    )
    fixed, compute = calibration_split_arr(
        bus_ref_sq, non_bus_interconnect_fraction, interconnect_share_of_total
    )
    bus = bus_power_arr(
        rows, cols, b_h, b_v, pe_area, a_h, a_v, aspect, vdd, freq_hz, wire_cap_f_per_um, xp=xp
    )
    return {"bus_w": bus, "fixed_interconnect_w": fixed + 0 * bus, "compute_w": compute + 0 * bus}


def power_breakdown(
    geom: SystolicArrayGeometry,
    act: BusActivity,
    aspect: float,
    cfg: EnergyModelConfig = EnergyModelConfig(),
    reference_act: BusActivity | None = None,
) -> PowerBreakdown:
    """Power breakdown at a given aspect ratio.

    The fixed (non-bus) interconnect power and the compute power are anchored
    to the *square* layout under ``reference_act`` (defaults to ``act``): the
    calibration fractions describe the square design's power split, and those
    absolute watts do not change when only the floorplan aspect changes
    (clock tree + cell-internal power are aspect-invariant to first order).
    """
    ref = reference_act if reference_act is not None else act
    parts = power_breakdown_arr(
        geom.rows,
        geom.cols,
        geom.b_h,
        geom.b_v,
        geom.pe_area_um2,
        act.a_h,
        act.a_v,
        aspect,
        vdd=cfg.vdd,
        freq_hz=cfg.freq_hz,
        wire_cap_f_per_um=cfg.wire_cap_f_per_um,
        non_bus_interconnect_fraction=cfg.non_bus_interconnect_fraction,
        interconnect_share_of_total=cfg.interconnect_share_of_total,
        ref_a_h=ref.a_h,
        ref_a_v=ref.a_v,
        xp=np,
    )
    return PowerBreakdown(
        aspect=aspect,
        bus_w=float(parts["bus_w"]),
        fixed_interconnect_w=float(parts["fixed_interconnect_w"]),
        compute_w=float(parts["compute_w"]),
    )


@dataclasses.dataclass(frozen=True)
class SymAsymComparison:
    aspect_opt: float
    sym: PowerBreakdown
    asym: PowerBreakdown

    @property
    def interconnect_saving(self) -> float:
        return 1.0 - self.asym.interconnect_w / self.sym.interconnect_w

    @property
    def total_saving(self) -> float:
        return 1.0 - self.asym.total_w / self.sym.total_w

    @property
    def bus_saving(self) -> float:
        return 1.0 - self.asym.bus_w / self.sym.bus_w


def compare_sym_asym_arr(
    rows,
    cols,
    b_h,
    b_v,
    pe_area,
    a_h,
    a_v,
    *,
    design_a_h=None,
    design_a_v=None,
    ref_a_h=None,
    ref_a_v=None,
    aspect=None,
    vdd=0.9,
    freq_hz=1.0e9,
    wire_cap_f_per_um=0.20e-15,
    non_bus_interconnect_fraction=NON_BUS_INTERCONNECT_FRACTION,
    interconnect_share_of_total=INTERCONNECT_SHARE_OF_TOTAL,
    xp=None,
) -> dict:
    """Vectorized square-vs-rectangle comparison.

    The asymmetric aspect is ``aspect`` when given, else the Eq. 6 optimum of
    the design activities (``design_a_h/v``, defaulting to ``a_h/v``).
    Returns arrays: ``aspect_opt``, the sym/asym bus powers, the shared
    ``fixed_interconnect_w``/``compute_w``, and the three relative savings.
    """
    xp = xp or _xp(rows, pe_area, a_h)
    d_h = a_h if design_a_h is None else design_a_h
    d_v = a_v if design_a_v is None else design_a_v
    aspect_opt = (
        optimal_aspect_power_arr(b_h, b_v, d_h, d_v, xp=xp) if aspect is None else aspect
    )
    kw = dict(
        vdd=vdd,
        freq_hz=freq_hz,
        wire_cap_f_per_um=wire_cap_f_per_um,
        non_bus_interconnect_fraction=non_bus_interconnect_fraction,
        interconnect_share_of_total=interconnect_share_of_total,
        ref_a_h=ref_a_h,
        ref_a_v=ref_a_v,
        xp=xp,
    )
    sym = power_breakdown_arr(rows, cols, b_h, b_v, pe_area, a_h, a_v, 1.0, **kw)
    asym = power_breakdown_arr(rows, cols, b_h, b_v, pe_area, a_h, a_v, aspect_opt, **kw)
    fixed = sym["fixed_interconnect_w"]
    compute = sym["compute_w"]
    sym_i = sym["bus_w"] + fixed
    asym_i = asym["bus_w"] + fixed
    return {
        "aspect_opt": aspect_opt + 0 * sym["bus_w"],
        "sym_bus_w": sym["bus_w"],
        "asym_bus_w": asym["bus_w"],
        "fixed_interconnect_w": fixed,
        "compute_w": compute,
        "bus_saving": 1.0 - asym["bus_w"] / sym["bus_w"],
        "interconnect_saving": 1.0 - asym_i / sym_i,
        "total_saving": 1.0 - (asym_i + compute) / (sym_i + compute),
    }


def compare_sym_asym(
    geom: SystolicArrayGeometry,
    act: BusActivity,
    cfg: EnergyModelConfig = EnergyModelConfig(),
    design_act: BusActivity | None = None,
    reference_act: BusActivity | None = None,
) -> SymAsymComparison:
    """Square vs power-optimal-rectangular floorplan on one workload.

    ``design_act`` (default: ``act``) picks the aspect ratio — a real chip
    fixes its floorplan at design time from *average* activities, then runs
    many workloads; pass the averaged profile here and the per-layer profile
    as ``act`` to reproduce the paper's per-layer Fig. 4 bars.
    """
    d_act = design_act if design_act is not None else act
    aspect = optimal_aspect_power(geom, d_act)
    sym = power_breakdown(geom, act, 1.0, cfg, reference_act=reference_act)
    asym = power_breakdown(geom, act, aspect, cfg, reference_act=reference_act)
    return SymAsymComparison(aspect_opt=aspect, sym=sym, asym=asym)


def average_comparison(comparisons: Sequence[SymAsymComparison]) -> dict[str, float]:
    """Workload-average savings (the paper's 'Average' bars in Fig. 4/5)."""
    if not comparisons:
        raise ValueError("no comparisons")
    sym_i = sum(c.sym.interconnect_w for c in comparisons)
    asym_i = sum(c.asym.interconnect_w for c in comparisons)
    sym_t = sum(c.sym.total_w for c in comparisons)
    asym_t = sum(c.asym.total_w for c in comparisons)
    return {
        "interconnect_saving": 1.0 - asym_i / sym_i,
        "total_saving": 1.0 - asym_t / sym_t,
        "sym_interconnect_w": sym_i / len(comparisons),
        "asym_interconnect_w": asym_i / len(comparisons),
        "sym_total_w": sym_t / len(comparisons),
        "asym_total_w": asym_t / len(comparisons),
    }
