"""Fleet-level J/op objective: one program over (GEMM, layout, point).

SISA's scale-in claim — fleets of small pods beating a monolithic array —
is an *energy per operation* claim, not a wire-power claim: an
under-utilized monolith amortizes its (lower) wire power over fewer useful
MACs, while a pod fleet pays reduction-trunk and spill traffic for its
(higher) utilization.  This module closes that loop by fusing three
previously separate answers into the one broadcast coefficient program:

  * wire power per (workload, layout, point) at the robust aspect — the
    existing ``evaluate_layout_space`` coefficient engine;
  * the pod-partition model (utilization, tile-parallel vs K-split, spill
    and trunk words per MAC) — lowered once to (GEMM, layout, point)
    arrays by ``repro_torch.layout.coeffs.lower_partition_coeffs`` (the host
    ``partition_gemm`` loop stays as the scalar oracle);
  * the calibrated non-bus power split of ``repro_torch.core.energy`` — a fixed
    interconnect term plus a first-order PE/register compute term, both
    anchored to the square-layout reference bus power per workload/point.

The fused objective per cell is

    j_per_mac = (P_bus + P_overhead + P_fixed + P_compute)
                  / (freq * rows * cols * utilization)
                + spill_words_per_mac * E_spill_word
                + trunk_words_per_mac * E_trunk_word

with the word energies priced through the same switched-capacitance
roll-up as every other segment (spilled partials traverse 2*rows vertical
hops, trunk words cross one gutter), coding multipliers included.  The
MAC-weighted fleet slot ``j_per_mac_robust`` is exactly total joules over
total useful MACs for the workload mix.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.core.energy import EnergyModelConfig, calibration_split_arr
from repro_torch.core.floorplan import bus_power_arr
from repro_torch.core.workloads import Gemm
from repro_torch.layout.coeffs import grid_coding_effective, lower_partition_coeffs
from repro_torch.layout.power import (
    LayoutPowerConfig,
    LayoutSpaceEval,
    ObjectiveSpec,
    evaluate_layout_space,
)

__all__ = ["evaluate_fleet_objective", "fleet_static_power"]


def fleet_static_power(
    grid, a_h, a_v, *, energy_cfg: EnergyModelConfig = EnergyModelConfig()
) -> np.ndarray:
    """(W, P) calibrated non-bus watts: fixed interconnect + compute term.

    Anchored per workload/point to the square-layout reference bus power
    (coded activities where the point's bus-invert flag is set), exactly
    the DESIGN.md §2 calibration split.  This is the ``static_w`` term of
    the J/op objective — first-order in the sense that it scales with the
    reference bus power, not with pipeline depth or utilization.
    """
    a_h = np.atleast_2d(np.asarray(a_h, float))
    a_v_eff = grid_coding_effective(grid, np.atleast_2d(np.asarray(a_v, float)))
    bus_ref_sq = bus_power_arr(
        np.asarray(grid.rows, float),
        np.asarray(grid.cols, float),
        np.asarray(grid.b_h, float),
        np.asarray(grid.b_v, float),
        np.asarray(grid.pe_area_um2, float),
        a_h,
        a_v_eff,
        1.0,
        energy_cfg.vdd,
        energy_cfg.freq_hz,
        energy_cfg.wire_cap_f_per_um,
        xp=np,
    )
    fixed, compute = calibration_split_arr(
        bus_ref_sq,
        energy_cfg.non_bus_interconnect_fraction,
        energy_cfg.interconnect_share_of_total,
    )
    return np.asarray(fixed + compute, float)


def evaluate_fleet_objective(
    grid,
    a_h,
    a_v,
    gemms: Sequence[Gemm],
    *,
    layouts: Sequence[str] = ("uniform", "serpentine2", "pods2x2"),
    weights: Sequence[float] | None = None,
    cfg: LayoutPowerConfig = LayoutPowerConfig(),
    energy_cfg: EnergyModelConfig = EnergyModelConfig(),
    engine: str = "cuda",
    gss_iters: int = 64,
    sweep=None,
    macs_per_token: float | None = None,
) -> LayoutSpaceEval:
    """Rank layout families on total J per useful MAC in one program.

    The workload axis IS the GEMM axis: ``a_h``/``a_v`` are (G, P)
    activities, one row per GEMM in ``gemms`` (broadcast from (P,) for a
    single shared profile).  ``weights`` default to MAC weighting, which
    makes the returned ``j_per_mac_robust`` exactly total fleet joules
    over total useful MACs.  Returns a ``LayoutSpaceEval`` whose
    ``j_per_mac``/``j_per_mac_robust``/``utilization``/``best_layout_jpo``
    fields are populated next to the wire-power outputs — compare
    ``best_layout`` (bus power only) against ``best_layout_jpo`` to find
    the cells where utilization and traffic flip the winner.

    ``macs_per_token`` is the serving-traffic aggregation slot (J/token =
    J/op x MACs/token): pass a job set's MAC/s-over-tokens/s (e.g.
    ``repro_torch.serving.traffic.ServingJobSet.macs_per_token``, with
    ``weights`` set to its MAC-rate shares so the robust slot is the
    traffic mix's fleet J/op) and the eval's ``j_per_token_robust``
    property prices joules per served token per (layout, point) cell.

    ``engine`` is one of ``repro_torch.core.design_space.ENGINES``
    (``"cuda"``, the default, ``"torch"`` or ``"numpy"``) and ``sweep`` a
    ``repro_torch.core.sweep.SweepConfig``, both passed to
    ``evaluate_layout_space``.
    """
    gemms = list(gemms)
    if not gemms:
        raise ValueError("no gemms")
    p = grid.n_points
    a_h = np.atleast_2d(np.asarray(a_h, float))
    a_v = np.atleast_2d(np.asarray(a_v, float))
    if a_h.size == 1:  # scalar activity: one shared profile for every point
        a_h = np.broadcast_to(a_h.reshape(1, 1), (1, p)).copy()
    if a_v.size == 1:
        a_v = np.broadcast_to(a_v.reshape(1, 1), (1, p)).copy()
    if a_h.shape[0] == 1 and len(gemms) > 1:
        a_h = np.broadcast_to(a_h, (len(gemms), a_h.shape[1])).copy()
        a_v = np.broadcast_to(a_v, (len(gemms), a_v.shape[1])).copy()
    if a_h.shape[0] != len(gemms):
        raise ValueError(
            f"activity workload axis ({a_h.shape[0]}) must match the GEMM "
            f"axis ({len(gemms)}): the J/op objective prices one GEMM per "
            "workload slot"
        )
    macs = np.asarray([g.macs for g in gemms], float)
    w = np.asarray(weights if weights is not None else macs, float)
    partition = lower_partition_coeffs(grid, tuple(layouts), gemms)
    static_w = np.broadcast_to(
        fleet_static_power(grid, a_h, a_v, energy_cfg=energy_cfg), (len(gemms), p)
    ).copy()
    ev = evaluate_layout_space(
        grid,
        a_h,
        a_v,
        layouts=tuple(layouts),
        weights=w,
        cfg=cfg,
        engine=engine,
        gss_iters=gss_iters,
        sweep=sweep,
        objective=ObjectiveSpec(partition=partition, static_w=static_w),
    )
    if macs_per_token is not None:
        if macs_per_token <= 0:
            raise ValueError("macs_per_token must be positive")
        ev = dataclasses.replace(ev, macs_per_token=float(macs_per_token))
    return ev
