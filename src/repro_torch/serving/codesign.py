"""Serving co-design: (model, traffic) -> measured J/token design answers.

Layer 3 of the serving subsystem (DESIGN.md §Serving-workloads).  One call
answers "which array geometry x layout family x dataflow x coding
minimizes J/token for THIS model at THIS traffic mix":

  1. ``weighted_gemms`` turns (config, traffic model) into a MAC-share-
     weighted GEMM job set (``serving.traffic``);
  2. ``measured_design_gemm_activities`` profiles one synthetic-but-seeded
     operand stream per activity class per GEMM shape class (clipped dims,
     content-keyed seeds -> the v4 profile store dedups across models and
     traffic mixes);
  3. ``evaluate_fleet_objective`` prices total J per useful MAC over the
     (GEMM, layout, point) block in one program — utilization and
     spill/trunk traffic from the FULL GEMM dims — with the job set's
     ``macs_per_token`` attached so ``j_per_token_robust`` is exact.

The result also carries per-regime optima (decode-only / prefill-only
re-weighting of the priced ``j_per_mac`` block): decode-time skinny GEMMs
should — and measurably do — pick different geometry/layout cells than
both the prefill mix and the paper's Table-I CNN layers.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.configs.registry import ArchConfig, get_arch
from repro_torch.core.design_space import DesignSpace, _engine_device
from repro_torch.core.objective import evaluate_fleet_objective
from repro_torch.core.workloads import (
    RESNET50_TABLE1,
    conv_to_gemm,
    measured_design_activities,
    measured_design_gemm_activities,
)
from repro_torch.serving.traffic import ServingJobSet, TrafficModel, get_preset, weighted_gemms

__all__ = [
    "CodesignResult",
    "DEFAULT_SPACE",
    "DEFAULT_FAMILIES",
    "codesign",
    "regime_best_cell",
    "cnn_reference",
]

# The explore-example grid: small enough for interactive runs, wide enough
# (rows x cols x WS/OS x coding) that serving mixes can move the optimum.
DEFAULT_SPACE = DesignSpace(
    rows=(16, 32),
    cols=(8, 16, 32, 64, 128),
    input_bits=(16,),
    dataflows=("WS", "OS"),
    bus_invert=(False, True),
)

DEFAULT_FAMILIES = ("uniform", "serpentine2", "pods2x2", "pods4x4")


@dataclasses.dataclass(frozen=True)
class CodesignResult:
    """One (model, traffic) co-design answer over a design grid."""

    arch: str
    traffic: str
    jobset: ServingJobSet
    grid: object  # DesignGrid
    eval: object  # LayoutSpaceEval with J/op + macs_per_token priced
    layouts: tuple[str, ...]

    @property
    def best_cell(self) -> tuple[int, int]:
        """(layout_idx, point_idx) minimizing fleet J/op == J/token."""
        j = np.asarray(self.eval.j_per_mac_robust)
        return tuple(int(i) for i in np.unravel_index(np.argmin(j), j.shape))

    @property
    def j_per_token(self) -> float:
        """J per served token at the best (layout, point) cell."""
        li, pi = self.best_cell
        return float(self.eval.j_per_token_robust[li, pi])

    def regime_cell(self, regime: str) -> tuple[int, int]:
        return regime_best_cell(self.eval, self.jobset, regime)

    def describe_cell(self, cell: tuple[int, int]) -> str:
        li, pi = cell
        return f"{self.layouts[li]} @ {self.grid.describe(pi)}"


def regime_best_cell(ev, jobset: ServingJobSet, regime: str) -> tuple[int, int]:
    """(layout_idx, point_idx) minimizing J/op under ONE regime's weights.

    Re-weights the already-priced per-GEMM ``j_per_mac`` block (W, L, P)
    with the job set's regime-restricted MAC shares — no re-evaluation.
    """
    w = jobset.regime_weights(regime)
    if w.sum() <= 0:
        raise ValueError(f"job set has no {regime!r} MAC share")
    w = w / w.sum()
    j = np.asarray(ev.j_per_mac)  # (W, L, P), +inf on infeasible cells
    jr = np.einsum("w,wlp->lp", w, j)
    jr = np.where(np.isfinite(jr), jr, np.inf)
    return tuple(int(i) for i in np.unravel_index(np.argmin(jr), jr.shape))


def codesign(
    arch: str | ArchConfig,
    traffic: str | TrafficModel,
    *,
    space: DesignSpace = DEFAULT_SPACE,
    layouts: Sequence[str] = DEFAULT_FAMILIES,
    clip: tuple[int, int, int] | None = (128, 512, 256),
    backend: str | None = None,
    use_cache: bool = True,
    engine: str = "cuda",
    sweep=None,
) -> CodesignResult:
    """Measured end-to-end serving co-design for one (model, traffic) pair.

    ``backend`` profiles the job set as ``run_profile_batch`` does (``"auto"``
    and ``"cuda"``: K2 and K3 on the card, raising where there is none;
    ``"torch"`` or ``"numpy"`` on the CPU); ``engine`` prices the objective
    (``"cuda"``, the default, ``"torch"`` or ``"numpy"``); ``sweep`` (a
    ``repro_torch.core.sweep.SweepConfig``) runs the pricing through the
    checkpointed chunk runner.
    """
    _engine_device(engine)  # no card for engine="cuda": raise before profiling
    cfg = get_arch(arch) if isinstance(arch, str) else arch
    tm = get_preset(traffic) if isinstance(traffic, str) else traffic
    jobset = weighted_gemms(cfg, tm)
    grid = space.expand()
    a_h, a_v = measured_design_gemm_activities(
        grid,
        jobset.gemms,
        densities=jobset.densities,
        clip=clip,
        backend=backend,
        use_cache=use_cache,
    )
    ev = evaluate_fleet_objective(
        grid,
        a_h,
        a_v,
        jobset.gemms,
        layouts=tuple(layouts),
        weights=jobset.weights,
        engine=engine,
        sweep=sweep,
        macs_per_token=jobset.macs_per_token,
    )
    return CodesignResult(
        arch=jobset.arch,
        traffic=jobset.traffic,
        jobset=jobset,
        grid=grid,
        eval=ev,
        layouts=tuple(layouts),
    )


def cnn_reference(
    *,
    space: DesignSpace = DEFAULT_SPACE,
    layouts: Sequence[str] = DEFAULT_FAMILIES,
    n_layers: int = 3,
    backend: str | None = None,
    use_cache: bool = True,
    engine: str = "cuda",
) -> tuple[tuple[int, int], object]:
    """The Table-I CNN optimum on the same grid: ((layout, point), eval).

    The baseline the serving answers are compared against — the paper's
    workload never sees decode-time skinny GEMMs or MoE expert batches.
    ``backend`` and ``engine`` as in ``codesign``.
    """
    _engine_device(engine)
    layers = RESNET50_TABLE1[:n_layers]
    grid = space.expand()
    a_h, a_v = measured_design_activities(
        grid, layers, backend=backend, use_cache=use_cache
    )
    ev = evaluate_fleet_objective(
        grid,
        a_h,
        a_v,
        [conv_to_gemm(c) for c in layers],
        layouts=tuple(layouts),
        engine=engine,
    )
    j = np.asarray(ev.j_per_mac_robust)
    cell = tuple(int(i) for i in np.unravel_index(np.argmin(j), j.shape))
    return cell, ev
