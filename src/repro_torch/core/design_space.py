"""Declarative design-space exploration over the asymmetric-floorplan model.

The paper's headline claim is a *design-space* statement: the optimal
floorplan aspect depends jointly on geometry (R, C, B_h, B_v), dataflow,
coding, and measured switching activity.  This module turns the array-first
analytical core (``repro_torch.core.floorplan`` / ``energy`` / ``optimize``) into
an exploration engine:

  * ``DesignSpace`` — a declarative spec: grids over rows/cols, input bit
    widths, dataflow (WS/OS), bus-invert coding on/off, PE area, plus the
    practical aspect envelope.  ``expand()`` materializes the cross product
    as a ``DesignGrid`` — a struct-of-arrays with one flat point axis P.
  * ``evaluate_design_space`` — evaluates the whole grid against a workload
    axis of activities (shape (W, P)) in ONE program (float64 tensors on the
    engine's device, or plain float64 numpy): envelope-clamped Eq. 6 optima per
    (workload, point), a batched log-space golden-section cross-check of
    those optima, vectorized minimax-regret robust aspects across the
    workload axis, workload-aggregated bus power and calibrated
    interconnect/total savings per point.
  * ``sweep_bus_power`` — the (P, S) bus-power surface over an aspect axis
    (the Fig. 2/3 analog, for every design point at once).
  * ``pareto_mask`` / ``DesignSpaceEval.pareto`` — non-dominated design
    extraction over (bus power, area, worst-case regret) or any objective
    subset.

Broadcasting contract
---------------------
Point axis P is always last; the workload axis W (when present) leads.
Per-point fields are (P,), per-(workload, point) values are (W, P), and the
aspect-sweep surface is (P, S).  Activities may be passed as scalars, (P,)
or (W, P) — they are broadcast to (W, P).

Measured activities come from ``repro_torch.core.workloads.measured_design_activities``,
which profiles one *activity class* per workload layer through
``repro_torch.core.pipeline.run_profile_batch`` — (rows, b_h, b_v) classes for WS
points, geometry-free (b_h, b_v) classes for OS points — and broadcasts the
result across the cols/area/coding axes (toggle activities are column-count
invariant under the WS stream model and fully geometry-invariant under OS),
so a handful of profiling passes feeds arbitrarily many geometry points.
OS vertical activities are MEASURED from the W-operand column streams; the
old ``a_v := a_h`` approximation is retired.

Engines: ``evaluate_design_space`` and ``sweep_bus_power`` each run one
float64 program, the same ``*_core`` function on every engine: ``"cuda"``
(the default) on tensors on the current CUDA device, ``"torch"`` on CPU
tensors, ``"numpy"`` on numpy arrays.  ``"cuda"`` raises
``CudaUnavailableError`` where there is no card; no engine falls back to
another.  Grid expansion, activity mapping and Pareto extraction are
host-side numpy.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.energy import EnergyModelConfig, calibration_split_arr
from repro_torch.core.floorplan import (
    ASPECT_MAX,
    ASPECT_MIN,
    SystolicArrayGeometry,
    _xp,
    bus_power_arr,
    golden_section_minimize_arr,
    optimal_aspect_power_arr,
)
from repro_torch.core.optimize import _power_shape
from repro_torch.kernels._engine import engine_device

__all__ = [
    "ENGINES",
    "DesignSpace",
    "DesignGrid",
    "DesignSpaceEval",
    "evaluate_design_space",
    "evaluate_layout_design_space",
    "sweep_bus_power",
    "pareto_mask",
]

_DATAFLOWS = ("WS", "OS")
ENGINES = ("cuda", "torch", "numpy")


def _as_tuple(x, kind=None) -> tuple:
    if isinstance(x, (str, bytes)) or not isinstance(x, Sequence):
        x = (x,)
    x = tuple(x)
    if kind is not None:
        x = tuple(kind(v) for v in x)
    return x


def _ceil_log2(r: np.ndarray) -> np.ndarray:
    """Elementwise ceil(log2(r)) for positive ints, exact at powers of two
    (evaluated at r - 0.5 so float rounding cannot cross the integer)."""
    return np.maximum(np.ceil(np.log2(r - 0.5)).astype(np.int64), 0)


@dataclasses.dataclass(frozen=True)
class DesignSpace:
    """Declarative spec of a floorplan design space (grids per axis).

    Axes (each a sequence; scalars auto-promote to length-1 tuples):
      rows / cols      PE grid dimensions.
      input_bits       operand quantization width (= B_h).
      dataflows        "WS" (B_v = accumulator width) and/or "OS"
                       (B_v = input_bits; partial sums never move).
      bus_invert       whether the vertical bus is BI-coded (B_v += 1 invert
                       line, a_v -> coded activity at evaluation time).
      pe_area_um2      per-PE area.
      layouts          physical layout families to pair every geometry point
                       with: registered names (``repro_torch.layout.LAYOUTS``) or
                       parametric spellings — ``"pods{k}x{k}"`` promotes pod
                       count k to a free integer axis (``pod_layouts``),
                       ``"serpentine{f}"`` the fold count.  The layout axis
                       is evaluated by the
                       segment-level engine (``evaluate_layout_design_space``
                       / ``repro_torch.layout.power.evaluate_layout_space``), NOT
                       flattened into the point axis: the closed-form
                       ``evaluate_design_space`` only describes the uniform
                       family.
    ``aspect_lo``/``aspect_hi`` bound the practical aspect envelope shared by
    every optimization in the evaluation.
    """

    rows: Sequence[int]
    cols: Sequence[int]
    input_bits: Sequence[int] = (16,)
    dataflows: Sequence[str] = ("WS",)
    bus_invert: Sequence[bool] = (False,)
    pe_area_um2: Sequence[float] = (1200.0,)
    aspect_lo: float = ASPECT_MIN
    aspect_hi: float = ASPECT_MAX
    layouts: Sequence[str] = ("uniform",)

    def __post_init__(self) -> None:
        object.__setattr__(self, "rows", _as_tuple(self.rows, int))
        object.__setattr__(self, "cols", _as_tuple(self.cols, int))
        object.__setattr__(self, "input_bits", _as_tuple(self.input_bits, int))
        object.__setattr__(self, "dataflows", _as_tuple(self.dataflows, str))
        object.__setattr__(self, "bus_invert", _as_tuple(self.bus_invert, bool))
        object.__setattr__(self, "pe_area_um2", _as_tuple(self.pe_area_um2, float))
        object.__setattr__(self, "layouts", _as_tuple(self.layouts, str))
        if not self.layouts:
            raise ValueError("layouts axis must be non-empty")
        # Names resolve through get_layout so PARAMETRIC spellings —
        # "pods{k}x{k}" (the free pod-count axis), "serpentine{f}" — are
        # first-class axis values, not just registry entries.
        from repro_torch.layout.geometry import LAYOUTS as _REGISTRY
        from repro_torch.layout.geometry import get_layout as _get_layout

        unknown = []
        for n in self.layouts:
            try:
                _get_layout(n)
            except (KeyError, ValueError):
                unknown.append(n)
        if unknown:
            raise ValueError(
                f"unknown layout families {unknown}; registered: {sorted(_REGISTRY)}, "
                "parametric: 'pods{k}x{k}', 'serpentine{f}'"
            )
        for name in ("rows", "cols", "input_bits"):
            vals = getattr(self, name)
            if not vals or any(v < 1 for v in vals):
                raise ValueError(f"{name} must be non-empty positive ints")
        if not self.dataflows or any(d not in _DATAFLOWS for d in self.dataflows):
            raise ValueError(f"dataflows must be drawn from {_DATAFLOWS}")
        if not self.pe_area_um2 or any(a <= 0 for a in self.pe_area_um2):
            raise ValueError("pe_area_um2 must be non-empty positive")
        if not self.bus_invert:
            raise ValueError("bus_invert axis must be non-empty")
        if not (0 < self.aspect_lo < self.aspect_hi):
            raise ValueError("need 0 < aspect_lo < aspect_hi")
        widest = 0
        if "WS" in self.dataflows:
            widest = 2 * max(self.input_bits) + int(
                _ceil_log2(np.asarray([max(self.rows)]))[0]
            )
        if "OS" in self.dataflows:
            widest = max(widest, max(self.input_bits))
        if widest + (1 if any(self.bus_invert) else 0) > 64:
            raise ValueError("accumulator (+BI) bus width exceeds the 64-bit toggle model")

    @property
    def n_points(self) -> int:
        return (
            len(self.rows)
            * len(self.cols)
            * len(self.input_bits)
            * len(self.dataflows)
            * len(self.bus_invert)
            * len(self.pe_area_um2)
        )

    def expand(self) -> "DesignGrid":
        """Materialize the cross product as a struct-of-arrays grid.

        Axis nesting is C-order with rows slowest and pe_area fastest:
        (rows, cols, input_bits, dataflows, bus_invert, pe_area_um2).
        """
        df_os = np.asarray([d == "OS" for d in self.dataflows])
        mesh = np.meshgrid(
            np.asarray(self.rows, np.int64),
            np.asarray(self.cols, np.int64),
            np.asarray(self.input_bits, np.int64),
            df_os,
            np.asarray(self.bus_invert, bool),
            np.asarray(self.pe_area_um2, float),
            indexing="ij",
        )
        rows, cols, bits, os_mask, bi, area = (m.ravel() for m in mesh)
        acc = 2 * bits + _ceil_log2(rows)
        b_v_data = np.where(os_mask, bits, acc)
        return DesignGrid(
            rows=rows,
            cols=cols,
            b_h=bits,
            b_v=b_v_data + bi.astype(np.int64),
            b_v_data=b_v_data,
            bus_invert=bi,
            dataflow_os=os_mask,
            pe_area_um2=area,
            aspect_lo=self.aspect_lo,
            aspect_hi=self.aspect_hi,
        )


@dataclasses.dataclass(frozen=True)
class DesignGrid:
    """Struct-of-arrays design grid: every field is a flat (P,) array.

    ``b_v`` is the physical vertical bus width (including the bus-invert
    line when coded); ``b_v_data`` is the data width the BI activity
    transform applies to.
    """

    rows: np.ndarray
    cols: np.ndarray
    b_h: np.ndarray
    b_v: np.ndarray
    b_v_data: np.ndarray
    bus_invert: np.ndarray
    dataflow_os: np.ndarray
    pe_area_um2: np.ndarray
    aspect_lo: float = ASPECT_MIN
    aspect_hi: float = ASPECT_MAX

    @property
    def n_points(self) -> int:
        return int(np.asarray(self.rows).shape[0])

    def geometry(self, i: int) -> SystolicArrayGeometry:
        """Scalar-API geometry of point ``i`` (for cross-checks/reporting)."""
        return SystolicArrayGeometry(
            rows=int(self.rows[i]),
            cols=int(self.cols[i]),
            b_h=int(self.b_h[i]),
            b_v=int(self.b_v[i]),
            pe_area_um2=float(self.pe_area_um2[i]),
        )

    def select(self, idx) -> "DesignGrid":
        """Sub-grid at the given indices/mask (e.g. a Pareto frontier)."""
        return DesignGrid(
            rows=self.rows[idx],
            cols=self.cols[idx],
            b_h=self.b_h[idx],
            b_v=self.b_v[idx],
            b_v_data=self.b_v_data[idx],
            bus_invert=self.bus_invert[idx],
            dataflow_os=self.dataflow_os[idx],
            pe_area_um2=self.pe_area_um2[idx],
            aspect_lo=self.aspect_lo,
            aspect_hi=self.aspect_hi,
        )

    def describe(self, i: int) -> str:
        return (
            f"{int(self.rows[i])}x{int(self.cols[i])} b{int(self.b_h[i])}"
            f"{'/OS' if self.dataflow_os[i] else ''}{'/BI' if self.bus_invert[i] else ''}"
            f" Bv={int(self.b_v[i])}"
        )


# ---------------------------------------------------------------------------
# Evaluation engine
# ---------------------------------------------------------------------------


def _effective_a_v(grid, a_v):
    """Host-side coded vertical activity (see ``layout.coeffs``).

    Coding is lowered BEFORE the evaluator program: the exact float64
    bus-invert closed form runs once on the host (``grid_coding_effective``
    — the same transform the layout/objective engines consume as activity
    multipliers), so the coding flag is no longer special-cased inside the
    evaluators.
    """
    from repro_torch.layout.coeffs import grid_coding_effective

    return grid_coding_effective(grid, a_v)


def _evaluate_core(
    rows,
    cols,
    b_h,
    b_v,
    pe_area,
    a_h,
    a_v_eff,  # CODED vertical activity (host-lowered, see _effective_a_v)
    weights,
    lo,
    hi,
    vdd,
    freq_hz,
    wire_cap,
    f_nb,
    share,
    *,
    gss_iters: int,
):
    xp = _xp(rows, a_h)
    a_v_eff = a_v_eff + 0.0

    # Per-(workload, point) envelope-clamped Eq. 6 optimum + its numeric
    # (batched log-space golden-section) cross-check.
    aspect_opt = optimal_aspect_power_arr(b_h, b_v, a_h, a_v_eff, lo=lo, hi=hi, xp=xp)
    log_lo = xp.log(lo + 0.0 * a_h)
    log_hi = xp.log(hi + 0.0 * a_h)
    aspect_opt_gss = xp.exp(
        golden_section_minimize_arr(
            lambda log_r: _power_shape(b_h, b_v, a_h, a_v_eff, xp.exp(log_r), xp),
            log_lo,
            log_hi,
            iters=gss_iters,
            xp=xp,
        )
    )

    pw = functools.partial(
        bus_power_arr,
        rows,
        cols,
        b_h,
        b_v,
        pe_area,
        a_h,
        a_v_eff,
        vdd=vdd,
        freq_hz=freq_hz,
        wire_cap_f_per_um=wire_cap,
        xp=xp,
    )
    p_opt = pw(aspect=aspect_opt)
    p_square = pw(aspect=1.0)

    # Robust (minimax-regret) aspect per point, vectorized across the
    # workload axis: regret reuses the per-workload optimum power shapes.
    shape_own = _power_shape(b_h, b_v, a_h, a_v_eff, aspect_opt, xp)
    safe_own = xp.where(shape_own > 0, shape_own, 1.0)

    def worst_regret(log_a):
        p = _power_shape(b_h, b_v, a_h, a_v_eff, xp.exp(log_a)[None, ...], xp)
        return xp.max(xp.where(shape_own > 0, p / safe_own - 1.0, 0.0), axis=0)

    aspect_robust = xp.exp(
        golden_section_minimize_arr(
            worst_regret, log_lo[0], log_hi[0], iters=gss_iters, xp=xp
        )
    )
    regret_robust = worst_regret(xp.log(aspect_robust))

    p_robust = pw(aspect=aspect_robust[None, ...])
    w_col = weights[:, None]
    bus_power_robust = xp.sum(w_col * p_robust, axis=0)
    bus_power_square = xp.sum(w_col * p_square, axis=0)

    # Calibrated savings at the robust aspect, workload-aggregated the way
    # ``energy.average_comparison`` aggregates Fig. 4/5 (power-weighted sums;
    # the square layout under each workload's own activities is the anchor).
    fixed, compute = calibration_split_arr(p_square, f_nb, share)
    sym_i = xp.sum(w_col * (p_square + fixed), axis=0)
    asym_i = xp.sum(w_col * (p_robust + fixed), axis=0)
    comp_t = xp.sum(w_col * compute, axis=0)
    safe_sym = xp.where(sym_i > 0, sym_i, 1.0)
    safe_tot = xp.where(sym_i + comp_t > 0, sym_i + comp_t, 1.0)

    return {
        "a_v_eff": a_v_eff,
        "aspect_opt": aspect_opt,
        "aspect_opt_gss": aspect_opt_gss,
        "bus_power_opt": p_opt,
        "bus_power_sym": p_square,
        "aspect_robust": aspect_robust,
        "max_regret": regret_robust,
        "bus_power_robust": bus_power_robust,
        "bus_power_square": bus_power_square,
        "interconnect_saving": 1.0 - asym_i / safe_sym,
        "total_saving": 1.0 - (asym_i + comp_t) / safe_tot,
        "area_um2": rows * cols * pe_area,
        # Throughput-aware objectives: each PE retires one MAC per cycle, so
        # J/MAC = P / (R C f).  ``neg_macs_per_cycle`` is negated so the
        # minimize-all Pareto convention maximizes throughput.
        "bus_energy_per_mac_j": bus_power_robust / (rows * cols * freq_hz),
        "neg_macs_per_cycle": -(rows * cols),
    }


def _sweep_core(rows, cols, b_h, b_v, pe_area, a_h, a_v_eff, aspects):
    xp = _xp(rows, a_h, aspects)
    return bus_power_arr(
        rows[:, None],
        cols[:, None],
        b_h[:, None],
        b_v[:, None],
        pe_area[:, None],
        a_h[:, None],
        a_v_eff[:, None],
        aspects[None, :],
        xp=xp,
    )


def _engine_device(engine: str) -> torch.device | None:
    """The torch device an evaluator's ``engine`` runs on; None for numpy."""
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; expected one of {ENGINES}")
    return None if engine == "numpy" else engine_device(engine)


def _run_core(fn, args, device: torch.device | None):
    """Run a float64 ``*_core`` program: on numpy arrays when ``device`` is
    None, else on float64 tensors on ``device`` (numpy arguments are copied
    there, tensors and scalars pass as they are); every tensor it returns
    comes back as a numpy array."""
    if device is not None:
        args = [
            torch.tensor(x, dtype=torch.float64, device=device)
            if isinstance(x, np.ndarray) else x
            for x in args
        ]
    out = fn(*args)

    def host(v):
        return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)

    return {k: host(v) for k, v in out.items()} if isinstance(out, dict) else host(out)


@dataclasses.dataclass(frozen=True)
class DesignSpaceEval:
    """Struct-of-arrays evaluation of a design grid (see field comments).

    Workload-axis outputs are (W, P); per-point outputs are (P,).
    """

    grid: DesignGrid
    a_v_eff: np.ndarray  # (W, P) vertical activity after bus-invert coding
    aspect_opt: np.ndarray  # (W, P) envelope-clamped Eq. 6 optimum
    aspect_opt_gss: np.ndarray  # (W, P) batched golden-section cross-check
    bus_power_opt: np.ndarray  # (W, P) bus power at aspect_opt [W]
    bus_power_sym: np.ndarray  # (W, P) bus power at the square layout [W]
    aspect_robust: np.ndarray  # (P,) minimax-regret aspect over workloads
    max_regret: np.ndarray  # (P,) worst-case regret at aspect_robust
    bus_power_robust: np.ndarray  # (P,) workload-weighted bus power at robust
    bus_power_square: np.ndarray  # (P,) workload-weighted square bus power
    interconnect_saving: np.ndarray  # (P,) calibrated, at aspect_robust
    total_saving: np.ndarray  # (P,) calibrated, at aspect_robust
    area_um2: np.ndarray  # (P,) total PE array area
    bus_energy_per_mac_j: np.ndarray  # (P,) robust bus power / (R C f)
    neg_macs_per_cycle: np.ndarray  # (P,) -(R C): minimize == max throughput
    sweep_report: object | None = None  # SweepReport when run via ``sweep=``

    @property
    def n_points(self) -> int:
        return self.grid.n_points

    def objectives(
        self, names: Sequence[str] = ("bus_power_robust", "area_um2", "max_regret")
    ) -> np.ndarray:
        """(P, len(names)) objective matrix (all minimized)."""
        return np.stack([np.asarray(getattr(self, n), float) for n in names], axis=1)

    def pareto(
        self, names: Sequence[str] = ("bus_power_robust", "area_um2", "max_regret")
    ) -> np.ndarray:
        """Boolean (P,) mask of Pareto-optimal points for the objectives."""
        return pareto_mask(self.objectives(names))


def _norm_activities(a_h, a_v, n_points: int) -> tuple[np.ndarray, np.ndarray]:
    a_h = np.atleast_1d(np.asarray(a_h, float))
    a_v = np.atleast_1d(np.asarray(a_v, float))
    if a_h.ndim == 1:
        a_h = a_h[None, :]
    if a_v.ndim == 1:
        a_v = a_v[None, :]
    w = max(a_h.shape[0], a_v.shape[0])
    a_h = np.broadcast_to(a_h, (w, n_points))
    a_v = np.broadcast_to(a_v, (w, n_points))
    if not (0.0 <= a_h.min() and a_h.max() <= 1.0 and 0.0 <= a_v.min() and a_v.max() <= 1.0):
        raise ValueError("activities must lie in [0, 1]")
    return np.ascontiguousarray(a_h), np.ascontiguousarray(a_v)


def evaluate_design_space(
    grid: DesignGrid,
    a_h,
    a_v,
    *,
    weights: Sequence[float] | None = None,
    cfg: EnergyModelConfig = EnergyModelConfig(),
    engine: str = "cuda",
    gss_iters: int = 64,
    sweep=None,
) -> DesignSpaceEval:
    """Evaluate every design point of ``grid`` against a workload axis.

    ``a_h``/``a_v`` are activities of shape scalar, (P,), or (W, P) —
    measured (``workloads.measured_design_activities``) or analytical.
    ``weights`` (W,) mixes workloads for the aggregate power/saving outputs
    (default: uniform).  Runs as one float64 program on ``engine``
    (``ENGINES``; see the module docstring); every engine computes the
    same float64 results up to the last bits of the elementwise functions.

    ``sweep`` (a ``repro_torch.core.sweep.SweepConfig``) routes evaluation
    through the chunked, checkpointed, guard-validated runner: the point
    axis is split into fixed-shape chunks, each committed to a crash-safe
    content-addressed store and validated against physical contracts and
    scalar-oracle cross-checks; a killed sweep resumes bit-identically.
    The returned eval carries the machine-readable ``sweep_report``.
    """
    p = grid.n_points
    a_h, a_v = _norm_activities(a_h, a_v, p)
    w = np.asarray(
        weights if weights is not None else np.ones(a_h.shape[0]), float
    )
    if w.shape != (a_h.shape[0],):
        raise ValueError("weights must match the workload axis")
    if w.sum() <= 0:
        raise ValueError("weights must sum to a positive value")
    w = w / w.sum()

    device = _engine_device(engine)
    if sweep is not None:
        from repro_torch.core.sweep import run_design_sweep

        out, report = run_design_sweep(
            grid, a_h, a_v, w, cfg=cfg, gss_iters=gss_iters, engine=engine,
            sweep=sweep,
        )
        return DesignSpaceEval(grid=grid, sweep_report=report, **out)
    args = (
        np.asarray(grid.rows, float),
        np.asarray(grid.cols, float),
        np.asarray(grid.b_h, float),
        np.asarray(grid.b_v, float),
        np.asarray(grid.pe_area_um2, float),
        a_h,
        _effective_a_v(grid, a_v),
        w,
        float(grid.aspect_lo),
        float(grid.aspect_hi),
        cfg.vdd,
        cfg.freq_hz,
        cfg.wire_cap_f_per_um,
        cfg.non_bus_interconnect_fraction,
        cfg.interconnect_share_of_total,
    )
    out = _run_core(functools.partial(_evaluate_core, gss_iters=gss_iters), args, device)
    return DesignSpaceEval(grid=grid, **out)


def sweep_bus_power(
    grid: DesignGrid, a_h, a_v, aspects, *, engine: str = "cuda"
) -> np.ndarray:
    """(P, S) bus power surface over an aspect axis — the Fig. 2/3 analog
    for every design point at once.  ``a_h``/``a_v`` are per-point (P,) or
    scalar activities (combine the workload axis first, e.g. with
    transition-weighted means).  Runs on ``engine`` (``ENGINES``)."""
    p = grid.n_points
    a_h = np.ascontiguousarray(np.broadcast_to(np.asarray(a_h, float), (p,)))
    a_v = np.ascontiguousarray(np.broadcast_to(np.asarray(a_v, float), (p,)))
    aspects = np.asarray(aspects, float)
    device = _engine_device(engine)
    args = (
        np.asarray(grid.rows, float),
        np.asarray(grid.cols, float),
        np.asarray(grid.b_h, float),
        np.asarray(grid.b_v, float),
        np.asarray(grid.pe_area_um2, float),
        a_h,
        _effective_a_v(grid, a_v),
        aspects,
    )
    return _run_core(_sweep_core, args, device)


def evaluate_layout_design_space(
    space_or_grid,
    a_h,
    a_v,
    *,
    layouts: Sequence[str] | None = None,
    **kwargs,
):
    """Evaluate the design grid across its LAYOUT-FAMILY axis.

    The segment-level entry point of the exploration engine: where
    ``evaluate_design_space`` collapses every point to the closed-form
    uniform rectangle, this pairs each point with every family of the
    layout axis (``DesignSpace.layouts``, or an explicit ``layouts=``) and
    runs the segment-class evaluator —
    ``repro_torch.layout.power.evaluate_layout_space`` — over the (point x
    layout) batch: envelope-constrained optimal aspects, data-net powers,
    overheads, and the best family per point.  Accepts a ``DesignSpace``
    (expanded here) or a ``DesignGrid``; see ``evaluate_layout_space`` for
    the remaining keyword arguments (per-lane activities, weights,
    ``LayoutPowerConfig``...).
    """
    from repro_torch.layout.power import evaluate_layout_space

    if isinstance(space_or_grid, DesignSpace):
        if layouts is None:
            layouts = space_or_grid.layouts
        grid = space_or_grid.expand()
    else:
        grid = space_or_grid
        if layouts is None:
            # A bare grid does not carry the layout axis (expand() keeps the
            # point axis geometry-only); silently defaulting would drop
            # whatever the user configured on the space.
            raise ValueError(
                "pass layouts= explicitly when evaluating a DesignGrid "
                "(or pass the DesignSpace, whose layouts axis is used)"
            )
    return evaluate_layout_space(grid, a_h, a_v, layouts=layouts, **kwargs)


# ---------------------------------------------------------------------------
# Pareto extraction
# ---------------------------------------------------------------------------


def pareto_mask(objectives: np.ndarray, chunk: int = 1024) -> np.ndarray:
    """Boolean mask of Pareto-optimal rows (all objectives minimized).

    A row p dominates q iff p <= q on every objective and p < q on at least
    one; the mask keeps exactly the non-dominated rows (duplicates of a
    non-dominated row are all kept — neither dominates the other).

    Non-finite rows (any NaN or +/-Inf objective) are EXCLUDED: they never
    join the frontier and never dominate anyone.  A poisoned cell (a NaN
    leaking out of an evaluator) must not be able to corrupt — or crash —
    the frontier extraction; NaN comparisons are False-poison under the
    dominance tests, so exclusion is the only safe semantics.

    O(n * frontier) rather than O(n^2): rows are processed in lexicographic
    order (a dominator always sorts no later than its victim), compared in
    vectorized chunks against the accumulated frontier, and only surviving
    rows join the frontier (dominance is transitive, so dominated rows never
    need to serve as dominators).  Verified against the O(n^2) oracle in the
    tests.
    """
    obj = np.asarray(objectives, float)
    if obj.ndim != 2:
        raise ValueError("objectives must be (n_points, n_objectives)")
    n = obj.shape[0]
    if n == 0:
        return np.zeros(0, bool)
    finite = np.isfinite(obj).all(axis=1)
    if not finite.all():
        mask = np.zeros(n, bool)
        if finite.any():
            mask[finite] = pareto_mask(obj[finite], chunk)
        return mask
    order = np.lexsort(obj.T[::-1])  # sort by column 0, then 1, ...
    srt = obj[order]
    keep = np.ones(n, bool)
    front = np.empty((0, obj.shape[1]))
    for lo in range(0, n, chunk):
        blk = srt[lo : lo + chunk]
        k = np.ones(len(blk), bool)
        for flo in range(0, len(front), 4096):  # bound the comparison matrix
            fr = front[flo : flo + 4096]
            le = (fr[:, None, :] <= blk[None, :, :]).all(-1)
            lt = (fr[:, None, :] < blk[None, :, :]).any(-1)
            k &= ~(le & lt).any(axis=0)
        le = (blk[:, None, :] <= blk[None, :, :]).all(-1)
        lt = (blk[:, None, :] < blk[None, :, :]).any(-1)
        k &= ~np.triu(le & lt, 1).any(axis=0)  # dominators sort earlier
        keep[lo : lo + len(blk)] = k
        front = np.concatenate([front, blk[k]])
    mask = np.empty(n, bool)
    mask[order] = keep
    return mask
