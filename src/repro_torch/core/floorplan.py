"""Analytical floorplan model for weight-stationary systolic arrays.

Implements the paper's core contribution (Peltekis et al., "The Case for
Asymmetric Systolic Array Floorplanning", 2023):

  * Eq. 1-3: total horizontal/vertical bus wirelength of an R x C array of
    PEs with a fixed per-PE area ``A = H * W``.
  * Eq. 5:   wirelength-optimal PE aspect ratio ``W/H = B_v / B_h``.
  * Eq. 6:   power-optimal PE aspect ratio   ``W/H = (B_v a_v) / (B_h a_h)``.

All lengths are in micrometers, areas in um^2, powers in watts unless noted.

Array-first layout
------------------
The analytical core is a set of ``*_arr`` kernels: pure functions over
broadcastable arrays of the geometry fields (rows, cols, b_h, b_v,
pe_area), activities (a_h, a_v) and aspect ratios. They are
backend-agnostic: given numpy inputs they compute in float64 numpy; given
torch tensors they compute in torch float64 on the tensors' device, with no
Python branching on values.

The original scalar API (``SystolicArrayGeometry``/``BusActivity``
dataclasses + float-returning functions) is preserved as thin wrappers over
the same kernels, so results are bit-for-bit the kernels' float64 numpy
path.

Practical aspect envelope
-------------------------
Physically realizable standard-cell floorplans bound the PE aspect ratio;
``optimal_aspect_power`` clamps every branch (including the general Eq. 6
form) to ``[ASPECT_MIN, ASPECT_MAX] = [1/16, 16]``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence

import numpy as np
import torch

__all__ = [
    "ASPECT_MIN",
    "ASPECT_MAX",
    "SystolicArrayGeometry",
    "BusActivity",
    "pe_dims_from_aspect",
    "wirelength_h",
    "wirelength_v",
    "wirelength_total",
    "optimal_aspect_wirelength",
    "optimal_aspect_power",
    "bus_switched_capacitance_per_cycle",
    "bus_power",
    "bus_power_ratio_vs_square",
    "golden_section_minimize",
    "numeric_optimal_aspect",
    "sweep_aspects",
    "accumulator_width",
    # vectorized kernels
    "pe_dims_arr",
    "wirelength_h_arr",
    "wirelength_v_arr",
    "wirelength_total_arr",
    "optimal_aspect_wirelength_arr",
    "optimal_aspect_power_arr",
    "bus_switched_capacitance_arr",
    "bus_power_arr",
    "bus_power_ratio_vs_square_arr",
    "golden_section_minimize_arr",
]

# Practical envelope for physically realizable standard-cell placements.
ASPECT_MIN = 1.0 / 16.0
ASPECT_MAX = 16.0
# Backwards-compatible aliases (pre-refactor private names).
_ASPECT_MIN = ASPECT_MIN
_ASPECT_MAX = ASPECT_MAX


class _TorchNamespace:
    """The slice of numpy's namespace the ``*_arr`` kernels use, over torch
    tensors on one device.  Python scalars and numpy values are lifted to
    float64 tensors on that device; tensors keep their own dtype, so pass
    float64 tensors to get the float64 results the numpy path gives."""

    inf = math.inf

    def __init__(self, device: torch.device):
        self.device = device

    def asarray(self, x, dtype=None):
        """``x`` as a tensor on the device: float64 unless ``dtype`` (a
        torch dtype) is given; a tensor keeps its own dtype unless cast."""
        if isinstance(x, torch.Tensor):
            return x if dtype is None else x.to(dtype)
        return torch.as_tensor(x, dtype=dtype or torch.float64, device=self.device)

    def sqrt(self, x):
        return torch.sqrt(self.asarray(x))

    def log(self, x):
        return torch.log(self.asarray(x))

    def log1p(self, x):
        return torch.log1p(self.asarray(x))

    def exp(self, x):
        return torch.exp(self.asarray(x))

    def where(self, cond, x, y):
        return torch.where(self.asarray(cond), self.asarray(x), self.asarray(y))

    def clip(self, x, lo, hi):
        x = self.asarray(x)
        if isinstance(lo, torch.Tensor) or isinstance(hi, torch.Tensor):
            lo, hi = self.asarray(lo, x.dtype), self.asarray(hi, x.dtype)
        return torch.clamp(x, lo, hi)

    def maximum(self, x, y):
        return torch.maximum(self.asarray(x), self.asarray(y))

    def minimum(self, x, y):
        return torch.minimum(self.asarray(x), self.asarray(y))

    def max(self, x, axis=None):
        x = self.asarray(x)
        return torch.amax(x) if axis is None else torch.amax(x, dim=axis)

    def sum(self, x, axis=None, keepdims=False):
        x = self.asarray(x)
        if axis is None:
            return torch.sum(x)
        axis %= x.dim()
        if axis == x.dim() - 1:
            return torch.sum(x, dim=axis, keepdim=keepdims)
        # Any other axis: a left fold, numpy's order for a reduction over an
        # axis that is not the innermost.  torch's kernel picks its order by
        # shape, so a chunk of design points would not reproduce the bits of
        # the whole grid; the fold gives every point the same sums.
        parts = x.unbind(axis)
        out = parts[0]
        for part in parts[1:]:
            out = out + part
        return out.unsqueeze(axis) if keepdims else out

    def cumsum(self, x, axis):
        return torch.cumsum(self.asarray(x), dim=axis)

    def concatenate(self, xs, axis=0):
        return torch.cat([self.asarray(x) for x in xs], dim=axis)

    def zeros(self, shape, dtype=torch.float64):
        return torch.zeros(shape, dtype=dtype, device=self.device)

    def take_along_axis(self, x, idx, axis):
        return torch.take_along_dim(self.asarray(x), idx, dim=axis)

    def isfinite(self, x):
        return torch.isfinite(self.asarray(x))

    def broadcast_arrays(self, *xs):
        return torch.broadcast_tensors(*(self.asarray(x) for x in xs))

    def zeros_like(self, x):
        return torch.zeros_like(x)

    def finfo(self, dtype):
        return torch.finfo(dtype)


def _xp(*xs):
    """Array namespace for the given operands: a torch namespace on the
    first torch tensor's device if any operand is a torch tensor, plain
    ``numpy`` otherwise (so the scalar wrappers stay float64-exact)."""
    for x in xs:
        if isinstance(x, torch.Tensor):
            return _TorchNamespace(x.device)
    return np


def accumulator_width(input_bits: int, rows: int) -> int:
    """Bit width needed to accumulate ``rows`` products of two ``input_bits`` ints.

    A product of two signed B-bit integers needs 2B bits; adding R of them
    grows the dynamic range by ceil(log2 R) bits.  The paper's operating point
    (B=16, R=32) yields 32 + ceil(log2 32) = 37 bits, matching Section IV.
    """
    if input_bits <= 0 or rows <= 0:
        raise ValueError("input_bits and rows must be positive")
    return 2 * input_bits + math.ceil(math.log2(rows))


@dataclasses.dataclass(frozen=True)
class SystolicArrayGeometry:
    """Static geometry of an R x C weight-stationary systolic array.

    Attributes:
      rows / cols:  PE grid dimensions (R, C in the paper).
      b_h:          horizontal (input) bus width in bits, per row.
      b_v:          vertical (partial-sum) bus width in bits, per column.
      pe_area_um2:  fixed per-PE area A; H * W == A for any aspect ratio.
    """

    rows: int
    cols: int
    b_h: int
    b_v: int
    pe_area_um2: float = 1200.0  # 16-bit MAC + pipeline regs @ 28nm (typical)

    def __post_init__(self) -> None:
        if self.rows <= 0 or self.cols <= 0:
            raise ValueError("rows/cols must be positive")
        if self.b_h <= 0 or self.b_v <= 0:
            raise ValueError("bus widths must be positive")
        if self.pe_area_um2 <= 0:
            raise ValueError("pe_area_um2 must be positive")

    @classmethod
    def paper_32x32(cls) -> "SystolicArrayGeometry":
        """The paper's experimental configuration: 32x32, int16, 37-bit sums."""
        return cls(rows=32, cols=32, b_h=16, b_v=accumulator_width(16, 32))


@dataclasses.dataclass(frozen=True)
class BusActivity:
    """Average switching activity (toggles per bit per cycle) per direction."""

    a_h: float
    a_v: float

    def __post_init__(self) -> None:
        if not (0.0 <= self.a_h <= 1.0 and 0.0 <= self.a_v <= 1.0):
            raise ValueError("activities must lie in [0, 1]")

    @classmethod
    def paper_resnet50(cls) -> "BusActivity":
        """Activities measured by the paper on ResNet50/ImageNet (Section IV)."""
        return cls(a_h=0.22, a_v=0.36)


# ---------------------------------------------------------------------------
# Vectorized kernels (broadcastable arrays; numpy or torch)
# ---------------------------------------------------------------------------


def pe_dims_arr(pe_area, aspect, xp=None):
    """(W, H) for PEs of area ``pe_area`` and aspect ratio ``W/H = aspect``."""
    xp = xp or _xp(pe_area, aspect)
    h = xp.sqrt(pe_area / aspect)
    w = pe_area / h
    return w, h


def wirelength_h_arr(rows, cols, b_h, pe_area, aspect, xp=None):
    """Eq. 1: WL_h = R * C * (W * B_h)  [um of wire]."""
    xp = xp or _xp(rows, pe_area, aspect)
    w, _ = pe_dims_arr(pe_area, aspect, xp=xp)
    return rows * cols * w * b_h


def wirelength_v_arr(rows, cols, b_v, pe_area, aspect, xp=None):
    """Eq. 2: WL_v = R * C * (H * B_v)  [um of wire]."""
    xp = xp or _xp(rows, pe_area, aspect)
    _, h = pe_dims_arr(pe_area, aspect, xp=xp)
    return rows * cols * h * b_v


def wirelength_total_arr(rows, cols, b_h, b_v, pe_area, aspect, xp=None):
    """Eq. 3/4: WL = R*C*(W*B_h + H*B_v)."""
    xp = xp or _xp(rows, pe_area, aspect)
    return wirelength_h_arr(rows, cols, b_h, pe_area, aspect, xp=xp) + wirelength_v_arr(
        rows, cols, b_v, pe_area, aspect, xp=xp
    )


def optimal_aspect_wirelength_arr(b_h, b_v, xp=None):
    """Eq. 5: the wirelength-optimal aspect ratio W/H = B_v / B_h."""
    xp = xp or _xp(b_h, b_v)
    return b_v / xp.asarray(b_h)


def optimal_aspect_power_arr(
    b_h, b_v, a_h, a_v, lo: float = ASPECT_MIN, hi: float = ASPECT_MAX, xp=None
):
    """Eq. 6, envelope-clamped and branchless over arrays.

    With x = B_h a_h and y = B_v a_v the power-optimal aspect is y/x; the
    degenerate limits (one or both directions never toggle) resolve to the
    envelope bound on the still-toggling side, or to the Eq. 5 wirelength
    optimum when nothing toggles.  Every branch is clamped to the practical
    envelope ``[lo, hi]`` (default ``[ASPECT_MIN, ASPECT_MAX]``).
    """
    xp = xp or _xp(b_h, b_v, a_h, a_v)
    x = b_h * a_h
    y = b_v * a_v
    x_pos = x > 0
    raw = xp.where(
        x_pos,
        y / xp.where(x_pos, x, 1.0),
        xp.where(y > 0, hi, b_v / xp.asarray(b_h)),
    )
    return xp.clip(raw, lo, hi)


def bus_switched_capacitance_arr(
    rows, cols, b_h, b_v, pe_area, a_h, a_v, aspect, wire_cap_f_per_um=0.20e-15, xp=None
):
    """Average switched wire capacitance per cycle [F] (see ``bus_power``).

    Uniform-activity assumption: every wire of a bus is priced at the
    aggregate activity ``a`` — i.e. ``a * bits`` switching wires per
    transition.  This is exactly the MEAN-LANE approximation of the
    per-bit-lane roll-up (``sum(lane_activities) == a * bits`` by
    construction, so the two agree bit-for-bit whenever every segment
    carries the full bus — the case this closed form describes).  It stops
    being exact once segment widths vary per lane (e.g. multi-pod
    pod-local accumulator buses), which need per-lane activities
    (``ActivityProfile.h_lane_toggles``/``v_lane_toggles``).
    """
    xp = xp or _xp(rows, pe_area, a_h, aspect)
    return wire_cap_f_per_um * (
        a_h * wirelength_h_arr(rows, cols, b_h, pe_area, aspect, xp=xp)
        + a_v * wirelength_v_arr(rows, cols, b_v, pe_area, aspect, xp=xp)
    )


def bus_power_arr(
    rows,
    cols,
    b_h,
    b_v,
    pe_area,
    a_h,
    a_v,
    aspect,
    vdd=0.9,
    freq_hz=1.0e9,
    wire_cap_f_per_um=0.20e-15,
    xp=None,
):
    """Dynamic H/V data-bus power [W]; broadcastable over every argument."""
    xp = xp or _xp(rows, pe_area, a_h, aspect)
    c_sw = bus_switched_capacitance_arr(
        rows, cols, b_h, b_v, pe_area, a_h, a_v, aspect, wire_cap_f_per_um, xp=xp
    )
    return 0.5 * c_sw * vdd * vdd * freq_hz


def bus_power_ratio_vs_square_arr(b_h, b_v, a_h, a_v, xp=None):
    """P_bus(envelope-clamped optimal aspect) / P_bus(square).

    With x = B_h a_h, y = B_v a_v the bus power at aspect r is proportional
    to ``x sqrt(r) + y / sqrt(r)`` (the geometry prefactor cancels in the
    ratio).  When the Eq. 6 optimum y/x lies inside the envelope this equals
    the AM-GM gap ``2 sqrt(xy) / (x + y) <= 1``; outside, the ratio is
    evaluated at the clamped boundary aspect.  Zero-activity designs report
    1.0 (no dynamic power to save).
    """
    xp = xp or _xp(b_h, b_v, a_h, a_v)
    x = b_h * a_h
    y = b_v * a_v
    opt = optimal_aspect_power_arr(b_h, b_v, a_h, a_v, xp=xp)
    s = xp.sqrt(opt)
    denom = x + y
    safe = xp.where(denom > 0, denom, 1.0)
    return xp.where(denom > 0, (x * s + y / s) / safe, 1.0)


def golden_section_minimize_arr(fn, lo, hi, iters: int = 64, xp=None):
    """Elementwise golden-section minimizer over an array of intervals.

    ``fn`` maps an array of probe points (broadcast of ``lo``/``hi``) to
    objective values of the same shape; each element's objective must be
    unimodal on its [lo, hi].  Runs a fixed ``iters`` iterations — the
    surviving interior probe is carried so each iteration costs ONE ``fn``
    evaluation; the interval shrinks by phi^-1 per step (64 iterations
    reach ~1e-13 of the initial interval), and the loop is branch-free in the
    values.
    """
    xp = xp or _xp(lo, hi)
    a = xp.asarray(lo) + 0.0
    b = xp.asarray(hi) + 0.0
    a, b = xp.broadcast_arrays(a, b)
    invphi = (math.sqrt(5.0) - 1.0) / 2.0
    c = b - invphi * (b - a)
    d = a + invphi * (b - a)
    fc, fd = fn(c), fn(d)

    def step(a, b, c, d, fc, fd):
        take_left = fc < fd
        a2 = xp.where(take_left, a, c)
        b2 = xp.where(take_left, d, b)
        # keep-left reuses c as the new d; keep-right reuses d as the new c
        c2 = xp.where(take_left, b2 - invphi * (b2 - a2), d)
        d2 = xp.where(take_left, c, a2 + invphi * (b2 - a2))
        f_new = fn(xp.where(take_left, c2, d2))
        fc2 = xp.where(take_left, f_new, fd)
        fd2 = xp.where(take_left, fc, f_new)
        return a2, b2, c2, d2, fc2, fd2

    for _ in range(iters):
        a, b, c, d, fc, fd = step(a, b, c, d, fc, fd)
    return 0.5 * (a + b)


# ---------------------------------------------------------------------------
# Scalar API — thin wrappers over the kernels (numpy float64 path)
# ---------------------------------------------------------------------------


def pe_dims_from_aspect(geom: SystolicArrayGeometry, aspect: float) -> tuple[float, float]:
    """Return (W, H) in um for a PE of area A with aspect ratio ``W/H = aspect``."""
    if aspect <= 0:
        raise ValueError("aspect ratio must be positive")
    w, h = pe_dims_arr(geom.pe_area_um2, aspect, xp=np)
    return float(w), float(h)


def wirelength_h(geom: SystolicArrayGeometry, aspect: float) -> float:
    """Eq. 1: WL_h = R * C * (W * B_h)  [um of wire]."""
    return float(
        wirelength_h_arr(geom.rows, geom.cols, geom.b_h, geom.pe_area_um2, aspect, xp=np)
    )


def wirelength_v(geom: SystolicArrayGeometry, aspect: float) -> float:
    """Eq. 2: WL_v = R * C * (H * B_v)  [um of wire]."""
    return float(
        wirelength_v_arr(geom.rows, geom.cols, geom.b_v, geom.pe_area_um2, aspect, xp=np)
    )


def wirelength_total(geom: SystolicArrayGeometry, aspect: float) -> float:
    """Eq. 3/4: WL = R*C*(W*B_h + H*B_v)."""
    return wirelength_h(geom, aspect) + wirelength_v(geom, aspect)


def optimal_aspect_wirelength(geom: SystolicArrayGeometry) -> float:
    """Eq. 5: the wirelength-optimal aspect ratio W/H = B_v / B_h."""
    return float(optimal_aspect_wirelength_arr(geom.b_h, geom.b_v, xp=np))


def optimal_aspect_power(geom: SystolicArrayGeometry, act: BusActivity) -> float:
    """Eq. 6: the power-optimal aspect ratio W/H = (B_v a_v) / (B_h a_h),
    clamped to the practical envelope ``[ASPECT_MIN, ASPECT_MAX]``.

    Degenerate activities fall back gracefully: if only one direction
    toggles, dynamic bus power is monotonic in the other direction's span
    and the result clamps to the envelope bound (``ASPECT_MAX`` when only
    the vertical bus toggles, ``ASPECT_MIN`` when only the horizontal one
    does); if neither toggles, the Eq. 5 wirelength optimum (clamped) is
    returned.  The general Eq. 6 branch is clamped to the same envelope —
    extreme ``B_v a_v / (B_h a_h)`` ratios otherwise prescribe physically
    unrealizable standard-cell placements.
    """
    return float(optimal_aspect_power_arr(geom.b_h, geom.b_v, act.a_h, act.a_v, xp=np))


def bus_switched_capacitance_per_cycle(
    geom: SystolicArrayGeometry,
    act: BusActivity,
    aspect: float,
    wire_cap_f_per_um: float = 0.20e-15,
) -> float:
    """Average switched wire capacitance per cycle [F].

    C_sw = a_h * WL_h * c_wire + a_v * WL_v * c_wire.  This is the quantity the
    aspect ratio actually optimizes; power is 1/2 * C_sw * V^2 * f.
    """
    return float(
        bus_switched_capacitance_arr(
            geom.rows,
            geom.cols,
            geom.b_h,
            geom.b_v,
            geom.pe_area_um2,
            act.a_h,
            act.a_v,
            aspect,
            wire_cap_f_per_um,
            xp=np,
        )
    )


def bus_power(
    geom: SystolicArrayGeometry,
    act: BusActivity,
    aspect: float,
    vdd: float = 0.9,
    freq_hz: float = 1.0e9,
    wire_cap_f_per_um: float = 0.20e-15,
) -> float:
    """Dynamic power dissipated on the H/V data buses [W] at a given aspect."""
    return float(
        bus_power_arr(
            geom.rows,
            geom.cols,
            geom.b_h,
            geom.b_v,
            geom.pe_area_um2,
            act.a_h,
            act.a_v,
            aspect,
            vdd,
            freq_hz,
            wire_cap_f_per_um,
            xp=np,
        )
    )


def bus_power_ratio_vs_square(geom: SystolicArrayGeometry, act: BusActivity) -> float:
    """P_bus(envelope-clamped optimal aspect) / P_bus(square).

    Equals the AM-GM gap ``2 sqrt(xy)/(x+y)`` (x = B_h a_h, y = B_v a_v)
    whenever the Eq. 6 optimum lies inside the practical envelope; see
    ``bus_power_ratio_vs_square_arr``.
    """
    return float(
        bus_power_ratio_vs_square_arr(geom.b_h, geom.b_v, act.a_h, act.a_v, xp=np)
    )


def golden_section_minimize(
    fn: Callable[[float], float],
    lo: float,
    hi: float,
    tol: float = 1e-10,
    max_iter: int = 200,
) -> float:
    """Golden-section search for the minimizer of a unimodal ``fn`` on [lo, hi].

    Scalar tolerance-based variant (the batched fixed-iteration form is
    ``golden_section_minimize_arr``)."""
    if not (lo < hi):
        raise ValueError("need lo < hi")
    invphi = (math.sqrt(5.0) - 1.0) / 2.0
    a, b = lo, hi
    c = b - invphi * (b - a)
    d = a + invphi * (b - a)
    fc, fd = fn(c), fn(d)
    for _ in range(max_iter):
        if abs(b - a) < tol * (abs(a) + abs(b) + 1e-30):
            break
        if fc < fd:
            b, d, fd = d, c, fc
            c = b - invphi * (b - a)
            fc = fn(c)
        else:
            a, c, fc = c, d, fd
            d = a + invphi * (b - a)
            fd = fn(d)
    return 0.5 * (a + b)


def numeric_optimal_aspect(
    geom: SystolicArrayGeometry,
    act: BusActivity,
    lo: float = ASPECT_MIN,
    hi: float = ASPECT_MAX,
) -> float:
    """Brute-force (golden-section, in log-space) power-optimal aspect ratio.

    Used by property tests to validate the closed-form Eq. 6. The objective
    P(aspect) = k1 * sqrt(aspect) + k2 / sqrt(aspect) is unimodal in
    log(aspect), so golden-section search is exact up to tolerance.  The
    default search window is the practical envelope — matching the clamped
    closed form (an out-of-envelope optimum converges to the boundary).
    """

    def objective(log_aspect: float) -> float:
        return bus_power(geom, act, math.exp(log_aspect))

    log_opt = golden_section_minimize(objective, math.log(lo), math.log(hi))
    return math.exp(log_opt)


def sweep_aspects(
    geom: SystolicArrayGeometry,
    act: BusActivity,
    aspects: Sequence[float],
) -> list[dict[str, float]]:
    """Evaluate wirelength and bus power across a sweep of aspect ratios."""
    rows = []
    for ar in aspects:
        w, h = pe_dims_from_aspect(geom, ar)
        rows.append(
            {
                "aspect": ar,
                "pe_w_um": w,
                "pe_h_um": h,
                "wl_h_um": wirelength_h(geom, ar),
                "wl_v_um": wirelength_v(geom, ar),
                "wl_total_um": wirelength_total(geom, ar),
                "bus_power_w": bus_power(geom, act, ar),
            }
        )
    return rows
