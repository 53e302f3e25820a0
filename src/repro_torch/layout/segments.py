"""Wire-segment enumeration: every hop, trunk, turnaround and spine bar.

Two renderings of the same physical model, tested against each other:

  * ``enumerate_segments`` — the EXPLICIT path: one row per wire-bundle
    segment, struct-of-arrays (``SegmentList``), with endpoints taken from
    the actual cell placement.  Ground truth for validation, reporting and
    plotting; cost O(R*C) per layout.
  * ``segment_class_coeffs`` — the same totals folded into a FIXED schema
    of segment classes whose lengths are linear in the PE dimensions
    (``len = len_w*W + len_h*H + len_c``).  This is what the batched
    evaluator (``repro_torch.layout.power``) runs on: class counts/coefficients
    broadcast over whole design grids, so (design point x layout family)
    spaces evaluate in one program.

Segment taxonomy (``net`` = which activity prices it, ``kind`` = geometry):

  net ``h``       — operand bus hops along logical rows: the West-edge
                    ``feed``, inter-PE ``hop``s, serpentine ``turn``s
                    (fold-crossing, length R*H) and multi-pod gutter
                    ``trunk`` crossings.  Width ``b_h``, lanes [0, b_h).
  net ``v``       — partial-sum (WS) / W-operand-stream (OS) hops down
                    logical columns plus the bottom-edge ``out`` hop.
                    Width ``b_v`` — except WS multi-pod interior hops,
                    which carry only the pod-local accumulator lanes
                    [0, b_v_pod); gutter crossings are full-width trunks.
  net ``preload`` — WS weight-preload chain (same geometry as ``v`` at
                    width ``b_h``).  Off by default in the power model:
                    the paper's steady-state bus model neglects preload.
  net ``drain``   — OS output-drain chain (same geometry as ``v`` at the
                    OS accumulator width).  Also off by default.
  net ``clk``     — the H-tree clock spine over the array envelope (one
                    tree; multi-pod: per-pod subtrees + a top-level tree
                    over the pod centers), 1-bit segments.

On the uniform family the data nets reduce exactly to the closed form:
R*C ``h`` segments of length W and R*C ``v`` segments of length H — Eq. 1/2
with no residual.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.core.floorplan import pe_dims_arr
from repro_torch.layout.geometry import (
    MultiPodLayout,
    SerpentineLayout,
    clock_tree_coeffs,
    clock_tree_depth,
    envelope,
    envelope_coeffs,
    get_layout,
    htree_segments,
    layout_feasible,
    place_pes,
)

__all__ = [
    "SegmentList",
    "enumerate_segments",
    "segment_class_coeffs",
    "pod_accumulator_bits",
    "os_drain_bits",
    "SEGMENT_CLASS_SCHEMA",
    "DATA_NETS",
]

DATA_NETS = ("h", "v")
OVERHEAD_NETS = ("preload", "drain", "clk")


def _ceil_log2(x) -> np.ndarray:
    x = np.asarray(x, np.int64)
    return np.maximum(np.ceil(np.log2(np.maximum(x, 1) - 0.5)).astype(np.int64), 0)


def pod_accumulator_bits(b_h, b_v, rows, k) -> np.ndarray:
    """Vertical-bus width INSIDE one (rows/k)-deep pod under WS.

    A pod accumulates at most rows/k products of two b_h-bit operands, so
    its partial-sum bus needs 2*b_h + ceil(log2(rows/k)) bits — never more
    than the array-level ``b_v`` (which sizes the full R-deep reduction and
    the inter-pod trunks).  Broadcasts.  (When the power roll-up prices
    these lanes from a measured per-lane profile, the profile describes the
    full R-deep stream — see the fidelity caveat in ``repro_torch.layout.power``.)
    """
    pod_rows = np.maximum(np.asarray(rows, np.int64) // k, 1)
    return np.minimum(
        np.asarray(b_v, np.int64), 2 * np.asarray(b_h, np.int64) + _ceil_log2(pod_rows)
    )


def os_drain_bits(b_h, rows) -> np.ndarray:
    """OS output-drain bus width: the accumulator the drain chain shifts.

    Sized like the WS accumulator of an R-deep reduction (the OS PE holds
    at least one K-chunk of that depth): 2*b_h + ceil(log2 rows).
    """
    return 2 * np.asarray(b_h, np.int64) + _ceil_log2(np.maximum(rows, 2))


@dataclasses.dataclass(frozen=True)
class SegmentList:
    """Struct-of-arrays wire segments (one row per physical bundle segment)."""

    net: np.ndarray  # str: h | v | preload | drain | clk
    kind: np.ndarray  # str: feed | hop | turn | trunk | out | spine
    length: np.ndarray  # um
    width: np.ndarray  # wires in the bundle
    lane0: np.ndarray  # first bus bit-lane carried (lanes [lane0, lane0+width))
    x0: np.ndarray
    y0: np.ndarray
    x1: np.ndarray
    y1: np.ndarray

    @property
    def n_segments(self) -> int:
        return int(self.length.shape[0])

    def select(self, mask) -> "SegmentList":
        return SegmentList(
            *(getattr(self, f.name)[mask] for f in dataclasses.fields(self))
        )

    def for_net(self, net: str) -> "SegmentList":
        return self.select(self.net == net)

    def total_length(self, net: str | None = None) -> float:
        """Sum of segment lengths [um] (bundle routes, not per-wire)."""
        s = self if net is None else self.for_net(net)
        return float(s.length.sum())

    def wire_length(self, net: str | None = None) -> float:
        """Sum of length * width [um of individual wire] — Eq. 1-3's unit."""
        s = self if net is None else self.for_net(net)
        return float((s.length * s.width).sum())


def enumerate_segments(
    layout,
    rows: int,
    cols: int,
    b_h: int,
    b_v: int,
    pe_area_um2: float,
    aspect: float,
    *,
    dataflow: str = "WS",
    nets: Sequence[str] = ("h", "v", "preload", "drain", "clk"),
) -> SegmentList:
    """Enumerate every wire segment of ``layout`` at the given PE aspect.

    Lengths are Manhattan distances between placed cells; ``nets`` filters
    the emitted nets (``preload`` only exists under WS, ``drain`` under OS).
    """
    layout = get_layout(layout)
    if dataflow not in ("WS", "OS"):
        raise ValueError(f"unknown dataflow {dataflow!r}")
    w, h = pe_dims_arr(pe_area_um2, aspect, xp=np)
    w, h = float(w), float(h)
    x, y = place_pes(layout, rows, cols, w, h)

    net_l: list[str] = []
    kind_l: list[str] = []
    rows_of: list[tuple[float, float, float, float, float, int, int]] = []

    def emit(net, kind, x0, y0, x1, y1, width, lane0=0):
        net_l.append(net)
        kind_l.append(kind)
        rows_of.append((abs(x1 - x0) + abs(y1 - y0), x0, y0, x1, y1, width, lane0))

    k = layout.k if isinstance(layout, MultiPodLayout) else 1
    pod_rows = rows // k
    # Pod-local accumulator narrowing is a MULTI-POD property (k >= 2): other
    # families — including the degenerate pods1x1 — carry the caller's b_v on
    # every interior hop (the closed-form contract).
    b_v_in = (
        int(pod_accumulator_bits(b_h, b_v, rows, k))
        if dataflow == "WS" and isinstance(layout, MultiPodLayout) and k > 1
        else b_v
    )
    drain_w = int(os_drain_bits(b_h, rows))

    # Boundary hops are classified by LOGICAL index, not geometric length:
    # a zero-width gutter (or fold) still crosses a pod/band boundary and
    # must carry the boundary width (matches segment_class_coeffs exactly).
    if isinstance(layout, SerpentineLayout):
        h_cross = lambda c: c % (cols // layout.folds) == 0
    elif isinstance(layout, MultiPodLayout):
        h_cross = lambda c: c % (cols // layout.k) == 0
    else:
        h_cross = lambda c: False
    v_cross = (lambda r: r % pod_rows == 0) if k > 1 else (lambda r: False)

    if "h" in nets:
        for r in range(rows):
            emit("h", "feed", x[r, 0] - w, y[r, 0], x[r, 0], y[r, 0], b_h)
            for c in range(1, cols):
                if h_cross(c):
                    kind = "turn" if isinstance(layout, SerpentineLayout) else "trunk"
                else:
                    kind = "hop"
                emit("h", kind, x[r, c - 1], y[r, c - 1], x[r, c], y[r, c], b_h)

    def v_geometry(net: str, width_in: int, width_cross: int):
        for c in range(cols):
            for r in range(1, rows):
                cross = v_cross(r)
                emit(
                    net,
                    "trunk" if cross else "hop",
                    x[r - 1, c],
                    y[r - 1, c],
                    x[r, c],
                    y[r, c],
                    width_cross if cross else width_in,
                )
            # bottom-edge output hop (the R-th hop of Eq. 2's R*C count)
            emit(
                net,
                "out",
                x[rows - 1, c],
                y[rows - 1, c],
                x[rows - 1, c],
                y[rows - 1, c] + h,
                width_cross,
            )

    if "v" in nets:
        v_geometry("v", b_v_in, b_v)
    if "preload" in nets and dataflow == "WS":
        v_geometry("preload", b_h, b_h)
    if "drain" in nets and dataflow == "OS":
        v_geometry("drain", drain_w, drain_w)

    if "clk" in nets:
        we, he = envelope(layout, rows, cols, w, h)
        # k == 1 falls through to the single-tree branch: one pod IS the
        # array, and a top-level tree over one center would add a spurious
        # We/2 bar that breaks pods1x1 == uniform.
        if isinstance(layout, MultiPodLayout) and k > 1:
            top = int(clock_tree_depth(k * k))
            for x0, y0, x1, y1 in htree_segments(we / 2, he / 2, we, he, top):
                emit("clk", "spine", x0, y0, x1, y1, 1)
            pod_cols = cols // k
            pw, ph = pod_cols * w, pod_rows * h
            depth = int(clock_tree_depth(pod_rows * pod_cols))
            for pr in range(k):
                for pc in range(k):
                    cx = pc * (pw + layout.gutter_um) + pw / 2
                    cy = pr * (ph + layout.gutter_um) + ph / 2
                    for x0, y0, x1, y1 in htree_segments(cx, cy, pw, ph, depth):
                        emit("clk", "spine", x0, y0, x1, y1, 1)
        else:
            depth = int(clock_tree_depth(rows * cols))
            for x0, y0, x1, y1 in htree_segments(we / 2, he / 2, we, he, depth):
                emit("clk", "spine", x0, y0, x1, y1, 1)

    arr = np.asarray(rows_of, float).reshape(-1, 7)
    return SegmentList(
        net=np.asarray(net_l),
        kind=np.asarray(kind_l),
        length=arr[:, 0],
        x0=arr[:, 1],
        y0=arr[:, 2],
        x1=arr[:, 3],
        y1=arr[:, 4],
        width=arr[:, 5].astype(np.int64),
        lane0=arr[:, 6].astype(np.int64),
    )


# ---------------------------------------------------------------------------
# Segment-class coefficients (the batched evaluator's fixed schema)
# ---------------------------------------------------------------------------

# (net, slot) per class, in schema order.  Every family fills the same 12
# slots (absent classes get count 0), so grids of mixed families stack into
# one (layouts, classes, points) tensor with no padding logic.
SEGMENT_CLASS_SCHEMA = (
    ("h", "hop"),
    ("h", "cross"),
    ("v", "hop"),
    ("v", "cross"),
    ("v", "out"),
    ("preload", "hop"),
    ("preload", "cross"),
    ("preload", "out"),
    ("drain", "hop"),
    ("drain", "cross"),
    ("drain", "out"),
    ("clk", "spine"),
)


def segment_class_coeffs(layout, rows, cols, b_h, b_v, dataflow_os, *_, **__):
    """Fixed-schema class coefficients for one layout family over (P,) grids.

    Returns a dict of (n_classes, P) float arrays — ``count``, ``len_w``,
    ``len_h``, ``len_c`` (segment length = len_w*W + len_h*H + len_c),
    ``width`` (wires) and ``lane0`` — plus ``feasible`` (P,).  Broadcasting
    the family over the whole grid host-side is what lets the batched
    evaluator treat (point x layout) as one batch axis.  Totals are exact:
    summing ``count * (len, width)`` reproduces ``enumerate_segments`` (the
    parity is tested per family).
    """
    layout = get_layout(layout)
    rows = np.asarray(rows, float)
    cols = np.asarray(cols, float)
    b_h = np.asarray(b_h, float)
    b_v = np.asarray(b_v, float)
    os_mask = np.asarray(dataflow_os, bool)
    p = np.broadcast_shapes(rows.shape, cols.shape, b_h.shape, b_v.shape, os_mask.shape)
    rows, cols, b_h, b_v = (np.broadcast_to(a, p).astype(float) for a in (rows, cols, b_h, b_v))
    os_mask = np.broadcast_to(os_mask, p)
    ws = (~os_mask).astype(float)
    osf = os_mask.astype(float)

    n_cls = len(SEGMENT_CLASS_SCHEMA)
    z = np.zeros((n_cls,) + p)
    out = {k: z.copy() for k in ("count", "len_w", "len_h", "len_c", "width", "lane0")}

    if isinstance(layout, SerpentineLayout):
        nx_h, nx_v, g = float(layout.folds), 1.0, 0.0
    elif isinstance(layout, MultiPodLayout):
        nx_h = nx_v = float(layout.k)
        g = layout.gutter_um if layout.k > 1 else 0.0  # k=1: no gutters exist
    else:
        nx_h = nx_v = 1.0
        g = 0.0

    if isinstance(layout, MultiPodLayout) and layout.k > 1:
        b_v_in = np.where(
            os_mask, b_v, pod_accumulator_bits(b_h, b_v, rows, layout.k).astype(float)
        )
    else:
        b_v_in = b_v
    drain_w = os_drain_bits(b_h, rows).astype(float)

    def put(i, count, lw, lh, lc, width, lane0=0.0):
        out["count"][i] = count
        out["len_w"][i] = lw + 0 * count
        out["len_h"][i] = lh + 0 * count
        out["len_c"][i] = lc + 0 * count
        out["width"][i] = width + 0 * count
        out["lane0"][i] = lane0 + 0 * count

    # h: feed + in-row hops (length W) and the family's cross segments.
    put(0, rows * cols - rows * (nx_h - 1), 1.0, 0.0, 0.0, b_h)
    if isinstance(layout, SerpentineLayout):
        put(1, rows * (nx_h - 1), 0.0, rows, 0.0, b_h)  # turnaround: R*H
    elif isinstance(layout, MultiPodLayout) and layout.k > 1:
        put(1, rows * (nx_h - 1), 1.0, 0.0, g, b_h)  # gutter crossing: W+g

    # v geometry (shared by v / preload / drain): per column, (R - nx_v)
    # interior hops of length H, (nx_v - 1) crossings of length H+g, and one
    # bottom-edge out hop of length H.
    def v_classes(base, width_in, width_cross, gate):
        put(base + 0, gate * cols * (rows - nx_v), 0.0, 1.0, 0.0, width_in)
        put(base + 1, gate * cols * (nx_v - 1), 0.0, 1.0, g, width_cross)
        put(base + 2, gate * cols, 0.0, 1.0, 0.0, width_cross)

    v_classes(2, b_v_in, b_v, 1.0)
    v_classes(5, b_h, b_h, ws)
    v_classes(8, drain_w, drain_w, osf)

    # clk: one class whose "length" is the whole spine.
    ew_w, ew_c, eh_h, eh_c = envelope_coeffs(layout, rows, cols)
    # k == 1: no top-level tree — the single "pod" subtree is the whole
    # array's H-tree, making pods1x1 coefficient-identical to uniform.
    if isinstance(layout, MultiPodLayout) and layout.k > 1:
        kk = layout.k
        cw_t, ch_t = clock_tree_coeffs(np.full(p, int(clock_tree_depth(kk * kk))))
        pod_leaves = np.maximum((rows // kk) * (cols // kk), 1).astype(np.int64)
        cw_p, ch_p = clock_tree_coeffs(clock_tree_depth(pod_leaves))
        lw = cw_t * ew_w + kk * kk * cw_p * (cols / kk)
        lh = ch_t * eh_h + kk * kk * ch_p * (rows / kk)
        lc = cw_t * ew_c + ch_t * eh_c
    else:
        cw, ch = clock_tree_coeffs(clock_tree_depth((rows * cols).astype(np.int64)))
        lw = cw * ew_w
        lh = ch * eh_h
        lc = cw * ew_c + ch * eh_c
    put(11, np.ones(p), lw, lh, lc, 1.0)

    out["feasible"] = np.asarray(layout_feasible(layout, rows.astype(int), cols.astype(int)))
    return out
