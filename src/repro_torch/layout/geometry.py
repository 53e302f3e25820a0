"""PE cell placement and the floorplan-family registry.

A *layout family* maps the logical R x C systolic array onto physical cell
positions.  Families are small frozen dataclasses registered in
``LAYOUTS``; every other layer of the engine (segment enumeration,
coefficient builder, batched evaluator) dispatches on them:

  * ``UniformLayout``    — the paper's rectangle: PE (r, c) at (c*W, r*H).
  * ``SerpentineLayout`` — the column axis folded into ``folds`` vertical
    bands in boustrophedon (snake) order: band b holds logical columns
    [b*C/f, (b+1)*C/f), odd bands mirrored so fold-crossing h hops are
    purely vertical turnarounds of length R*H.  Folding rescales the array
    envelope by 1/f horizontally and f vertically, which is the physical
    point: it realizes extreme PE aspect ratios inside a bounded die
    envelope (ArrayFlex-style configurable arrays).
  * ``MultiPodLayout``   — a k x k tiling of (R/k) x (C/k) pods separated
    by ``gutter_um`` routing gutters (SISA-style scale-in organization).
    Pod-internal vertical buses carry only the pod-local partial-sum width
    under WS; full-width trunk wires cross the gutters.

Placements return CELL ORIGINS on the logical (rows, cols) grid; hop
lengths everywhere are Manhattan distances between placed cells, so
family-specific wiring (turnarounds, gutter crossings) emerges from the
placement rather than special cases.

``envelope_coeffs`` expresses each family's bounding box linearly in the
PE dimensions — ``We = ew_w*W + ew_c``, ``He = eh_h*H + eh_c`` — which is
what the batched evaluator's envelope-aspect constraint and the clock-tree
length closed form consume.
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np

__all__ = [
    "UniformLayout",
    "SerpentineLayout",
    "MultiPodLayout",
    "Layout",
    "LAYOUTS",
    "register_layout",
    "get_layout",
    "pod_layouts",
    "layout_feasible",
    "envelope_coeffs",
    "envelope",
    "place_pes",
    "clock_tree_depth",
    "clock_tree_coeffs",
    "htree_segments",
]

# Deepest H-tree the closed-form length coefficients cover: 2^30 leaves is
# far beyond any realizable PE grid.
MAX_CLOCK_LEVELS = 30

_PODS_RE = re.compile(r"pods(\d+)x(\d+)")
_SERP_RE = re.compile(r"serpentine(\d+)")


@dataclasses.dataclass(frozen=True)
class UniformLayout:
    """The closed-form R x C rectangle (hop lengths W horizontally, H
    vertically) — the family ``repro_torch.core.floorplan`` Eq. 1-6 describe."""


@dataclasses.dataclass(frozen=True)
class SerpentineLayout:
    """Column axis folded into ``folds`` serpentine bands (see module doc)."""

    folds: int = 2

    def __post_init__(self) -> None:
        if self.folds < 2:
            raise ValueError("serpentine needs folds >= 2 (folds=1 is uniform)")


@dataclasses.dataclass(frozen=True)
class MultiPodLayout:
    """k x k pod tiling with ``gutter_um`` inter-pod routing gutters.

    ``k`` is a free integer axis (SISA-style scale-in): ``k=1`` is the
    degenerate single-pod case and reduces EXACTLY to ``UniformLayout``
    (no gutters, no trunk crossings, no top-level clock tree, no pod
    accumulator narrowing) — which is what lets sweeps treat pod count as
    one more grid dimension instead of a special case.
    """

    k: int = 2
    gutter_um: float = 25.0

    def __post_init__(self) -> None:
        if self.k < 1:
            raise ValueError("multi-pod needs k >= 1")
        if self.gutter_um < 0:
            raise ValueError("gutter_um must be non-negative")


Layout = UniformLayout | SerpentineLayout | MultiPodLayout

LAYOUTS: dict[str, Layout] = {
    "uniform": UniformLayout(),
    "serpentine2": SerpentineLayout(folds=2),
    "serpentine4": SerpentineLayout(folds=4),
    "pods2x2": MultiPodLayout(k=2),
    "pods4x4": MultiPodLayout(k=4),
}


def register_layout(name: str, layout: Layout) -> None:
    """Add a (possibly parameterized) family instance to the registry."""
    if not isinstance(layout, (UniformLayout, SerpentineLayout, MultiPodLayout)):
        raise TypeError(f"unknown layout family {type(layout).__name__}")
    LAYOUTS[name] = layout


def get_layout(name_or_layout) -> Layout:
    """Resolve a layout instance, registered name, or PARAMETRIC name.

    Beyond the ``LAYOUTS`` registry, two parametric spellings resolve
    without registration — they are what promotes the family parameter to
    a free sweep axis:

      * ``"pods{k}x{k}"``   -> ``MultiPodLayout(k=k)``      (k >= 1)
      * ``"serpentine{f}"`` -> ``SerpentineLayout(folds=f)``(f >= 2)

    Registered names win over parsing (so ``register_layout`` can pin a
    non-default ``gutter_um`` under a parametric-looking name).
    """
    if isinstance(name_or_layout, (UniformLayout, SerpentineLayout, MultiPodLayout)):
        return name_or_layout
    try:
        return LAYOUTS[name_or_layout]
    except (KeyError, TypeError):
        pass
    if isinstance(name_or_layout, str):
        m = _PODS_RE.fullmatch(name_or_layout)
        if m and m.group(1) == m.group(2):
            return MultiPodLayout(k=int(m.group(1)))
        m = _SERP_RE.fullmatch(name_or_layout)
        if m:
            return SerpentineLayout(folds=int(m.group(1)))
    raise KeyError(
        f"unknown layout {name_or_layout!r}; registered: {sorted(LAYOUTS)}, "
        "parametric: 'pods{k}x{k}', 'serpentine{f}'"
    )


def pod_layouts(ks) -> tuple[str, ...]:
    """Layout names for a free pod-count axis: ``pod_layouts((1, 2, 4))``
    -> ``("pods1x1", "pods2x2", "pods4x4")`` — every name resolves through
    ``get_layout`` without registration (``pods1x1`` == uniform)."""
    return tuple(f"pods{int(k)}x{int(k)}" for k in ks)


def layout_feasible(layout: Layout, rows, cols):
    """Elementwise feasibility of the family on (rows, cols) grids.

    Serpentine needs the column count divisible by the fold count;
    multi-pod needs both axes divisible by k (ragged pods would break the
    trunk accounting).  Broadcasts over array inputs.
    """
    rows = np.asarray(rows)
    cols = np.asarray(cols)
    if isinstance(layout, SerpentineLayout):
        return (cols % layout.folds == 0) & (cols >= layout.folds)
    if isinstance(layout, MultiPodLayout):
        return (rows % layout.k == 0) & (cols % layout.k == 0) & (rows >= layout.k) & (
            cols >= layout.k
        )
    return np.broadcast_to(True, np.broadcast_shapes(rows.shape, cols.shape)).copy()


def envelope_coeffs(layout: Layout, rows, cols):
    """Linear envelope model: ``(ew_w, ew_c, eh_h, eh_c)`` with
    ``We = ew_w*W + ew_c`` and ``He = eh_h*H + eh_c``.  Broadcasts."""
    rows = np.asarray(rows, float)
    cols = np.asarray(cols, float)
    zero = np.zeros(np.broadcast_shapes(rows.shape, cols.shape))
    if isinstance(layout, SerpentineLayout):
        return cols / layout.folds + zero, zero, layout.folds * rows + zero, zero
    if isinstance(layout, MultiPodLayout):
        g = (layout.k - 1) * layout.gutter_um
        return cols + zero, zero + g, rows + zero, zero + g
    return cols + zero, zero, rows + zero, zero


def envelope(layout: Layout, rows: int, cols: int, w_um: float, h_um: float):
    """(We, He) bounding box of the placed array, in um."""
    ew_w, ew_c, eh_h, eh_c = envelope_coeffs(layout, rows, cols)
    return float(ew_w * w_um + ew_c), float(eh_h * h_um + eh_c)


def place_pes(
    layout: Layout, rows: int, cols: int, w_um: float, h_um: float
) -> tuple[np.ndarray, np.ndarray]:
    """Cell origins ``(x, y)`` of every logical PE, each shaped (rows, cols).

    x grows East, y grows South (row 0 at the top edge, where the WS weight
    preload and the partial-sum chains enter).
    """
    if not layout_feasible(layout, rows, cols):
        raise ValueError(f"{layout} infeasible on a {rows}x{cols} grid")
    r = np.arange(rows)[:, None]
    c = np.arange(cols)[None, :]
    if isinstance(layout, SerpentineLayout):
        band_cols = cols // layout.folds
        band = c // band_cols
        cpos = np.where(band % 2 == 0, c % band_cols, band_cols - 1 - (c % band_cols))
        x = cpos * w_um + 0 * r
        y = (band * rows + r) * h_um
        return x.astype(float), y.astype(float)
    if isinstance(layout, MultiPodLayout):
        g = layout.gutter_um
        x = c * w_um + (c // (cols // layout.k)) * g + 0 * r
        y = r * h_um + (r // (rows // layout.k)) * g + 0 * c
        return x.astype(float), y.astype(float)
    return (c * w_um + 0 * r).astype(float), (r * h_um + 0 * c).astype(float)


# ---------------------------------------------------------------------------
# H-tree clock spine
# ---------------------------------------------------------------------------


def clock_tree_depth(n_leaves) -> np.ndarray:
    """H-tree depth serving ``n_leaves`` sinks: ceil(log2 n), at least 1."""
    n = np.asarray(n_leaves, np.int64)
    return np.maximum(np.ceil(np.log2(np.maximum(n, 2) - 0.5)).astype(np.int64), 1)


def clock_tree_coeffs(depth):
    """Closed-form H-tree length: total = cw*We + ch*He for a ``depth``-level
    tree in a (We, He) box.

    Levels alternate horizontal/vertical starting horizontal; level L draws
    2^(L-1) bars of length We/2^ceil(L/2) (odd L) or He/2^(L/2) (even L) —
    exactly what ``htree_segments`` enumerates.  Broadcasts over ``depth``
    arrays (the batched evaluator feeds per-point depths).
    """
    depth = np.asarray(depth, np.int64)
    cw = np.zeros(depth.shape, float)
    ch = np.zeros(depth.shape, float)
    for lvl in range(1, MAX_CLOCK_LEVELS + 1):
        on = depth >= lvl
        if not on.any():
            break
        if lvl % 2:
            cw += np.where(on, 2.0 ** (lvl - 1) / 2.0 ** ((lvl + 1) // 2), 0.0)
        else:
            ch += np.where(on, 2.0 ** (lvl - 1) / 2.0 ** (lvl // 2), 0.0)
    return cw, ch


def htree_segments(
    cx: float, cy: float, we: float, he: float, depth: int
) -> list[tuple[float, float, float, float]]:
    """Explicit H-tree bars ``(x0, y0, x1, y1)`` for a ``depth``-level tree
    centered at (cx, cy) in a (we, he) box.  2^depth - 1 segments; total
    length equals ``clock_tree_coeffs(depth) . (we, he)`` exactly."""
    segs: list[tuple[float, float, float, float]] = []
    pts = [(cx, cy)]
    for lvl in range(1, depth + 1):
        nxt = []
        if lvl % 2:
            ln = we / 2.0 ** ((lvl + 1) // 2)
            for px, py in pts:
                segs.append((px - ln / 2, py, px + ln / 2, py))
                nxt += [(px - ln / 2, py), (px + ln / 2, py)]
        else:
            ln = he / 2.0 ** (lvl // 2)
            for px, py in pts:
                segs.append((px, py - ln / 2, px, py + ln / 2))
                nxt += [(px, py - ln / 2), (px, py + ln / 2)]
        pts = nxt
    return segs
