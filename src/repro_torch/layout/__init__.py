"""Segment-level physical layout engine.

Where ``repro_torch.core.floorplan`` collapses a floorplan to the paper's
closed-form wirelength model (Eq. 1-6: one aspect scalar, aggregate
activities), this package places every PE cell, enumerates every wire
segment, and rolls interconnect energy up from measured per-bit-lane
switching:

  * ``geometry``  — PE cell dimensions, grid placement, envelopes, and the
    ``LAYOUTS`` registry of floorplan families (uniform rectangle,
    serpentine/folded, k x k multi-pod tilings with inter-pod trunk wires).
  * ``segments``  — struct-of-arrays wire-segment enumeration (h-bus hops,
    v-bus hops + trunks, weight-preload path, OS output-drain path, H-tree
    clock spine) with per-segment length, bit width and lane range, plus
    the fixed-schema segment-class coefficients the batched evaluator runs
    on.
  * ``coeffs``    — the memoized lowering of families over a grid into
    float64 host tables, copied once to each torch device that asks.
  * ``power``     — per-lane x per-segment switched-capacitance roll-up
    (consuming measured ``ActivityProfile``s), repeater-aware length
    scaling, and the batched layout-space evaluator (a float64 program on
    the card by default) wired into ``repro_torch.core.design_space`` as the
    layout-family axis.

On the uniform-rectangle family the segment model reduces exactly to
``wirelength_total_arr`` / ``bus_power_arr`` and its argmin to the
envelope-clamped Eq. 6 optimum (tested); serpentine and multi-pod families
express floorplans the closed form cannot.
"""

from repro_torch.layout.geometry import (  # noqa: F401
    LAYOUTS,
    MultiPodLayout,
    SerpentineLayout,
    UniformLayout,
    envelope,
    get_layout,
    layout_feasible,
    place_pes,
    pod_layouts,
    register_layout,
)
from repro_torch.layout.segments import (  # noqa: F401
    SegmentList,
    enumerate_segments,
    segment_class_coeffs,
)
from repro_torch.layout.coeffs import (  # noqa: F401
    CODING_SCHEMES,
    LoweredCoeffs,
    LoweredTensors,
    clear_coeff_cache,
    coeff_cache_info,
    grid_coding_effective,
    lower_coding_multipliers,
    lower_layout_coeffs,
    lower_partition_coeffs,
    set_coeff_cache_capacity,
)
from repro_torch.layout.power import (  # noqa: F401
    LayoutPowerConfig,
    LayoutSpaceEval,
    ObjectiveSpec,
    evaluate_layout_space,
    rollup_segments,
    segment_bus_power,
    segment_wirelength,
)
