"""Core: the paper's contribution (asymmetric SA floorplanning + energy
model), the switching-activity profiler that feeds it, and the design-space
engine that explores it.

Exports what the reference's ``core`` exports, except its deprecated
``profile_ws_*`` aliases, and the sweep runner's and the fleet objective's
entry points.
"""

from repro_torch.core.floorplan import (  # noqa: F401
    BusActivity,
    SystolicArrayGeometry,
    accumulator_width,
    bus_power,
    bus_power_ratio_vs_square,
    numeric_optimal_aspect,
    optimal_aspect_power,
    optimal_aspect_wirelength,
    wirelength_total,
)
from repro_torch.core.energy import (  # noqa: F401
    EnergyModelConfig,
    average_comparison,
    compare_sym_asym,
    power_breakdown,
)
from repro_torch.core.design_space import (  # noqa: F401
    DesignGrid,
    DesignSpace,
    DesignSpaceEval,
    evaluate_design_space,
    evaluate_layout_design_space,
    pareto_mask,
    sweep_bus_power,
)
from repro_torch.core.switching import (  # noqa: F401
    ActivityProfile,
    clear_profile_cache,
    combine_profiles,
    profile_cache_info,
    profile_gemm,
    profile_gemms,
    profile_tile,
    stream_toggle_rate,
)
from repro_torch.core.sweep import (  # noqa: F401
    SweepConfig,
    SweepInterrupted,
    SweepReport,
)
from repro_torch.core.objective import (  # noqa: F401
    evaluate_fleet_objective,
    fleet_static_power,
)
from repro_torch.core.systolic import (  # noqa: F401
    DATAFLOWS,
    Dataflow,
    matmul_reference,
    os_matmul_reference,
    schedule_gemm,
    ws_matmul_reference,
)
