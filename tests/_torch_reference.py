"""Build ``src/repro_torch/data/table1_reference.json`` with the JAX package.

The port's chip check (``chip_smoke.py``) holds its Table-I profiles and its
floorplan verdict against this file.  It records, for each ResNet50 Table-I
layer (seed i for layer i) and each dataflow on the paper's 32x32 array with
int16 operands:

  * the four ``ToggleCounts`` integers of
    ``repro.kernels.activity_profile.ops.profile_gemm_toggles(engine="xla")``;
  * the reference's ``ActivityProfile`` fields, from its batched
    ``profile_network`` and held against those counts;

and, per dataflow:

  * the verdict: ``combine_profiles`` -> ``optimal_aspect_power`` ->
    ``compare_sym_asym`` per layer -> ``average_comparison``, on the paper's
    geometry for WS and ``os_dataflow_geometry(16, 32, 32)`` for OS;
  * what the batched scheduler did for the whole network: the
    ``BatchStats`` fields of ``profile_network(..., return_stats=True)``
    that describe its shape classes and passes (``BATCH_STATS_FIELDS``);

and, for the design-space example grid (``DESIGN_SPACE``, 40 points over
the first three Table-I layers), the (layer, point) activities of
``measured_design_activities`` and the same ``BatchStats`` fields.

    PYTHONPATH=src python tests/_torch_reference.py    # rewrites the file

``tests/test_torch_paper_validation.py`` rebuilds it and asserts that it
equals the committed file.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

REFERENCE_PATH = (
    Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "data" / "table1_reference.json"
)
ROWS = COLS = 32
BITS = 16
BATCH_STATS_FIELDS = (
    "jobs", "passes", "pass_reuse", "buckets", "tasks", "strips", "serial_fallbacks",
)
DESIGN_SPACE = {
    "rows": [16, 32],
    "cols": [8, 16, 32, 64, 128],
    "input_bits": [16],
    "dataflows": ["WS", "OS"],
    "bus_invert": [False, True],
}
DESIGN_SPACE_LAYERS = 3


def _verdict(geom, profiles) -> dict:
    from repro.core.energy import average_comparison, compare_sym_asym
    from repro.core.floorplan import optimal_aspect_power
    from repro.core.switching import combine_profiles

    avg = combine_profiles(profiles)
    design = avg.as_bus_activity()
    comps = [compare_sym_asym(geom, p.as_bus_activity(), design_act=design) for p in profiles]
    return {
        "b_h": geom.b_h,
        "b_v": geom.b_v,
        "average_profile": dataclasses.asdict(avg),
        "aspect_opt": optimal_aspect_power(geom, design),
        "per_layer": [
            {
                "aspect_opt": c.aspect_opt,
                "bus_saving": c.bus_saving,
                "interconnect_saving": c.interconnect_saving,
                "total_saving": c.total_saving,
            }
            for c in comps
        ],
        "average": average_comparison(comps),
    }


def build_reference() -> dict:
    """The reference document, computed with the JAX package on the CPU."""
    from repro.core.floorplan import SystolicArrayGeometry
    from repro.core.optimize import os_dataflow_geometry
    from repro.core.quant import quantize_symmetric
    from repro.core.workloads import (
        RESNET50_TABLE1,
        _default_b_v,
        conv_to_gemm,
        profile_network,
        synth_activations,
        synth_weights,
    )
    from repro.kernels.activity_profile.ops import profile_gemm_toggles

    # The batched network's profiles are the per-layer profiles: each is
    # held below against the counts of the reference's per-GEMM path.
    profiles, batch_stats = {}, {}
    for dataflow in ("WS", "OS"):
        profiles[dataflow], stats = profile_network(
            RESNET50_TABLE1, ROWS, COLS, BITS, dataflow=dataflow, backend="pallas",
            use_cache=False, return_stats=True,
        )
        batch_stats[dataflow] = {key: getattr(stats, key) for key in BATCH_STATS_FIELDS}
    layers = []
    for seed, layer in enumerate(RESNET50_TABLE1):
        g = conv_to_gemm(layer)
        a = quantize_symmetric(synth_activations(g.m, g.k, layer.input_density, seed=seed), BITS).values
        w = quantize_symmetric(synth_weights(g.k, g.n, seed=seed + 1), BITS).values
        entry = {"name": layer.name, "seed": seed, "gemm": [g.m, g.k, g.n]}
        for dataflow in ("WS", "OS"):
            b_v = _default_b_v(BITS, ROWS, dataflow)
            t = profile_gemm_toggles(
                a, w, ROWS, COLS, BITS, b_v, dataflow=dataflow, engine="xla"
            )
            p = profiles[dataflow][seed]
            if (p.a_h, p.a_v) != t.activities(BITS, b_v) or (
                p.h_transitions, p.v_transitions
            ) != (t.h_transitions, t.v_transitions):
                raise AssertionError(f"{layer.name} {dataflow}: profile and counts disagree")
            entry[dataflow] = {
                "b_v": b_v,
                "counts": [t.h_toggles, t.v_toggles, t.h_transitions, t.v_transitions],
                "profile": dataclasses.asdict(p),
            }
        layers.append(entry)
    from repro.core.design_space import DesignSpace
    from repro.core.workloads import measured_design_activities

    a_h, a_v, stats = measured_design_activities(
        DesignSpace(**DESIGN_SPACE).expand(), RESNET50_TABLE1[:DESIGN_SPACE_LAYERS],
        backend="pallas", use_cache=False, return_stats=True,
    )
    return {
        "rows": ROWS,
        "cols": COLS,
        "bits": BITS,
        "layers": layers,
        "batch_stats": batch_stats,
        "design_space": {
            "axes": DESIGN_SPACE,
            "layers": DESIGN_SPACE_LAYERS,
            "a_h": a_h.tolist(),
            "a_v": a_v.tolist(),
            "batch_stats": {key: getattr(stats, key) for key in BATCH_STATS_FIELDS},
        },
        "verdict": {
            "WS": _verdict(SystolicArrayGeometry.paper_32x32(), profiles["WS"]),
            "OS": _verdict(os_dataflow_geometry(BITS, ROWS, COLS), profiles["OS"]),
        },
    }


def dumps(doc: dict) -> str:
    return json.dumps(doc, indent=1, sort_keys=True) + "\n"


if __name__ == "__main__":
    REFERENCE_PATH.parent.mkdir(parents=True, exist_ok=True)
    REFERENCE_PATH.write_text(dumps(build_reference()))
    print(f"wrote {REFERENCE_PATH}")
