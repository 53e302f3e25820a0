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

It also builds ``src/repro_torch/data/serving_reference.json``: the JAX
package's serving co-design ``codesign("mixtral_8x7b", "decode_heavy")``
(``SERVING``: the default design space, layout families and profiling
clip) on the CPU, with its batched Pallas path (interpret mode) for the
activities and its float64 ``use_jit=False`` path for the objective.  It
records the job set, the measured (GEMM, point) activities and the
scheduler's statistics, the objective's ``j_per_mac``, ``j_per_mac_robust``
and ``j_per_token_robust``, and the best and per-regime cells.

    PYTHONPATH=src python tests/_torch_reference.py    # rewrites both files

And it builds ``src/repro_torch/data/models_reference.json``: for each
of the ten reduced architectures (``get_arch(arch).reduced()``, MoE
capacity raised to E so that no token drops, as the reference's
``tests/test_decode_consistency.py`` does), the JAX package's float32
last-position logits for parameters from the port's seeded numpy recipe
(``repro_torch.models.model.seeded_numpy_params``, seed ``MODELS["seed"]``)
and seeded tokens (recorded in the file): ``forward`` and token-by-token
``decode_step`` at B = 2, S = 12, and ``forward`` at B = 1, S = 128, past
the reduced ``attn_chunk`` (64), so that the blockwise path and the
chunked Mamba and mLSTM scans run.  Logits are stored as base64 float32.

``tests/test_torch_paper_validation.py``, ``tests/test_torch_serving.py``
and ``tests/test_torch_models.py`` rebuild them and compare each with the
committed file.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

DATA = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "data"
REFERENCE_PATH = DATA / "table1_reference.json"
SERVING_REFERENCE_PATH = DATA / "serving_reference.json"
MODELS_REFERENCE_PATH = DATA / "models_reference.json"
MODELS = {"seed": 0, "batch": 2, "seq": 12, "long_batch": 1, "long_seq": 128}
SERVING = {"arch": "mixtral_8x7b", "traffic": "decode_heavy"}
SERVING_CLIP = (128, 512, 256)  # codesign()'s default profiling clip
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


def build_serving_reference() -> dict:
    """The serving co-design document, computed with the JAX package on the
    CPU.  Infeasible cells' J/op is +inf (JSON ``Infinity``)."""
    import numpy as np

    from repro.configs.registry import get_arch
    from repro.core.objective import evaluate_fleet_objective
    from repro.core.workloads import measured_design_gemm_activities
    from repro.serving import (
        DEFAULT_FAMILIES,
        DEFAULT_SPACE,
        CodesignResult,
        get_preset,
        weighted_gemms,
    )

    # codesign()'s own steps, with the scheduler's statistics kept.
    js = weighted_gemms(get_arch(SERVING["arch"]), get_preset(SERVING["traffic"]))
    grid = DEFAULT_SPACE.expand()
    a_h, a_v, stats = measured_design_gemm_activities(
        grid, js.gemms, densities=js.densities, clip=SERVING_CLIP, backend="pallas",
        use_cache=False, return_stats=True,
    )
    ev = evaluate_fleet_objective(
        grid, a_h, a_v, js.gemms, layouts=DEFAULT_FAMILIES, weights=js.weights,
        use_jit=False, macs_per_token=js.macs_per_token,
    )
    res = CodesignResult(arch=js.arch, traffic=js.traffic, jobset=js, grid=grid, eval=ev,
                         layouts=DEFAULT_FAMILIES)
    space = {key: list(getattr(DEFAULT_SPACE, key)) for key in (
        "rows", "cols", "input_bits", "dataflows", "bus_invert", "pe_area_um2")}
    return {
        **SERVING,
        "space": space,
        "layouts": list(DEFAULT_FAMILIES),
        "clip": list(SERVING_CLIP),
        "jobset": {
            "gemms": [[g.name, g.m, g.k, g.n] for g in js.gemms],
            "weights": js.weights.tolist(),
            "mac_rate": js.mac_rate.tolist(),
            "regimes": list(js.regimes),
            "densities": list(js.densities),
            "tokens_per_s": js.tokens_per_s,
            "macs_per_token": js.macs_per_token,
        },
        "a_h": a_h.tolist(),
        "a_v": a_v.tolist(),
        "batch_stats": {key: getattr(stats, key) for key in BATCH_STATS_FIELDS},
        "j_per_mac": np.asarray(res.eval.j_per_mac).tolist(),
        "j_per_mac_robust": np.asarray(res.eval.j_per_mac_robust).tolist(),
        "j_per_token_robust": np.asarray(res.eval.j_per_token_robust).tolist(),
        "best_cell": list(res.best_cell),
        "regime_cells": {r: list(res.regime_cell(r)) for r in ("decode", "prefill")},
    }


def encode_f32(x) -> dict:
    """A float32 array as JSON: its shape and its little-endian bytes in base64."""
    import base64

    import numpy as np

    a = np.ascontiguousarray(np.asarray(x, dtype="<f4"))
    return {"shape": list(a.shape), "f32_base64": base64.b64encode(a.tobytes()).decode()}


def decode_f32(doc: dict):
    import base64

    import numpy as np

    return np.frombuffer(base64.b64decode(doc["f32_base64"]), dtype="<f4").reshape(doc["shape"])


def models_case(arch: str, cfg) -> dict:
    """The reduced ``cfg`` of ``arch`` as the file records it (MoE capacity
    E: no drops) and its seeded tokens, (B, S) or (B, S, K)."""
    import dataclasses

    import numpy as np

    from repro_torch.configs.registry import ARCH_IDS

    if cfg.num_experts > 1:
        cfg = dataclasses.replace(cfg, capacity_factor=float(cfg.num_experts))
    rng = np.random.default_rng([MODELS["seed"], ARCH_IDS.index(arch)])
    k = (cfg.num_codebooks,) if cfg.num_codebooks > 1 else ()
    tokens = rng.integers(0, cfg.vocab_size, (MODELS["batch"], MODELS["seq"]) + k, dtype=np.int32)
    long_tokens = rng.integers(0, cfg.vocab_size, (MODELS["long_batch"], MODELS["long_seq"]) + k,
                               dtype=np.int32)
    return {"cfg": cfg, "tokens": tokens, "long_tokens": long_tokens}


def build_models_reference() -> dict:
    """The model-stack document, computed with the JAX package on the CPU."""
    import jax
    import jax.numpy as jnp

    from repro.configs.registry import ARCH_IDS, get_arch
    from repro.models import model as RM
    from repro_torch.models.model import seeded_numpy_params

    archs = {}
    for arch in ARCH_IDS:
        case = models_case(arch, get_arch(arch).reduced())
        cfg = case["cfg"]
        params = jax.tree.map(jnp.asarray, seeded_numpy_params(cfg, MODELS["seed"]))
        tokens = jnp.asarray(case["tokens"])
        fwd, _ = RM.forward(cfg, params, tokens)
        cache, _ = RM.init_cache(cfg, tokens.shape[0], tokens.shape[1])
        for t in range(tokens.shape[1]):
            dec, cache = RM.decode_step(cfg, params, cache, tokens[:, t:t + 1], jnp.int32(t))
        long_fwd, _ = RM.forward(cfg, params, jnp.asarray(case["long_tokens"]))
        archs[arch] = {
            "capacity_factor": cfg.capacity_factor,
            "tokens": case["tokens"].tolist(),
            "long_tokens": case["long_tokens"].tolist(),
            "forward": encode_f32(fwd[:, -1]),
            "decode": encode_f32(dec),
            "long_forward": encode_f32(long_fwd[:, -1]),
        }
    return {**MODELS, "archs": archs}


def dumps(doc: dict) -> str:
    return json.dumps(doc, indent=1, sort_keys=True) + "\n"


def dumps_compact(doc: dict) -> str:
    """One top-level key a line (the serving file's arrays are large)."""
    lines = [f" {json.dumps(k)}: {json.dumps(doc[k], sort_keys=True)}" for k in sorted(doc)]
    return "{\n" + ",\n".join(lines) + "\n}\n"


if __name__ == "__main__":
    DATA.mkdir(parents=True, exist_ok=True)
    REFERENCE_PATH.write_text(dumps(build_reference()))
    print(f"wrote {REFERENCE_PATH}")
    SERVING_REFERENCE_PATH.write_text(dumps_compact(build_serving_reference()))
    print(f"wrote {SERVING_REFERENCE_PATH}")
    MODELS_REFERENCE_PATH.write_text(dumps(build_models_reference()))
    print(f"wrote {MODELS_REFERENCE_PATH}")
