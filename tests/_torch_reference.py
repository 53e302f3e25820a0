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

And it builds ``src/repro_torch/data/train_reference.json``: for each of
the ten reduced architectures (MoE capacity E, as above), the JAX
package's training in float32 from the same seeded parameters, with
batches from its ``data.pipeline.batch_at_step`` (tokens and labels; the
model makes its own positions) and ``AdamWConfig()``: the reference's
train step as ``launch.steps.make_train_step`` composes it
(``jax.value_and_grad(models.model.loss_fn)``, then
``optim.adamw.apply_updates``), ``TRAIN["steps"]`` steps at B = 2,
S = 32, each step's ``loss``, ``ce``, ``aux``, ``grad_norm`` and ``lr``,
and each gradient leaf's L2 norm at the first step; and one step at
S = 128 (blockwise attention above the reduced ``attn_chunk`` of 64, and
several Mamba and xLSTM scan chunks) with the same numbers.  No raw
gradient is stored.  Each step's token stream (B, S + 1[, K]) is
recorded: tokens are its first S positions, labels its last S.  The
pipeline draws them with numpy's Zipf sampler, whose stream another numpy
version may change, so the card is held to the file's tokens.

``tests/test_torch_paper_validation.py``, ``tests/test_torch_serving.py``,
``tests/test_torch_models.py`` and ``tests/test_torch_training*.py``
rebuild them and compare each with the committed file.
"""

from __future__ import annotations

import dataclasses
import functools
import json
from pathlib import Path

DATA = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "data"
REFERENCE_PATH = DATA / "table1_reference.json"
SERVING_REFERENCE_PATH = DATA / "serving_reference.json"
MODELS_REFERENCE_PATH = DATA / "models_reference.json"
TRAIN_REFERENCE_PATH = DATA / "train_reference.json"
MODELS = {"seed": 0, "batch": 2, "seq": 12, "long_batch": 1, "long_seq": 128}
TRAIN = {"seed": 0, "batch": 2, "seq": 32, "steps": 3, "long_seq": 128}
TRAIN_METRICS = ("loss", "ce", "aux", "grad_norm", "lr")
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
    from repro_torch.configs.registry import get_arch as port_arch
    from repro_torch.models.model import seeded_numpy_params

    archs = {}
    for arch in ARCH_IDS:
        case = models_case(arch, get_arch(arch).reduced())
        cfg = case["cfg"]
        # drawn over the port's shapes, which the port's config gives
        port_cfg = models_case(arch, port_arch(arch).reduced())["cfg"]
        params = jax.tree.map(jnp.asarray, seeded_numpy_params(port_cfg, MODELS["seed"]))
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


def train_cfg(cfg):
    """The reduced ``cfg`` as the training file records it: MoE capacity E
    (no token drops, so the loss is smooth in the parameters)."""
    if cfg.num_experts > 1:
        cfg = dataclasses.replace(cfg, capacity_factor=float(cfg.num_experts))
    return cfg


def train_batches(cfg, seq: int, steps: int) -> list[dict]:
    """Tokens and labels of the reference's ``batch_at_step`` at steps
    0 .. ``steps`` - 1 (numpy int32)."""
    from repro.data.pipeline import DataConfig, batch_at_step

    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=TRAIN["batch"],
                      num_codebooks=cfg.num_codebooks, seed=TRAIN["seed"])
    return [{k: v for k, v in batch_at_step(data, step).items() if k != "positions"}
            for step in range(steps)]


def batch_stream(batch: dict) -> list:
    """A batch's token stream (B, S + 1[, K]) as nested lists."""
    import numpy as np

    return np.concatenate([batch["tokens"], batch["labels"][:, -1:]], axis=1).tolist()


def stream_batch(stream) -> dict:
    """The tokens and labels (numpy int32) of a recorded stream."""
    import numpy as np

    s = np.asarray(stream, dtype=np.int32)
    return {"tokens": s[:, :-1], "labels": s[:, 1:]}


def flat_keys(tree, prefix: str = "") -> dict:
    """A nested dict's leaves by their ``/``-joined key path."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(flat_keys(value, f"{prefix}{key}/"))
        else:
            out[prefix + key] = value
    return out


@functools.lru_cache(maxsize=None)
def reference_train_run(arch: str, seq: int, steps: int) -> dict:
    """The JAX package's training of the reduced ``arch`` (``train_cfg``)
    from ``seeded_numpy_params``: per step the metrics (floats), and as
    numpy the first step's loss gradient and the parameters after the last
    step.  Cached: the training tests and the file share one run."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from repro.configs.registry import get_arch
    from repro.models import model as RM
    from repro.optim import adamw
    from repro_torch.configs.registry import get_arch as port_arch
    from repro_torch.models.model import seeded_numpy_params

    cfg = train_cfg(get_arch(arch).reduced())
    opt_cfg = adamw.AdamWConfig()
    params = jax.tree.map(jnp.asarray,
                          seeded_numpy_params(train_cfg(port_arch(arch).reduced()), TRAIN["seed"]))
    opt_state = adamw.init_state(opt_cfg, params)
    value_and_grad = jax.jit(lambda p, b: jax.value_and_grad(
        lambda q: RM.loss_fn(cfg, q, b), has_aux=True)(p))
    update = jax.jit(lambda p, o, g: adamw.apply_updates(opt_cfg, p, o, g))
    metrics, first_grads = [], None
    for batch in train_batches(cfg, seq, steps):
        (loss, aux), grads = value_and_grad(params, jax.tree.map(jnp.asarray, batch))
        params, opt_state, om = update(params, opt_state, grads)
        if first_grads is None:
            first_grads = {k: np.asarray(g) for k, g in flat_keys(grads).items()}
        metrics.append({"loss": float(loss), "ce": float(aux["ce"]), "aux": float(aux["aux"]),
                        "grad_norm": float(om["grad_norm"]), "lr": float(om["lr"])})
    return {"cfg": cfg, "metrics": metrics, "grads": first_grads,
            "params": {k: np.asarray(v) for k, v in flat_keys(params).items()}}


def grad_norms(grads: dict) -> dict:
    import numpy as np

    return {k: float(np.linalg.norm(np.asarray(g, dtype=np.float64))) for k, g in grads.items()}


def port_loss_and_grads(cfg, seed: int, batch: dict) -> tuple[dict, dict]:
    """The port's ``loss_fn`` on ``seeded_numpy_params(cfg, seed)`` and the
    numpy ``batch``, on the CPU: ({"loss", "ce", "aux"} floats, gradient
    leaves by key as numpy)."""
    import torch

    from repro_torch.models import model as TM

    params = TM.from_reference_params(cfg, TM.seeded_numpy_params(cfg, seed)).stage(None)
    flat = flat_keys(params)
    loss, metrics = TM.loss_fn(cfg, params, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, list(flat.values()))
    values = {"loss": loss.item(), "ce": metrics["ce"].item(), "aux": metrics["aux"].item()}
    return values, {k: g.numpy() for k, g in zip(flat, grads)}


def build_train_reference(part: str | None = None) -> dict:
    """The training document, computed with the JAX package on the CPU;
    ``part`` "steps" or "long" builds only that half of each arch's
    entry."""
    from repro.configs.registry import ARCH_IDS

    archs = {}
    for arch in ARCH_IDS:
        entry = {}
        if part in (None, "steps"):
            run = reference_train_run(arch, TRAIN["seq"], TRAIN["steps"])
            entry["capacity_factor"] = run["cfg"].capacity_factor
            entry["steps"] = run["metrics"]
            entry["grad_norms"] = grad_norms(run["grads"])
            entry["streams"] = [batch_stream(b) for b in train_batches(
                run["cfg"], TRAIN["seq"], TRAIN["steps"])]
        if part in (None, "long"):
            run = reference_train_run(arch, TRAIN["long_seq"], 1)
            entry["long"] = {**run["metrics"][0], "grad_norms": grad_norms(run["grads"]),
                             "stream": batch_stream(train_batches(run["cfg"], TRAIN["long_seq"], 1)[0])}
        archs[arch] = entry
    return {**TRAIN, "archs": archs}


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
    TRAIN_REFERENCE_PATH.write_text(dumps(build_train_reference()))
    print(f"wrote {TRAIN_REFERENCE_PATH}")
