"""The paper's workload: the six ResNet50 conv layers of Table I.

Each layer is lowered conv -> im2col GEMM, with synthetic post-ReLU
activations (density matched to typical ResNet50 layer sparsity) and
zero-mean weights, quantized to int16 exactly as in Section IV.  Operand
synthesis stays on numpy's ``default_rng`` with the reference package's
seeds, so both packages profile byte-identical operands.

``profile_network`` runs all layers through the batched pipeline
(``repro_torch.core.pipeline``) as lazy ``conv_layer_job``s.  The
``measured_design_*`` adapters map a design grid's activity classes onto
profiles, and the pod-partition model maps GEMMs onto k x k podded arrays.
``gemms_for_arch`` extracts one transformer layer's GEMMs from an
architecture config (``repro_torch.configs``).
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Sequence

import numpy as np

from repro_torch.core.quant import quantize_symmetric
from repro_torch.core.switching import ActivityProfile, profile_gemm

__all__ = [
    "ConvLayer",
    "Gemm",
    "PodPartition",
    "RESNET50_TABLE1",
    "conv_to_gemm",
    "synth_activations",
    "synth_weights",
    "profile_conv_layer",
    "conv_layer_job",
    "gemm_job",
    "profile_network",
    "measured_design_activities",
    "measured_design_gemm_activities",
    "gemm_profile_seed",
    "measured_design_lane_activities",
    "partition_gemm",
    "design_pod_partition",
    "gemms_for_arch",
    "total_macs",
]


@dataclasses.dataclass(frozen=True)
class ConvLayer:
    """A conv layer in the paper's Table I notation."""

    name: str
    k: int  # kernel size
    h: int  # output height
    w: int  # output width
    c: int  # input channels
    m: int  # output channels
    input_density: float = 0.5  # fraction of non-zero (post-ReLU) inputs


@dataclasses.dataclass(frozen=True)
class Gemm:
    name: str
    m: int
    k: int
    n: int

    @property
    def macs(self) -> int:
        return self.m * self.k * self.n


# Table I of the paper. Input densities: ResNet50 post-ReLU activation
# densities are layer-dependent (~0.4-0.7 early, sparser deep); values below
# are representative of published ResNet50 activation-sparsity profiles and
# give layer-to-layer a_h variation like the paper describes.
RESNET50_TABLE1: tuple[ConvLayer, ...] = (
    ConvLayer("L1", k=1, h=56, w=56, c=256, m=64, input_density=0.55),
    ConvLayer("L2", k=3, h=28, w=28, c=128, m=128, input_density=0.50),
    ConvLayer("L3", k=1, h=28, w=28, c=128, m=512, input_density=0.45),
    ConvLayer("L4", k=1, h=14, w=14, c=512, m=256, input_density=0.40),
    ConvLayer("L5", k=1, h=14, w=14, c=1024, m=256, input_density=0.35),
    ConvLayer("L6", k=3, h=14, w=14, c=256, m=256, input_density=0.40),
)


def conv_to_gemm(layer: ConvLayer) -> Gemm:
    """im2col lowering: M = H*W output pixels, K = k*k*C, N = output channels."""
    return Gemm(
        name=layer.name,
        m=layer.h * layer.w,
        k=layer.k * layer.k * layer.c,
        n=layer.m,
    )


def synth_activations(
    m: int, k: int, density: float, seed: int = 0, scale: float = 1.0
) -> np.ndarray:
    """Synthetic post-ReLU activations: zeros + folded Gaussian magnitudes.

    Non-negative by construction (the paper: "the inputs in the horizontal
    direction are, by construction, positive integers"), with an explicit
    zero fraction of (1 - density) from the preceding ReLU.
    """
    rng = np.random.default_rng(seed)
    mask = rng.random((m, k)) < density
    vals = np.abs(rng.normal(0.0, scale, size=(m, k)))
    return np.where(mask, vals, 0.0)


def synth_weights(k: int, n: int, seed: int = 1, scale: float = 1.0) -> np.ndarray:
    """Zero-mean Gaussian weights (signed: drives sign flips in partial sums)."""
    rng = np.random.default_rng(seed)
    return rng.normal(0.0, scale, size=(k, n))


def _default_b_v(bits: int, rows: int, dataflow: str) -> int:
    """Vertical bus data width per dataflow: the WS accumulator width, or the
    operand width under OS (the W stream; partial sums never move)."""
    from repro_torch.core.floorplan import accumulator_width

    return bits if dataflow == "OS" else accumulator_width(bits, rows)


def profile_conv_layer(
    layer: ConvLayer,
    rows: int = 32,
    cols: int = 32,
    bits: int = 16,
    b_v: int | None = None,
    max_tiles: int | None = None,
    max_stream: int | None = None,
    seed: int = 0,
    backend: str | None = None,
    use_cache: bool = True,
    dataflow: str = "WS",
    lane_detail: bool = False,
) -> ActivityProfile:
    """Quantize a synthetic instance of ``layer`` to int-``bits`` and profile it
    on an R x C array (the paper's Section IV methodology, with synthetic
    ImageNet-statistics inputs) under the given dataflow.

    Exact full-stream profile by default; pass ``max_tiles``/``max_stream``
    to opt into the subsampled estimate (WS only: OS profiling is exact by
    construction).  ``lane_detail=True`` also measures the exact
    per-bit-lane toggle totals (for the segment-level layout engine).
    Repeat calls hit the content-keyed profile cache.
    """
    g = conv_to_gemm(layer)
    a_f = synth_activations(g.m, g.k, layer.input_density, seed=seed)
    w_f = synth_weights(g.k, g.n, seed=seed + 1)
    a_q = quantize_symmetric(a_f, bits).values
    w_q = quantize_symmetric(w_f, bits).values
    bv = b_v if b_v is not None else _default_b_v(bits, rows, dataflow)
    return profile_gemm(
        a_q,
        w_q,
        rows=rows,
        cols=cols,
        b_h=bits,
        b_v=bv,
        max_tiles=max_tiles,
        max_stream=max_stream,
        seed=seed,
        dataflow=dataflow,
        backend=backend,
        use_cache=use_cache,
        lane_detail=lane_detail,
    )


def conv_layer_job(
    layer: ConvLayer,
    rows: int = 32,
    cols: int = 32,
    bits: int = 16,
    b_v: int | None = None,
    seed: int = 0,
    dataflow: str = "WS",
):
    """A lazy batch-pipeline job for one Table-I conv layer.

    Operand synthesis (``synth_activations`` + ``quantize_symmetric``) runs
    only when the pipeline materializes the job, i.e. overlapped with the
    device work of the previous shape-class bucket.  Operands and
    quantization match ``profile_conv_layer`` exactly, so profiles land on
    (and hit) the same content-keyed cache entries.
    """
    from repro_torch.core.pipeline import ProfileJob

    g = conv_to_gemm(layer)
    bv = b_v if b_v is not None else _default_b_v(bits, rows, dataflow)

    def make():
        a_f = synth_activations(g.m, g.k, layer.input_density, seed=seed)
        w_f = synth_weights(g.k, g.n, seed=seed + 1)
        return quantize_symmetric(a_f, bits).values, quantize_symmetric(w_f, bits).values

    return ProfileJob(
        rows=rows,
        cols=cols,
        b_h=bits,
        b_v=bv,
        make=make,
        shape=(g.m, g.k, g.n),
        name=layer.name,
        dataflow=dataflow,
    )


def gemm_job(
    gemm: Gemm,
    rows: int,
    cols: int,
    bits: int,
    b_v: int | None = None,
    seed: int = 0,
    density: float | None = None,
    clip: tuple[int, int, int] | None = (128, 512, 256),
    dataflow: str = "WS",
):
    """A lazy job for one (LLM-style) GEMM with synthetic int operands.

    Activations are post-activation (non-negative) Gaussians, weights
     1/sqrt(K)-scaled Gaussians, quantized to ``bits`` — the recipe of
    ``examples/sa_power_llm.py``. ``clip`` bounds the profiled slice of
    very large GEMMs (toggle *rates* converge long before full LLM dims).
    """
    from repro_torch.core.pipeline import ProfileJob

    m, k, n = gemm.m, gemm.k, gemm.n
    if clip is not None:
        m, k, n = min(m, clip[0]), min(k, clip[1]), min(n, clip[2])
    bv = b_v if b_v is not None else _default_b_v(bits, rows, dataflow)

    def make():
        rng = np.random.default_rng(seed)
        a_f = np.maximum(rng.normal(0.0, 1.0, size=(m, k)), 0.0)
        if density is not None:
            a_f = np.where(rng.random((m, k)) < density, a_f, 0.0)
        w_f = rng.normal(0.0, 1.0 / np.sqrt(k), size=(k, n))
        return quantize_symmetric(a_f, bits).values, quantize_symmetric(w_f, bits).values

    return ProfileJob(
        rows=rows,
        cols=cols,
        b_h=bits,
        b_v=bv,
        make=make,
        shape=(m, k, n),
        name=gemm.name,
        dataflow=dataflow,
    )


def profile_network(
    layers: Sequence[ConvLayer],
    rows: int = 32,
    cols: int = 32,
    bits: int = 16,
    b_v: int | None = None,
    max_tiles: int | None = None,
    max_stream: int | None = None,
    *,
    dataflow: str = "WS",
    backend: str | None = None,
    use_cache: bool = True,
    return_stats: bool = False,
):
    """Profile a whole network's conv layers through the batched pipeline.

    The batched analogue of looping ``profile_conv_layer``: same operands,
    same seeds (layer i uses seed i), same cache keys, bit-exact profiles,
    but all layers ride a handful of batched device passes with operand
    synthesis overlapped against device work.

    Subsampling (``max_tiles``/``max_stream``, WS only) remains a per-GEMM
    estimate, so requesting it falls back to the serial loop (the batch
    pipeline is exact-only).  With ``return_stats=True`` also returns the
    ``repro_torch.core.pipeline.BatchStats`` of the run.
    """
    from repro_torch.core.pipeline import BatchStats, run_profile_batch

    layers = list(layers)
    if max_tiles is not None or max_stream is not None:
        profiles = [
            profile_conv_layer(
                layer,
                rows=rows,
                cols=cols,
                bits=bits,
                b_v=b_v,
                max_tiles=max_tiles,
                max_stream=max_stream,
                seed=i,
                backend=backend,
                use_cache=use_cache,
                dataflow=dataflow,
            )
            for i, layer in enumerate(layers)
        ]
        stats = BatchStats(jobs=len(layers), serial_fallbacks=len(layers))
        return (profiles, stats) if return_stats else profiles

    jobs = [
        conv_layer_job(
            layer, rows=rows, cols=cols, bits=bits, b_v=b_v, seed=i, dataflow=dataflow
        )
        for i, layer in enumerate(layers)
    ]
    profiles, stats = run_profile_batch(jobs, backend=backend, use_cache=use_cache)
    return (profiles, stats) if return_stats else profiles


def _activity_classes(grid) -> tuple[list[tuple], np.ndarray]:
    """The grid's activity classes + the (P,) class index of every point.

    WS classes are ``("WS", rows, b_h, b_v_data)``; OS classes are the
    geometry-free ``("OS", b_h, b_v_data)`` (see
    ``measured_design_activities`` for why these are the invariants).
    """
    os_mask = np.asarray(grid.dataflow_os, bool)
    keys = np.stack(
        [
            np.asarray(grid.rows),
            np.asarray(grid.b_h),
            np.asarray(grid.b_v_data),
            os_mask.astype(np.int64),
        ],
        axis=1,
    )
    uniq, inverse = np.unique(keys, axis=0, return_inverse=True)
    classes: list[tuple] = []
    class_index: dict[tuple, int] = {}
    uniq_class = np.empty(len(uniq), np.int64)
    for u, (r, b_h, b_v, os_flag) in enumerate(uniq):
        # OS activities are geometry-free: rows drops out of the class key.
        key = ("OS", int(b_h), int(b_v)) if os_flag else ("WS", int(r), int(b_h), int(b_v))
        idx = class_index.get(key)
        if idx is None:
            idx = len(classes)
            classes.append(key)
            class_index[key] = idx
        uniq_class[u] = idx
    return classes, uniq_class[inverse]


def measured_design_activities(
    grid,
    layers: Sequence[ConvLayer] = RESNET50_TABLE1,
    *,
    profile_cols: int | None = None,
    backend: str | None = None,
    use_cache: bool = True,
    return_stats: bool = False,
):
    """Measured (W, P) activity arrays for a whole design grid.

    The profile→design-grid adapter: activities depend only on the *activity
    class* of a design point, never on its column count, PE area, or coding
    flag —

      * WS classes are ``(rows, b_h, b_v_data)``: each input lane's stream
        is a column of ``a`` whatever the tiling (h totals scale with
        ``ceil(N/cols)`` exactly as their transition denominators do: the
        batched pipeline's geometry-pass reuse), and column tiling
        regroups, never changes,
        the per-column partial-sum streams, so ``a_v`` depends on ``rows``
        (reduction depth) and the bus width only;
      * OS classes are ``(b_h, b_v_data)`` — fully geometry-free: both
        buses carry operand streams over the K axis (A rows horizontally at
        ``b_h``, W columns vertically at ``b_v``), and both totals scale
        with their tile counts exactly as the denominators do.  OS vertical
        activities are MEASURED from the real W-operand column streams, not
        approximated by ``a_h`` (the A operand's M-axis activity, on a bus
        that streams the W operand along K);
      * bus-invert is an activity *transform* applied later, inside the
        design-space evaluation, on ``b_v_data`` bits.

    So ONE profiling job per activity class per workload layer feeds every
    point of the grid: a few ``run_profile_batch`` passes (content-deduped
    against the shared sha256 cache, OS stream passes shared across ALL
    geometries) serve thousands-to-millions of design points.

    Returns ``(a_h, a_v)`` of shape (len(layers), grid.n_points) — plus the
    ``BatchStats`` with ``return_stats=True``.  Layer i is profiled with
    ``seed=i`` (the ``profile_network`` convention, so cache entries are
    shared with every other consumer).
    """
    from repro_torch.core.pipeline import run_profile_batch

    layers = list(layers)
    if not layers:
        raise ValueError("no workload layers")
    classes, point_class = _activity_classes(grid)
    cols_fix = int(profile_cols) if profile_cols is not None else int(np.min(grid.cols))
    rows_fix = int(np.min(grid.rows))  # OS activities are rows-invariant
    jobs = [
        conv_layer_job(
            layer,
            rows=cls[1] if cls[0] == "WS" else rows_fix,
            cols=cols_fix,
            bits=cls[-2],
            b_v=cls[-1],
            seed=i,
            dataflow=cls[0],
        )
        for cls in classes
        for i, layer in enumerate(layers)
    ]
    profiles, stats = run_profile_batch(jobs, backend=backend, use_cache=use_cache)
    n_layers = len(layers)
    class_a_h = np.asarray(
        [[profiles[c * n_layers + w].a_h for c in range(len(classes))] for w in range(n_layers)]
    )
    class_a_v = np.asarray(
        [[profiles[c * n_layers + w].a_v for c in range(len(classes))] for w in range(n_layers)]
    )
    a_h = class_a_h[:, point_class]
    a_v = class_a_v[:, point_class]
    return (a_h, a_v, stats) if return_stats else (a_h, a_v)


def gemm_profile_seed(
    gemm: Gemm,
    *,
    clip: tuple[int, int, int] | None = (128, 512, 256),
    density: float | None = None,
) -> int:
    """Content-keyed operand seed for one profiled GEMM shape class.

    Keyed on the CLIPPED dims (+ density) — the quantities that actually
    determine the synthetic operands — so the same shape class reached
    from different models / traffic mixes synthesizes identical operands
    and lands on (and hits) the same content-keyed profile-cache entries.
    """
    m, k, n = gemm.m, gemm.k, gemm.n
    if clip is not None:
        m, k, n = min(m, clip[0]), min(k, clip[1]), min(n, clip[2])
    key = f"{m}|{k}|{n}|{density}".encode()
    return int.from_bytes(hashlib.sha256(key).digest()[:4], "little")


def _gemm_activity_jobs(grid, gemms, densities, seeds, clip, profile_cols):
    """The profile jobs of ``measured_design_gemm_activities``: one
    ``gemm_job`` per activity class per unique operand class, in class-major
    order, with the GEMM axis's index into the unique classes and each
    point's activity class."""
    gemms = list(gemms)
    if not gemms:
        raise ValueError("no gemms")
    dens = list(densities) if densities is not None else [None] * len(gemms)
    if len(dens) != len(gemms):
        raise ValueError("densities must match the GEMM axis")
    if seeds is None:
        seeds = [
            gemm_profile_seed(g, clip=clip, density=d) for g, d in zip(gemms, dens)
        ]
    elif len(list(seeds)) != len(gemms):
        raise ValueError("seeds must match the GEMM axis")
    classes, point_class = _activity_classes(grid)
    cols_fix = int(profile_cols) if profile_cols is not None else int(np.min(grid.cols))
    rows_fix = int(np.min(grid.rows))  # OS activities are rows-invariant
    # Serving job sets repeat operand content heavily: after clipping, many
    # distinct full-dim GEMMs synthesize IDENTICAL operands (same clipped
    # dims + density + seed).  Profile each unique operand class once and
    # scatter back over the GEMM axis — a job-set of ~70 GEMMs typically
    # collapses to ~15 profiles per activity class.
    uniq_keys: dict[tuple, int] = {}
    gemm_uniq = np.empty(len(gemms), np.int64)
    uniq_items: list[tuple[Gemm, float | None, int]] = []
    for i, g in enumerate(gemms):
        m, k, n = g.m, g.k, g.n
        if clip is not None:
            m, k, n = min(m, clip[0]), min(k, clip[1]), min(n, clip[2])
        key = (m, k, n, dens[i], int(seeds[i]))
        u = uniq_keys.get(key)
        if u is None:
            u = len(uniq_items)
            uniq_keys[key] = u
            uniq_items.append((g, dens[i], int(seeds[i])))
        gemm_uniq[i] = u
    jobs = [
        gemm_job(
            g,
            rows=cls[1] if cls[0] == "WS" else rows_fix,
            cols=cols_fix,
            bits=cls[-2],
            b_v=cls[-1],
            seed=seed,
            density=density,
            clip=clip,
            dataflow=cls[0],
        )
        for cls in classes
        for g, density, seed in uniq_items
    ]
    return jobs, gemm_uniq, len(uniq_items), point_class


def measured_design_gemm_activities(
    grid,
    gemms: Sequence[Gemm],
    *,
    densities: Sequence[float | None] | None = None,
    seeds: Sequence[int] | None = None,
    clip: tuple[int, int, int] | None = (128, 512, 256),
    profile_cols: int | None = None,
    backend: str | None = None,
    use_cache: bool = True,
    return_stats: bool = False,
):
    """Measured (G, P) activity arrays for a GEMM job set — the serving
    adapter mirroring ``measured_design_activities``.

    One ``gemm_job`` per activity class per GEMM (same class invariance
    arguments: WS classes are (rows, b_h, b_v_data), OS classes the
    geometry-free (b_h, b_v_data)) feeds every point of the grid.
    ``clip`` bounds the profiled slice of LLM-sized GEMMs (toggle RATES
    converge long before full model dims; the J/op objective still prices
    utilization/spill/trunk from the FULL dims).  Seeds default to the
    content-keyed ``gemm_profile_seed`` so shape classes shared across
    models and traffic mixes dedup in the profile cache.
    """
    from repro_torch.core.pipeline import run_profile_batch

    jobs, gemm_uniq, n_u, point_class = _gemm_activity_jobs(
        grid, gemms, densities, seeds, clip, profile_cols
    )
    profiles, stats = run_profile_batch(jobs, backend=backend, use_cache=use_cache)
    n_classes = len(jobs) // n_u
    class_a_h = np.asarray(
        [[profiles[c * n_u + u].a_h for c in range(n_classes)] for u in range(n_u)]
    )
    class_a_v = np.asarray(
        [[profiles[c * n_u + u].a_v for c in range(n_classes)] for u in range(n_u)]
    )
    a_h = class_a_h[gemm_uniq][:, point_class]
    a_v = class_a_v[gemm_uniq][:, point_class]
    return (a_h, a_v, stats) if return_stats else (a_h, a_v)


def measured_design_lane_activities(
    grid,
    layers: Sequence[ConvLayer] = RESNET50_TABLE1,
    *,
    profile_cols: int | None = None,
    backend: str | None = None,
    use_cache: bool = True,
    n_lanes: int = 64,
):
    """Measured PER-BIT-LANE activities for a whole design grid.

    The lane-resolved sibling of ``measured_design_activities`` for the
    segment-level layout engine: one ``lane_detail=True`` profile per
    activity class per layer (lane-resolved profiling has no batch path, so
    classes run serially through the per-GEMM engine — keep the grid's
    class count small), expanded over the grid by the same cols/geometry
    invariance arguments (they hold per lane: the lane decomposition
    commutes with the tile scaling).

    Returns ``(a_h, a_v, h_lanes, v_lanes)``: the (W, P) aggregates plus
    (W, P, n_lanes) per-lane activity arrays (toggles per transition per
    wire, zero above each point's bus width) ready for
    ``repro_torch.layout.power.evaluate_layout_space``.  The grid must be BI-free
    (lane activities describe physical, uncoded buses).
    """
    layers = list(layers)
    if not layers:
        raise ValueError("no workload layers")
    if np.any(np.asarray(grid.bus_invert)):
        raise ValueError(
            "lane activities describe uncoded buses; expand the space with "
            "bus_invert=(False,)"
        )
    if int(np.max(grid.b_v)) > n_lanes or int(np.max(grid.b_h)) > n_lanes:
        raise ValueError(f"bus wider than n_lanes={n_lanes}")
    classes, point_class = _activity_classes(grid)
    cols_fix = int(profile_cols) if profile_cols is not None else int(np.min(grid.cols))
    rows_fix = int(np.min(grid.rows))
    n_layers = len(layers)
    agg_h = np.zeros((n_layers, len(classes)))
    agg_v = np.zeros((n_layers, len(classes)))
    lane_h = np.zeros((n_layers, len(classes), n_lanes))
    lane_v = np.zeros((n_layers, len(classes), n_lanes))
    for c, cls in enumerate(classes):
        for i, layer in enumerate(layers):
            p = profile_conv_layer(
                layer,
                rows=cls[1] if cls[0] == "WS" else rows_fix,
                cols=cols_fix,
                bits=cls[-2],
                b_v=cls[-1],
                seed=i,
                dataflow=cls[0],
                backend=backend,
                use_cache=use_cache,
                lane_detail=True,
            )
            agg_h[i, c] = p.a_h
            agg_v[i, c] = p.a_v
            lane_h[i, c, : p.b_h] = p.a_h_lanes
            lane_v[i, c, : p.b_v] = p.a_v_lanes
    return (
        agg_h[:, point_class],
        agg_v[:, point_class],
        lane_h[:, point_class, :],
        lane_v[:, point_class, :],
    )


# ---------------------------------------------------------------------------
# GEMM partitioning across pods (the k-axis workload model)
# ---------------------------------------------------------------------------
#
# A k x k multi-pod array can run a GEMM two ways:
#
#   * TILE-PARALLEL — each pod owns independent output tiles of its own
#     (R/k) x (C/k) footprint.  The inter-pod trunks stay idle, but a GEMM
#     deeper than R/k must accumulate across K passes through the memory
#     system (drain + reload of every partial output per extra pass).
#   * K-SPLIT — the k pods of a column cooperate on one output tile,
#     splitting the K axis across pod rows; partial sums reduce in-array
#     over the vertical reduction trunks (the full-width gutter-crossing
#     segments the layout engine already prices), recovering the monolithic
#     array's K capacity at the cost of trunk traffic.
#
# First-order model, one pass per (K window, N window): rounds count how
# many full-array waves the job list needs; spilled words count off-array
# partial-sum accumulation traffic (drain + reload ~ 2*rows hops per word);
# trunk words count gutter crossings (1 hop per word).  The mode decision
# minimizes rounds, then the wire-hop proxy.  Under OS both operands stream
# over K temporally, so there is nothing to reduce across pods: pods only
# ever run tile-parallel.  ``k=1`` degenerates to the monolithic array
# (both modes identical, zero trunk/spill difference) — the same exactness
# contract as ``MultiPodLayout(k=1)`` itself.


@dataclasses.dataclass(frozen=True)
class PodPartition:
    """How one GEMM maps onto a k x k podded array (see module comment)."""

    gemm: Gemm
    rows: int
    cols: int
    k: int
    dataflow: str
    mode: str  # "tile" | "ksplit"
    rounds: int  # full-array waves over the job list
    cycles: int  # rounds * streamed-axis length
    utilization: float  # useful MACs / (rounds * R * C * stream)
    spill_words: int  # off-array partial-sum accumulation traffic [words]
    trunk_words: int  # inter-pod reduction-trunk crossings [words]


def _ceil_div(a, b):
    return -(-np.asarray(a, np.int64) // np.asarray(b, np.int64))


def _partition_core(m, kdim, n, rows, cols, k, os_mask):
    """Vectorized partition model; every argument broadcasts.

    Returns dict of arrays: ksplit (bool), rounds, cycles, utilization,
    spill_words, trunk_words — for the CHOSEN mode per cell.
    """
    m, kdim, n = (np.asarray(v, np.int64) for v in (m, kdim, n))
    rows, cols, k = (np.asarray(v, np.int64) for v in (rows, cols, k))
    os_mask = np.asarray(os_mask, bool)
    pr = rows // k
    pc = cols // k
    stat = np.where(os_mask, m, kdim)  # rows-mapped stationary dim: K (WS), M (OS)
    stream = np.where(os_mask, kdim, m)
    macs = m * kdim * n

    # tile-parallel: k^2 independent pods over ceil(stat/pr)*ceil(N/pc) jobs
    passes_t = _ceil_div(stat, pr)
    rounds_t = _ceil_div(passes_t * _ceil_div(n, pc), k * k)
    spill_t = np.where(os_mask, 0, (_ceil_div(kdim, pr) - 1) * m * n)

    # K-split (WS): K across the k pod rows, N across the k pod columns
    passes_s = _ceil_div(stat, rows)
    rounds_s = _ceil_div(passes_s * _ceil_div(n, pc), k)
    spill_s = (_ceil_div(kdim, rows) - 1) * m * n
    trunk_s = _ceil_div(kdim, rows) * m * n * (k - 1)

    # wire-hop proxy: spilled words traverse the array twice (drain+reload),
    # trunk words cross one gutter
    cost_t = 2 * rows * spill_t
    cost_s = 2 * rows * spill_s + trunk_s
    ksplit = (~os_mask) & (
        (rounds_s < rounds_t) | ((rounds_s == rounds_t) & (cost_s < cost_t))
    )

    rounds = np.where(ksplit, rounds_s, rounds_t)
    cycles = rounds * stream
    denom = rounds * rows * cols * stream
    util = np.where(denom > 0, macs / np.maximum(denom, 1), 0.0)
    return {
        "ksplit": ksplit,
        "rounds": rounds,
        "cycles": cycles,
        "utilization": util,
        "spill_words": np.where(ksplit, spill_s, spill_t),
        "trunk_words": np.where(ksplit, trunk_s, 0),
    }


def partition_gemm(
    gemm: Gemm, rows: int, cols: int, k: int = 1, *, dataflow: str = "WS"
) -> PodPartition:
    """Partition one GEMM onto a k x k podded ``rows x cols`` array.

    Picks tile-parallel vs K-split per the module's first-order cost model
    and reports rounds/cycles/utilization plus the traffic the choice
    implies.  ``utilization`` < 1 exposes ragged tiles and small GEMMs on
    large arrays (the SISA scale-in argument for the free k axis).
    """
    if dataflow not in ("WS", "OS"):
        raise ValueError("dataflow must be WS or OS")
    if k < 1 or rows % k or cols % k:
        raise ValueError(f"k={k} must tile the {rows}x{cols} array")
    out = _partition_core(
        gemm.m, gemm.k, gemm.n, rows, cols, k, dataflow == "OS"
    )
    return PodPartition(
        gemm=gemm,
        rows=int(rows),
        cols=int(cols),
        k=int(k),
        dataflow=dataflow,
        mode="ksplit" if bool(out["ksplit"]) else "tile",
        rounds=int(out["rounds"]),
        cycles=int(out["cycles"]),
        utilization=float(out["utilization"]),
        spill_words=int(out["spill_words"]),
        trunk_words=int(out["trunk_words"]),
    )


def design_pod_partition(grid, layouts, gemms: Sequence[Gemm], weights=None):
    """(L, P) partition statistics of a workload over a layout-axis grid.

    For every (layout family, design point) cell, maps each GEMM (k from
    the family: ``MultiPodLayout.k``, else 1) and aggregates across GEMMs
    with ``weights`` (default: MAC-weighted).  Returns dict of (L, P)
    arrays:

      ``utilization``        weighted mean useful-MAC fraction,
      ``ksplit_frac``        weighted fraction of GEMMs choosing K-split,
      ``trunk_words_per_mac``/``spill_words_per_mac``  traffic intensities.

    Cells where the family does not tile the grid get utilization 0 (the
    layout evaluator already prices them infeasible); zero-MAC GEMMs
    contribute zero everywhere instead of dividing by zero.

    This is a thin aggregation over ``repro_torch.layout.coeffs
    .lower_partition_coeffs``, the same lowered arrays the J/op objective
    of ``repro_torch.layout.power`` consumes, so the two paths cannot
    silently disagree.
    """
    from repro_torch.layout.coeffs import lower_partition_coeffs

    gemms = list(gemms)
    if not gemms:
        raise ValueError("no gemms")
    w = np.asarray(
        weights if weights is not None else [g.macs for g in gemms], float
    )
    if w.shape != (len(gemms),) or w.sum() <= 0:
        raise ValueError("weights must be positive per-GEMM values")
    w = w / w.sum()

    h = lower_partition_coeffs(grid, layouts, gemms).host
    w3 = w[:, None, None]
    return {
        "utilization": (w3 * h["utilization"]).sum(axis=0),
        "ksplit_frac": (w3 * h["ksplit"]).sum(axis=0),
        "trunk_words_per_mac": (w3 * h["trunk_words_per_mac"]).sum(axis=0),
        "spill_words_per_mac": (w3 * h["spill_words_per_mac"]).sum(axis=0),
    }


def gemms_for_arch(cfg, seq_len: int, batch: int = 1) -> list[Gemm]:
    """Per-token-batch GEMM set of one transformer layer + vocab projection.

    ``cfg`` is a ``repro_torch.configs.registry.ArchConfig``. M is tokens
    (batch * seq), K/N the weight dims. MoE experts contribute their active
    (top-k) share of tokens. Feeds the paper's floorplan optimization with
    LLM inference workloads.
    """
    tokens = seq_len * batch
    d = cfg.d_model
    head_dim = cfg.head_dim
    gemms: list[Gemm] = [
        Gemm("q_proj", tokens, d, cfg.num_heads * head_dim),
        Gemm("k_proj", tokens, d, cfg.num_kv_heads * head_dim),
        Gemm("v_proj", tokens, d, cfg.num_kv_heads * head_dim),
        Gemm("o_proj", tokens, cfg.num_heads * head_dim, d),
    ]
    if cfg.num_experts > 1:
        ff = cfg.d_ff
        active_tokens = tokens * cfg.top_k
        gemms += [
            Gemm("moe_gate", tokens, d, cfg.num_experts),
            Gemm("expert_up", active_tokens, d, ff),
            Gemm("expert_gate", active_tokens, d, ff),
            Gemm("expert_down", active_tokens, ff, d),
        ]
    elif cfg.d_ff > 0:
        gemms += [
            Gemm("ffn_up", tokens, d, cfg.d_ff),
            Gemm("ffn_gate", tokens, d, cfg.d_ff),
            Gemm("ffn_down", tokens, cfg.d_ff, d),
        ]
    gemms.append(Gemm("lm_head", tokens, d, cfg.vocab_size))
    return gemms


def total_macs(gemms: Sequence[Gemm]) -> int:
    return sum(g.macs for g in gemms)
