"""The paper's workload: the six ResNet50 conv layers of Table I.

Each layer is lowered conv -> im2col GEMM, with synthetic post-ReLU
activations (density matched to typical ResNet50 layer sparsity) and
zero-mean weights, quantized to int16 exactly as in Section IV.  Operand
synthesis stays on numpy's ``default_rng`` with the reference package's
seeds, so both packages profile byte-identical operands.

Only the Table-I half of the reference module is here.  ``profile_network``
runs all layers through the batched pipeline (``repro_torch.core.pipeline``)
as lazy ``conv_layer_job``s.  The LLM GEMM extraction and the design-space
activity helpers come with later slices of the port.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.core.quant import quantize_symmetric
from repro_torch.core.switching import ActivityProfile, profile_gemm

__all__ = [
    "ConvLayer",
    "Gemm",
    "RESNET50_TABLE1",
    "conv_to_gemm",
    "synth_activations",
    "synth_weights",
    "profile_conv_layer",
    "conv_layer_job",
    "profile_network",
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
) -> ActivityProfile:
    """Quantize a synthetic instance of ``layer`` to int-``bits`` and profile it
    on an R x C array (the paper's Section IV methodology, with synthetic
    ImageNet-statistics inputs) under the given dataflow.

    Exact full-stream profile by default; pass ``max_tiles``/``max_stream``
    to opt into the subsampled estimate (WS only: OS profiling is exact by
    construction).  Repeat calls hit the content-keyed profile cache.
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
