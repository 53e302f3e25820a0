"""Serving-traffic workload subsystem: model configs + traffic mixes ->
GEMM job sets -> J/token design-space answers (DESIGN.md §Serving-workloads).

Three layers: ``expand`` (ArchConfig x regime -> per-block GEMM shapes),
``traffic`` (seeded steady-state traffic -> MAC-share-weighted job sets),
``codesign`` (job sets -> measured activities -> fleet J/op -> J/token).
"""

from repro_torch.serving.codesign import (
    DEFAULT_FAMILIES,
    DEFAULT_SPACE,
    CodesignResult,
    cnn_reference,
    codesign,
    regime_best_cell,
)
from repro_torch.serving.expand import (
    REGIMES,
    ServingGemm,
    expand_arch,
    expand_shape,
    regime_tokens,
    routing_sparsity,
    validate_job_set,
)
from repro_torch.serving.traffic import (
    PRESETS,
    ServingJobSet,
    TrafficClass,
    TrafficModel,
    get_preset,
    sample_requests,
    traffic_classes,
    weighted_gemms,
)

__all__ = [
    "REGIMES",
    "PRESETS",
    "DEFAULT_SPACE",
    "DEFAULT_FAMILIES",
    "ServingGemm",
    "ServingJobSet",
    "TrafficClass",
    "TrafficModel",
    "CodesignResult",
    "expand_arch",
    "expand_shape",
    "regime_tokens",
    "routing_sparsity",
    "validate_job_set",
    "get_preset",
    "sample_requests",
    "traffic_classes",
    "weighted_gemms",
    "codesign",
    "cnn_reference",
    "regime_best_cell",
]
