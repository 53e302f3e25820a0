"""Workload expansion: ArchConfig x serving regime -> per-block GEMM sets.

Layer 1 of the serving subsystem (DESIGN.md §Serving-workloads).  A model
config from ``repro_torch.configs.registry`` is walked block by block — attention,
Mamba, m/sLSTM, dense/MoE MLP, LM head — into the concrete GEMM shapes one
forward step executes under a serving regime:

  * ``prefill``: M = batch * seq_len tokens flow through every projection;
  * ``decode``:  M = the decode-step token count, derived from the SAME
    ``launch.specs.token_shape`` helper the launchers' batch specs use
    (seq axis == 1), so the serving expansion and the decode batch specs
    can never drift apart.

MoE routing sparsity (top_k / num_experts) becomes the per-expert effective
batch: each of the E experts sees ``round(tokens * top_k / E)`` rows, so the
expansion prices exactly the active-parameter GEMM work, with the router and
any shared experts at the full token batch.  Attention score/context
products (QK^T, PV) are cache-shaped dynamic-by-dynamic products served by
the flash-attention kernel, not stationary-weight GEMMs, and are out of
scope here — same contract as ``core.workloads.gemms_for_arch``.

Every emitted ``ServingGemm`` carries a ``count`` multiplicity (layers x
heads x experts ...) so identical shapes collapse to one entry, and an
``input_density`` hint for post-activation operand streams (down
projections see ~half-zero SiLU/GELU outputs).
"""

from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Sequence

from repro_torch.core.workloads import Gemm
from repro_torch.launch.specs import token_shape

__all__ = [
    "ServingGemm",
    "REGIMES",
    "expand_arch",
    "expand_shape",
    "regime_tokens",
    "routing_sparsity",
    "validate_job_set",
]

REGIMES = ("prefill", "decode")

# density hint for operands that just passed a SiLU/GELU-style gate:
# roughly half the activations are (near-)zero, matching the synthetic
# post-activation streams ``core.workloads.gemm_job`` generates.
_POST_ACT_DENSITY = 0.5


@dataclasses.dataclass(frozen=True)
class ServingGemm:
    """One GEMM shape class a serving step executes ``count`` times.

    ``gemm.m`` is the token batch of the regime (or the per-expert
    effective batch for routed experts); K/N are the weight dims.
    """

    gemm: Gemm
    block: str  # "attn.q_proj", "moe.expert_up", "head.lm_head", ...
    regime: str  # "prefill" | "decode"
    count: int  # executions per model forward (layers x heads x experts)
    input_density: float | None = None  # post-activation stream density hint

    def __post_init__(self):
        if self.regime not in REGIMES:
            raise ValueError(f"regime must be one of {REGIMES}, got {self.regime!r}")
        if self.count < 1:
            raise ValueError(f"{self.block}: count must be >= 1, got {self.count}")
        if min(self.gemm.m, self.gemm.k, self.gemm.n) < 1:
            raise ValueError(
                f"{self.block}: non-positive GEMM dims "
                f"({self.gemm.m}, {self.gemm.k}, {self.gemm.n})"
            )

    @property
    def macs(self) -> int:
        """Total MACs this entry contributes to one forward step."""
        return self.count * self.gemm.macs


def regime_tokens(cfg, regime: str, batch: int, seq_len: int = 1) -> int:
    """Token batch M of one serving step, via the shared token-shape helper.

    Decode is DEFINED as ``token_shape(cfg, batch, 1)`` — the exact shape
    of a decode step's token batch — so M is the product of its
    (batch, seq) leading axes (codebook streams share one position: the
    backbone hidden state is (B, S, d) with codebook embeddings summed).
    """
    if regime not in REGIMES:
        raise ValueError(f"regime must be one of {REGIMES}, got {regime!r}")
    if regime == "decode":
        seq_len = 1
    if batch < 1 or seq_len < 1:
        raise ValueError(f"need batch, seq_len >= 1; got {batch}, {seq_len}")
    shape = token_shape(cfg, batch, seq_len)
    return shape[0] * shape[1]


def routing_sparsity(cfg) -> float:
    """Expert-routing sparsity: active fraction of expert capacity, in (0, 1].

    ``top_k / num_experts`` for MoE configs (mixtral 2/8 = 0.25, llama4
    1/128), 1.0 for dense models (every FFN row is active).
    """
    if cfg.num_experts > 1:
        return cfg.top_k / cfg.num_experts
    return 1.0


# ---------------------------------------------------------------------------
# Per-block expansions (t = token batch of the step)
# ---------------------------------------------------------------------------


def _attn_gemms(cfg, t: int) -> list[tuple[str, Gemm, int, float | None]]:
    d = cfg.d_model
    q_out = cfg.num_heads * cfg.head_dim
    kv_out = cfg.num_kv_heads * cfg.head_dim
    return [
        ("attn.q_proj", Gemm("q_proj", t, d, q_out), 1, None),
        ("attn.k_proj", Gemm("k_proj", t, d, kv_out), 1, None),
        ("attn.v_proj", Gemm("v_proj", t, d, kv_out), 1, None),
        ("attn.o_proj", Gemm("o_proj", t, q_out, d), 1, None),
    ]


def _mamba_gemms(cfg, t: int) -> list[tuple[str, Gemm, int, float | None]]:
    d = cfg.d_model
    di = cfg.mamba_expand * d
    n = cfg.mamba_d_state
    dtr = cfg.dt_rank
    # the depthwise conv is not a GEMM; x_proj/dt_proj consume post-SiLU
    # conv output (half-zero streams)
    return [
        ("mamba.in_proj", Gemm("in_proj", t, d, 2 * di), 1, None),
        ("mamba.x_proj", Gemm("x_proj", t, di, dtr + 2 * n), 1, _POST_ACT_DENSITY),
        ("mamba.dt_proj", Gemm("dt_proj", t, dtr, di), 1, None),
        ("mamba.out_proj", Gemm("out_proj", t, di, d), 1, _POST_ACT_DENSITY),
    ]


def _mlstm_gemms(cfg, t: int) -> list[tuple[str, Gemm, int, float | None]]:
    d = cfg.d_model
    di = int(cfg.xlstm_proj_factor * d)
    h = cfg.num_heads
    dh = di // h
    return [
        ("mlstm.w_up", Gemm("w_up", t, d, 2 * di), 1, None),
        # block-diagonal per-head q/k/v: h independent (t, dh) @ (dh, dh)
        ("mlstm.wqkv", Gemm("wqkv", t, dh, dh), 3 * h, None),
        ("mlstm.gates", Gemm("gates", t, di, h), 2, None),
        ("mlstm.w_down", Gemm("w_down", t, di, d), 1, _POST_ACT_DENSITY),
    ]


def _slstm_gemms(cfg, t: int) -> list[tuple[str, Gemm, int, float | None]]:
    d = cfg.d_model
    h = cfg.num_heads
    dh = d // h
    # xLSTM sLSTM post-recurrence gated MLP width (models/xlstm.py)
    ff = max(128, int(round(cfg.xlstm_slstm_pf * d / 128)) * 128)
    return [
        # four gate input projections z/i/f/o, each (t, d) @ (d, d)
        ("slstm.w_gates", Gemm("w_gates", t, d, d), 4, None),
        # per-head block-diagonal recurrent matrices, every token, every gate
        ("slstm.r_gates", Gemm("r_gates", t, dh, dh), 4 * h, None),
        ("slstm.ff_gate", Gemm("ff_gate", t, d, ff), 1, None),
        ("slstm.ff_down", Gemm("ff_down", t, ff, d), 1, _POST_ACT_DENSITY),
    ]


def _dense_mlp_gemms(
    cfg, t: int, d_ff: int, prefix: str = "mlp"
) -> list[tuple[str, Gemm, int, float | None]]:
    d = cfg.d_model
    out = [(f"{prefix}.w_gate", Gemm("w_gate", t, d, d_ff), 1, None)]
    if cfg.gated_mlp:
        out.append((f"{prefix}.w_up", Gemm("w_up", t, d, d_ff), 1, None))
    out.append((f"{prefix}.w_down", Gemm("w_down", t, d_ff, d), 1, _POST_ACT_DENSITY))
    return out


def _moe_gemms(cfg, t: int) -> list[tuple[str, Gemm, int, float | None]]:
    d = cfg.d_model
    ff = cfg.moe_d_ff or cfg.d_ff
    e = cfg.num_experts
    # routing sparsity as per-expert effective batch: t*top_k active rows
    # spread over E experts — never below one row per expert
    m_e = max(1, round(t * routing_sparsity(cfg)))
    out = [
        ("moe.router", Gemm("router", t, d, e), 1, None),
        ("moe.expert_gate", Gemm("expert_gate", m_e, d, ff), e, None),
    ]
    if cfg.gated_mlp:
        out.append(("moe.expert_up", Gemm("expert_up", m_e, d, ff), e, None))
    out.append(("moe.expert_down", Gemm("expert_down", m_e, ff, d), e, _POST_ACT_DENSITY))
    if cfg.num_shared_experts:
        out += _dense_mlp_gemms(
            cfg, t, ff * cfg.num_shared_experts, prefix="moe.shared"
        )
    return out


_MIXERS = {
    "attn": _attn_gemms,
    "mamba": _mamba_gemms,
    "mlstm": _mlstm_gemms,
    "slstm": _slstm_gemms,
}


def expand_arch(
    cfg, regime: str, batch: int, seq_len: int = 1
) -> list[ServingGemm]:
    """Expand one serving step of ``cfg`` into its per-block GEMM job set.

    Walks the stage pattern once per distinct (mixer, mlp) pair and scales
    counts by how often the pair occurs across the whole stack (jamba's 7:1
    mamba:attn ratio collapses to two mixer entries with counts 28 and 4),
    then appends the LM head (one per codebook — musicgen's 4 parallel
    heads).  Returns entries in deterministic walk order.
    """
    t = regime_tokens(cfg, regime, batch, seq_len)
    pair_counts = Counter(cfg.stage_pattern)
    out: list[ServingGemm] = []

    def emit(entries, repeat: int):
        for block, gemm, count, density in entries:
            out.append(
                ServingGemm(
                    gemm=gemm,
                    block=block,
                    regime=regime,
                    count=count * repeat,
                    input_density=density,
                )
            )

    # iterate pairs in first-occurrence order for deterministic output
    seen: list[tuple] = []
    for pair in cfg.stage_pattern:
        if pair in seen:
            continue
        seen.append(pair)
        mixer, mlp = pair
        repeat = pair_counts[pair] * cfg.n_stages
        if mixer not in _MIXERS:
            raise ValueError(f"{cfg.name}: unknown mixer kind {mixer!r}")
        emit(_MIXERS[mixer](cfg, t), repeat)
        if mlp == "moe":
            emit(_moe_gemms(cfg, t), repeat)
        elif mlp == "dense":
            if cfg.d_ff <= 0:
                raise ValueError(f"{cfg.name}: dense MLP with d_ff={cfg.d_ff}")
            emit(_dense_mlp_gemms(cfg, t, cfg.d_ff), repeat)
        elif mlp != "none":
            raise ValueError(f"{cfg.name}: unknown mlp kind {mlp!r}")

    emit(
        [("head.lm_head", Gemm("lm_head", t, cfg.d_model, cfg.vocab_size), 1, None)],
        cfg.num_codebooks,
    )
    return validate_job_set(out)


def expand_shape(cfg, shape) -> list[ServingGemm]:
    """Expand a registry ``ShapeSpec`` cell (prefill_32k, decode_32k, ...).

    Decode cells use only the global batch (seq_len parameterizes the KV
    cache, not the per-step GEMMs); train cells expand like prefill (the
    forward GEMM set — backward doubles it but adds no new shapes).
    """
    regime = "decode" if shape.kind == "decode" else "prefill"
    if regime == "decode":
        return expand_arch(cfg, "decode", shape.global_batch)
    return expand_arch(cfg, "prefill", shape.global_batch, shape.seq_len)


def validate_job_set(jobs: Sequence[ServingGemm]) -> list[ServingGemm]:
    """Contract check: non-empty, positive shapes/counts, known regimes."""
    jobs = list(jobs)
    if not jobs:
        raise ValueError("empty GEMM job set")
    for j in jobs:
        # ServingGemm.__post_init__ already validated; re-assert the
        # aggregate invariant cheaply for externally assembled sets
        if j.macs <= 0:
            raise ValueError(f"{j.block}: non-positive MACs")
    return jobs
