"""Architecture + shape registry.

Every assigned architecture is a frozen ``ArchConfig``; ``reduced()`` derives
the same-family smoke-test config (small dims, same block pattern). Shapes are
the four assigned input regimes; ``applicable()`` encodes the long_500k
sub-quadratic rule from DESIGN.md §Arch-applicability.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Literal

MixerKind = Literal["attn", "mamba", "mlstm", "slstm"]
MlpKind = Literal["dense", "moe", "none"]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    n_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    stage_pattern: tuple[tuple[MixerKind, MlpKind], ...] = (("attn", "dense"),)

    # attention options
    qkv_bias: bool = False
    qk_norm: bool = False
    window: int | None = None
    rope_kind: Literal["standard", "mrope", "none"] = "standard"
    rope_theta: float = 10000.0
    mrope_sections: tuple[int, int, int] = (16, 24, 24)
    attn_chunk: int = 1024  # dense attention below this seq, blockwise above

    # MoE
    num_experts: int = 1
    top_k: int = 1
    capacity_factor: float = 1.25
    num_shared_experts: int = 0
    moe_d_ff: int | None = None
    renormalize_topk: bool = True
    aux_loss_coef: float = 0.01
    # physical expert shards (>= num_experts, multiple of it): when E < the
    # TP axis, each expert's weights are broadcast over E_phys/E shards and
    # its capacity split among them, so EP still uses the whole 'model' axis
    # (mixtral: 8 experts -> 16 shards). 0 = num_experts.
    expert_shards: int = 0

    # Mamba
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    mamba_dt_rank: int = 0  # 0 -> d_model // 16
    # Jamba's mixer: RMSNorms on dt (dt_rank wide), B and C (d_state wide),
    # each with its own weight, between x_proj and dt_proj / the scan
    mamba_inner_norms: bool = False

    # xLSTM
    xlstm_proj_factor: float = 2.0
    xlstm_slstm_pf: float = 4.0 / 3.0

    # IO / misc
    num_codebooks: int = 1  # musicgen: 4 EnCodec streams
    gated_mlp: bool = True  # SwiGLU-style; False -> classic 2-matrix FFN
    activation: str = "silu"
    scan_chunk: int = 512  # seq chunk for SSM/linear-attn/blockwise paths
    subquadratic: bool = False  # may run long_500k
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    # 'stage' ('full' = alias): checkpoint each scanned stage;
    # 'block': finer per-(mixer|mlp)-block checkpoints (deep stage patterns);
    # 'none': save everything.
    remat: Literal["none", "full", "stage", "block"] = "stage"
    # chunked cross-entropy: compute the LM head + CE over seq chunks of this
    # size (scan + per-chunk remat) so (B, S, V) logits never materialize.
    # 0 = off (full logits). Exactness is dtype-identical to the full path.
    loss_chunk: int = 0
    # dtype of the mamba selective-scan chunk tensors (a/u/h). f32 is exact;
    # bf16 halves the dominant train-time working set (validated in tests).
    mamba_state_dtype: str = "float32"

    def __post_init__(self):
        if self.n_layers % len(self.stage_pattern):
            raise ValueError(
                f"{self.name}: n_layers {self.n_layers} not a multiple of "
                f"stage pattern length {len(self.stage_pattern)}"
            )

    @property
    def n_stages(self) -> int:
        return self.n_layers // len(self.stage_pattern)

    @property
    def dt_rank(self) -> int:
        return self.mamba_dt_rank or max(self.d_model // 16, 8)

    def with_dtypes(self, param: str, compute: str) -> "ArchConfig":
        return dataclasses.replace(self, param_dtype=param, compute_dtype=compute)

    def reduced(self) -> "ArchConfig":
        """Same-family tiny config for CPU smoke tests (one stage)."""
        heads = min(self.num_heads, 4)
        kv = max(1, min(self.num_kv_heads, heads))
        while heads % kv:
            kv -= 1
        return dataclasses.replace(
            self,
            n_layers=len(self.stage_pattern),
            d_model=128,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=32,
            d_ff=0 if self.d_ff == 0 else 256,
            moe_d_ff=None if self.moe_d_ff is None else 256,
            vocab_size=512,
            num_experts=min(self.num_experts, 4),
            expert_shards=0,
            top_k=min(self.top_k, 2),
            window=min(self.window, 16) if self.window else None,
            attn_chunk=64,
            scan_chunk=16,
            mrope_sections=(4, 6, 6),
            mamba_dt_rank=8,
            param_dtype="float32",
            compute_dtype="float32",
        )

    def param_count(self) -> int:
        """Analytic total parameter count (embeddings + stages + head)."""
        from repro_torch.models.model import count_params_analytic

        return count_params_analytic(self)

    def active_param_count(self) -> int:
        from repro_torch.models.model import count_params_analytic

        return count_params_analytic(self, active_only=True)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: Literal["train", "prefill", "decode"]
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}

ARCH_IDS = (
    "musicgen_medium",
    "jamba_v01_52b",
    "qwen2_vl_7b",
    "xlstm_1p3b",
    "granite_20b",
    "yi_6b",
    "qwen15_4b",
    "qwen3_8b",
    "llama4_maverick_400b",
    "mixtral_8x7b",
)

# external ids (assignment spelling) -> module ids
ALIASES = {
    "musicgen-medium": "musicgen_medium",
    "jamba-v0.1-52b": "jamba_v01_52b",
    "qwen2-vl-7b": "qwen2_vl_7b",
    "xlstm-1.3b": "xlstm_1p3b",
    "granite-20b": "granite_20b",
    "yi-6b": "yi_6b",
    "qwen1.5-4b": "qwen15_4b",
    "qwen3-8b": "qwen3_8b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b",
    "mixtral-8x7b": "mixtral_8x7b",
}


def get_arch(arch_id: str) -> ArchConfig:
    arch_id = ALIASES.get(arch_id, arch_id)
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{arch_id}")
    return mod.CONFIG


def applicable(cfg: ArchConfig, shape: ShapeSpec) -> bool:
    """long_500k requires sub-quadratic sequence mixing (DESIGN.md)."""
    if shape.name == "long_500k":
        return cfg.subquadratic
    return True


def all_cells() -> list[tuple[str, str]]:
    """Every runnable (arch, shape) dry-run cell."""
    cells = []
    for a in ARCH_IDS:
        cfg = get_arch(a)
        for s in SHAPES.values():
            if applicable(cfg, s):
                cells.append((a, s.name))
    return cells
