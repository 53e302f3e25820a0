"""Mixtral-8x7B [arXiv:2401.04088]. 32L d=4096 GQA 32/8; 8 experts top-2
every layer; sliding-window attention (4096) => bounded KV cache, runs
long_500k."""

from repro_torch.configs.registry import ArchConfig

CONFIG = ArchConfig(
    name="mixtral_8x7b",
    n_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    stage_pattern=(("attn", "moe"),),
    num_experts=8,
    expert_shards=16,  # 2-way replication groups: fill the 16-wide TP axis
    top_k=2,
    window=4096,
    subquadratic=True,
)
