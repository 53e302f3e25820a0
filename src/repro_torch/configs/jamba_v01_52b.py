"""Jamba-v0.1 52B hybrid Mamba+attention MoE [arXiv:2403.19887; hf].

32L in 4 stages of 8 (attn:mamba = 1:7, attention at in-stage index 4 as in
the paper's figure); MoE (16 experts, top-2) every other layer; GQA kv=8.
"""

from repro_torch.configs.registry import ArchConfig

_STAGE = (
    ("mamba", "dense"),
    ("mamba", "moe"),
    ("mamba", "dense"),
    ("mamba", "moe"),
    ("attn", "dense"),
    ("mamba", "moe"),
    ("mamba", "dense"),
    ("mamba", "moe"),
)

CONFIG = ArchConfig(
    name="jamba_v01_52b",
    n_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=65536,
    stage_pattern=_STAGE,
    num_experts=16,
    top_k=2,
    subquadratic=True,  # mamba-dominated: runs long_500k
)
