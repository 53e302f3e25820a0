"""Qwen3-8B [hf:Qwen/Qwen3-8B]. 36L d=4096 GQA 32/8, per-head qk RMSNorm."""

from repro_torch.configs.registry import ArchConfig

CONFIG = ArchConfig(
    name="qwen3_8b",
    n_layers=36,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=12288,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1000000.0,
)
