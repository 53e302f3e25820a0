"""Qwen1.5-4B [hf:Qwen/Qwen1.5-4B]. 40L d=2560 MHA 20/20, QKV bias."""

from repro_torch.configs.registry import ArchConfig

CONFIG = ArchConfig(
    name="qwen15_4b",
    n_layers=40,
    d_model=2560,
    num_heads=20,
    num_kv_heads=20,
    head_dim=128,
    d_ff=6912,
    vocab_size=151936,
    qkv_bias=True,
)
