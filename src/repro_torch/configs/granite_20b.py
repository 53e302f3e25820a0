"""Granite-20B (code) [arXiv:2405.04324; hf].

52L, d=6144, 48 heads with MQA (kv=1 — TP-replicated KV, see sharding
fallback), d_ff=24576 non-gated GELU FFN (GPT-BigCode lineage), vocab=49152.
"""

from repro_torch.configs.registry import ArchConfig

CONFIG = ArchConfig(
    name="granite_20b",
    n_layers=52,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,
    head_dim=128,
    d_ff=24576,
    vocab_size=49152,
    gated_mlp=False,
    activation="gelu",
)
