"""Qwen2-VL-7B language backbone [arXiv:2409.12191; hf].

28L, d=3584, GQA 28/4, d_ff=18944, vocab=152064; QKV bias; M-RoPE with
(16, 24, 24) sections over head_dim/2=64. Vision frontend (dynamic-resolution
patch embed) is a STUB: positions arrive precomputed as a (3, B, S) stream.
"""

from repro_torch.configs.registry import ArchConfig

CONFIG = ArchConfig(
    name="qwen2_vl_7b",
    n_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    head_dim=128,
    d_ff=18944,
    vocab_size=152064,
    qkv_bias=True,
    rope_kind="mrope",
    mrope_sections=(16, 24, 24),
    rope_theta=1000000.0,
)
