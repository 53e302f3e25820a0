"""Llama-4-Maverick 400B-A17B [hf; unverified].

48L, d=5120, GQA 40/8, vocab=202048; MoE every other layer (128 routed
experts top-1 + 1 shared expert, expert d_ff=8192); dense layers d_ff=16384.
Early-fusion multimodal frontend is a STUB (text tokens only in input_specs).
"""

from repro_torch.configs.registry import ArchConfig

CONFIG = ArchConfig(
    name="llama4_maverick_400b",
    n_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=202048,
    stage_pattern=(("attn", "dense"), ("attn", "moe")),
    num_experts=128,
    top_k=1,
    num_shared_experts=1,
    moe_d_ff=8192,
)
