"""MusicGen-medium decoder backbone over EnCodec tokens [arXiv:2306.05284; hf].

48L, d=1536, 24 MHA heads (kv=24), d_ff=6144 (non-gated GELU FFN), vocab=2048
per codebook, 4 codebooks (embeddings summed; 4 parallel LM heads). The
EnCodec frontend (+ delay-pattern interleaving) is a STUB: input_specs provide
the precomputed codebook token streams directly (DESIGN.md).
"""

from repro_torch.configs.registry import ArchConfig

CONFIG = ArchConfig(
    name="musicgen_medium",
    n_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,
    head_dim=64,
    d_ff=6144,
    vocab_size=2048,
    stage_pattern=(("attn", "dense"),),
    gated_mlp=False,
    activation="gelu",
    num_codebooks=4,
)
