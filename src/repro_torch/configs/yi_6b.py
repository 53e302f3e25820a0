"""Yi-6B llama-arch GQA [arXiv:2403.04652; hf]. 32L d=4096 GQA 32/4."""

from repro_torch.configs.registry import ArchConfig

CONFIG = ArchConfig(
    name="yi_6b",
    n_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=11008,
    vocab_size=64000,
    rope_theta=5000000.0,
)
