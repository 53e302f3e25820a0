"""xLSTM-1.3B [arXiv:2405.04517; unverified].

48 blocks, d=2048, 4 heads, no separate FFN (d_ff=0; projections live inside
the m/sLSTM blocks). Block ratio mLSTM:sLSTM = 7:1 (xLSTM[7:1]).
"""

from repro_torch.configs.registry import ArchConfig

_STAGE = (("slstm", "none"),) + (("mlstm", "none"),) * 7

CONFIG = ArchConfig(
    name="xlstm_1p3b",
    n_layers=48,
    d_model=2048,
    num_heads=4,
    num_kv_heads=4,
    head_dim=512,
    d_ff=0,
    vocab_size=50304,
    stage_pattern=_STAGE,
    xlstm_proj_factor=2.0,
    subquadratic=True,  # recurrent state: runs long_500k
)
