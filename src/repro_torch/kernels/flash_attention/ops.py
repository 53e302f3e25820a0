"""Public API of fused attention (kernel K7): GQA and any sequence length.

The same entry point as the JAX package's ``flash_attention/ops.py``, with
``engine="cuda"`` (the default: the kernel on the current CUDA device) or
``engine="torch"`` (its plain PyTorch version on the CPU) in place of
``interpret=``.  Inputs are numpy arrays (float32) or tensors (also
bfloat16); numpy input is copied to the engine's device once and a
contiguous tensor already there is used in place.

Deliberate differences from the reference: no ``block_q``/``block_k``
arguments (TPU tiling knobs); GQA without repeating K and V (the kernel
indexes the KV head); no sequence padding (the kernels read zeros past the
end); head dims limited to the kernels' 32, 64 and 128; and on the card
both types run on the tensor cores, bfloat16 with P as two bf16 terms and
float32 as three TF32 products.  The reference's
``ValueError`` contracts stay: H must be a multiple of KV, and a
non-causal call needs S to be a multiple of its default block, 128, so
that both packages accept the same calls.
"""

from __future__ import annotations

import torch

from repro_torch.kernels._engine import engine_device, to_engine
from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd

__all__ = ["NONCAUSAL_SEQ_MULTIPLE", "flash_attention"]

# The reference's default block (max(block_q, block_k)): a non-causal call
# needs a sequence that is a multiple of it.
NONCAUSAL_SEQ_MULTIPLE = 128


def flash_attention(
    q,
    k,
    v,
    *,
    causal: bool = True,
    window: int | None = None,
    sm_scale: float | None = None,
    engine: str = "cuda",
) -> torch.Tensor:
    """Fused attention over (B, H, S, D) queries with (B, KV, S, D) keys and
    values; query head h attends with KV head h // (H // KV).  Returns
    (B, H, S, D) in q's dtype on the engine's device."""
    device = engine_device(engine)
    q, k, v = (to_engine(x, device) for x in (q, k, v))
    if not causal and q.ndim == 4 and q.shape[2] % NONCAUSAL_SEQ_MULTIPLE:
        raise ValueError("non-causal flash attention requires block-multiple seq")
    return flash_attention_fwd(q, k, v, causal=causal, window=window, sm_scale=sm_scale)
