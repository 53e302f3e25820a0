"""PyTorch oracle for the flash_attention kernel (K7)."""

from __future__ import annotations

import torch

__all__ = ["attention_ref"]

_NEG_INF = -1.0e30


def attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    sm_scale: float | None = None,
) -> torch.Tensor:
    """Dense masked softmax attention in f32. q, k, v: (BH, S, D); the
    result is in q's dtype, and a query row that sees no key gives zeros."""
    _, s, d = q.shape
    scale = sm_scale if sm_scale is not None else d ** -0.5
    logits = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    q_ids = torch.arange(s, device=q.device)[:, None]
    k_ids = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (q_ids >= k_ids)
    if window is not None:
        mask = mask & (q_ids - k_ids < window)
    logits = torch.where(mask[None], logits, _NEG_INF)
    probs = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    probs = torch.where(mask[None], probs, 0.0)
    denom = probs.sum(dim=-1, keepdim=True)
    probs = probs / torch.where(denom == 0.0, 1.0, denom)
    return torch.einsum("bqk,bkd->bqd", probs, v.float()).to(q.dtype)
