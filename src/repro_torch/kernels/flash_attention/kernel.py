"""K7: fused attention forward, its routes and its plain version.

K7 replaces ``flash_attention_pallas``
(``src/repro/kernels/flash_attention/kernel.py``): causal and sliding-window
softmax attention with an online softmax in f32, over (B, H, S, D) queries
and (B, KV, S, D) keys and values, query head h reading KV head
h // (H // KV).  ``flash_attention_fwd`` takes one of two routes, fixed by
the type alone, never by a failure:

* bf16: the tensor cores (the kernel ``flash_attention_tc``, wgmma fed by
  TMA).  The TPU kernel multiplied the softmax weights P in f32; wgmma
  takes them in bf16, so the kernel carries P as two bf16 terms, hi + lo
  (one rounding alone would leave the bf16 tolerance on rows that see few
  keys).
* f32: the CUDA cores (the kernel ``flash_attention_fwd``); a tensor-core
  f32 route would be TF32, which the f32 tolerance does not admit.

The note at the top of ``csrc/flash_attention.cu`` says what bounds each
kernel and what its design does about that.  For CPU tensors
``flash_attention_fwd`` runs the plain PyTorch version beside it; for CUDA
tensors it launches the kernel of its route, adds one to
``flash_attention_fwd.tc_launches`` or ``.simt_launches`` and to
``.launches`` (both routes), and raises if the launch is refused.  The plain version also runs on CUDA tensors when called
directly, which is how the kernels are checked on the card.
"""

from __future__ import annotations

import torch

from repro_torch.kernels._engine import launch, on_cpu

__all__ = [
    "DTYPES",
    "HEAD_DIMS",
    "PLAIN_QUERY_CHUNK",
    "flash_attention_fwd",
    "flash_attention_fwd_plain",
]

HEAD_DIMS = (32, 64, 128)
# Operand types the kernels take.
DTYPES = (torch.float32, torch.bfloat16)
# Query rows per dense step of the plain version.
PLAIN_QUERY_CHUNK = 1024

_NEG_INF = -1.0e30
_INT32_MAX = 2**31 - 1


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if not all(isinstance(x, torch.Tensor) and x.ndim == 4 for x in (q, k, v)):
        raise ValueError("q, k and v must be 4-D (B, H, S, D) tensors")
    b, h, s, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (s, d):
        raise ValueError(f"q/k/v mismatch: {tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}")
    if k.shape[1] == 0 or h % k.shape[1]:
        raise ValueError(f"q heads {h} not a multiple of kv heads {k.shape[1]}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not supported; the kernel takes {HEAD_DIMS}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in DTYPES:
        raise TypeError(f"q, k and v must share float32 or bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must lie on one device")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")


def _scale(d: int, sm_scale: float | None) -> float:
    return sm_scale if sm_scale is not None else d ** -0.5


def flash_attention_fwd_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    sm_scale: float | None = None,
    query_chunk: int = PLAIN_QUERY_CHUNK,
) -> torch.Tensor:
    """Plain PyTorch version of K7: dense masked softmax attention in f32,
    ``query_chunk`` query rows at a time, on any device.  Each KV head's
    query group is one matrix of rows, so K and V are never repeated."""
    b, h, s, d = q.shape
    kv = k.shape[1]
    rep = h // kv
    scale = _scale(d, sm_scale)
    kf = k.float()
    vf = v.float()
    out = torch.empty_like(q)
    k_ids = torch.arange(s, device=q.device)
    for q0 in range(0, s, query_chunk):
        q1 = min(q0 + query_chunk, s)
        rows = (q1 - q0) * rep
        qc = q[:, :, q0:q1].float().reshape(b, kv, rows, d)
        logits = (qc @ kf.transpose(-1, -2)).mul_(scale)  # (B, KV, rep * chunk, S)
        q_ids = torch.arange(q0, q1, device=q.device).repeat(rep)[:, None]
        mask = torch.ones((rows, s), dtype=torch.bool, device=q.device)
        if causal:
            mask &= q_ids >= k_ids
        if window is not None:
            mask &= q_ids - k_ids < window
        hidden = ~mask
        logits.masked_fill_(hidden, _NEG_INF)
        logits.sub_(logits.amax(dim=-1, keepdim=True)).exp_().masked_fill_(hidden, 0.0)
        denom = logits.sum(dim=-1, keepdim=True)
        logits.div_(torch.where(denom == 0.0, 1.0, denom))
        out[:, :, q0:q1] = (logits @ vf).reshape(b, h, q1 - q0, d).to(q.dtype)
    return out


def _launch_args(q, k, window, sm_scale):
    b, h, s, d = q.shape
    if b * h > 65535:
        raise ValueError("batch * heads must be at most 65535")
    win = _INT32_MAX if window is None else max(-_INT32_MAX, min(int(window), _INT32_MAX))
    return b, h, k.shape[1], s, d, win, float(_scale(d, sm_scale))


def _launch(q, k, v, causal, window, sm_scale) -> torch.Tensor:
    """Launch the kernel of the inputs' route (bf16: tensor cores, f32:
    CUDA cores) on checked CUDA inputs."""
    out = torch.empty_like(q)
    if q.shape[0] == 0 or q.shape[2] == 0:
        return out
    b, h, kv, s, d, win, scale = _launch_args(q, k, window, sm_scale)
    tc = q.dtype == torch.bfloat16
    if tc:
        q, k, v = (x if x.data_ptr() % 16 == 0 else x.clone() for x in (q, k, v))  # TMA alignment
    launch(
        "flash_attention", "flash_attention_tc" if tc else "flash_attention_fwd", q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, kv, s, d,
        int(causal), win, scale,
    )
    if tc:
        flash_attention_fwd.tc_launches += 1
    else:
        flash_attention_fwd.simt_launches += 1
    flash_attention_fwd.launches += 1
    return out


def flash_attention_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    sm_scale: float | None = None,
) -> torch.Tensor:
    """K7: softmax attention of contiguous (B, H, S, D) queries over
    (B, KV, S, D) keys and values, all float32 or all bfloat16, D in
    ``HEAD_DIMS``; the result is (B, H, S, D) in q's dtype on q's device.
    bfloat16 runs on the tensor cores, float32 on the CUDA cores.

    ``causal`` hides keys after the query; ``window`` hides keys with
    q - k >= window; ``sm_scale`` defaults to D ** -0.5.  A query row that
    sees no key gives zeros.
    """
    _check(q, k, v)
    if on_cpu(q, "flash_attention_fwd"):
        return flash_attention_fwd_plain(q, k, v, causal=causal, window=window, sm_scale=sm_scale)
    return _launch(q, k, v, causal, window, sm_scale)


flash_attention_fwd.launches = 0
flash_attention_fwd.tc_launches = 0
flash_attention_fwd.simt_launches = 0
