"""K7: fused attention forward, its routes and its plain versions.

K7 replaces ``flash_attention_pallas``
(``src/repro/kernels/flash_attention/kernel.py``): causal and sliding-window
softmax attention with an online softmax in f32, over (B, H, S, D) queries
and (B, KV, S, D) keys and values, query head h reading KV head
h // (H // KV).  Both types run on the tensor cores (wgmma fed by TMA);
``flash_attention_fwd`` takes one of two routes, fixed by the type alone,
never by a failure (``attention_route``):

* ``"tc"``, bf16: the kernel ``flash_attention_tc``.  The TPU kernel
  multiplied the softmax weights P in f32; wgmma takes them in bf16, so the
  kernel carries P as two bf16 terms, hi + lo (one rounding alone would
  leave the bf16 tolerance on rows that see few keys).
* ``"tf32"``, f32: the kernel ``flash_attention_tf32``, after the prep
  kernel ``attention_operand_planes`` (launched in the same call) has
  written TF32 big and small planes of K and of V transposed, V's keys in
  the order 0, 2, 4, 6, 1, 3, 5, 7 within each group of 8.  Both products
  are three TF32 products, S = Q_s K_b + Q_b K_s + Q_b K_b and P V alike
  (Q and P are split in the kernel), which meet the f32 tolerance where
  one TF32 product would not.

The note at the top of ``csrc/flash_attention.cu`` says what bounds each
kernel and what its design does about that.  For CPU tensors
``flash_attention_fwd`` and ``attention_operand_planes`` run the plain
PyTorch versions beside them; for CUDA tensors they launch their kernels,
add one to the counts on ``flash_attention_fwd`` (``tc_launches``,
``tf32_launches``, ``prep_launches`` for the planes, and ``launches`` for
both attention routes), and raise if a launch is refused.  The plain
versions also run on CUDA tensors when called directly, which is how the
kernels are checked on the card.
"""

from __future__ import annotations

import torch

from repro_torch.kernels._engine import launch, on_cpu
from repro_torch.kernels.ws_matmul.kernel import tf32_planes

__all__ = [
    "DTYPES",
    "HEAD_DIMS",
    "KEY_ORDER",
    "PLAIN_QUERY_CHUNK",
    "PLANE_KEYS",
    "attention_operand_planes",
    "attention_operand_planes_plain",
    "attention_route",
    "flash_attention_fwd",
    "flash_attention_fwd_plain",
]

HEAD_DIMS = (32, 64, 128)
# Operand types the kernels take.
DTYPES = (torch.float32, torch.bfloat16)
# Query rows per dense step of the plain version.
PLAIN_QUERY_CHUNK = 1024
# V^T's planes pad the keys to a multiple of this (one 128-byte row of f32).
PLANE_KEYS = 32
# The key at each position of a group of 8 in V^T's planes: the S
# accumulator gives a thread keys 2t and 2t + 1, the TF32 A fragment of P
# takes columns t and t + 4.
KEY_ORDER = (0, 2, 4, 6, 1, 3, 5, 7)

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
    """Plain PyTorch version of K7: dense masked softmax attention in f32
    (in float64 for float64 inputs, the checks' exact rendering),
    ``query_chunk`` query rows at a time, on any device.  Each KV head's
    query group is one matrix of rows, so K and V are never repeated."""
    b, h, s, d = q.shape
    kv = k.shape[1]
    rep = h // kv
    scale = _scale(d, sm_scale)
    work = torch.float64 if q.dtype == torch.float64 else torch.float32
    kf = k.to(work)
    vf = v.to(work)
    out = torch.empty_like(q)
    k_ids = torch.arange(s, device=q.device)
    for q0 in range(0, s, query_chunk):
        q1 = min(q0 + query_chunk, s)
        rows = (q1 - q0) * rep
        qc = q[:, :, q0:q1].to(work).reshape(b, kv, rows, d)
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


def attention_route(dtype: torch.dtype) -> str:
    """The route a CUDA ``flash_attention_fwd`` of ``dtype`` inputs takes:
    ``"tc"`` for bf16, ``"tf32"`` (three TF32 products) for f32."""
    if dtype not in DTYPES:
        raise TypeError(f"no attention route for {dtype}")
    return "tc" if dtype == torch.bfloat16 else "tf32"


def _plane_keys(s: int) -> int:
    return -(-s // PLANE_KEYS) * PLANE_KEYS


def attention_operand_planes_plain(k: torch.Tensor, v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the prep kernel, on any device: for f32
    (B, KV, S, D) ``k`` and ``v``, K's TF32 big and small planes as (2, B·KV,
    S, D) and V's transposed as (2, B·KV, D, Sp), Sp = S rounded up to
    ``PLANE_KEYS`` with zeros past S, each group of 8 keys in ``KEY_ORDER``
    (the split is ``ws_matmul.kernel.tf32_planes``)."""
    b, kv, s, d = k.shape
    sp = _plane_keys(s)
    vt = torch.nn.functional.pad(v.reshape(b * kv, s, d), (0, 0, 0, sp - s)).transpose(1, 2)
    vt = vt.reshape(b * kv, d, sp // 8, 8)[..., list(KEY_ORDER)].reshape(b * kv, d, sp)
    return tf32_planes(k.reshape(b * kv, s, d).contiguous()), tf32_planes(vt.contiguous())


def _aligned(*xs: torch.Tensor):
    """The tensors, each cloned if its data is not 16-byte aligned (TMA,
    and the prep kernel's 16-byte loads; a view at an offset may not be)."""
    return tuple(x if x.data_ptr() % 16 == 0 else x.clone() for x in xs)


def attention_operand_planes(k: torch.Tensor, v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The f32 route's operand planes of ``k`` and ``v`` (see the plain
    version)."""
    if not (isinstance(k, torch.Tensor) and isinstance(v, torch.Tensor) and k.ndim == 4
            and k.shape == v.shape):
        raise ValueError("k and v must be 4-D (B, KV, S, D) tensors of one shape")
    if k.dtype != torch.float32 or v.dtype != torch.float32:
        raise TypeError(f"the planes are of float32 k and v, got {k.dtype}, {v.dtype}")
    if k.shape[3] not in HEAD_DIMS:
        raise ValueError(f"head dim {k.shape[3]} not supported; the kernel takes {HEAD_DIMS}")
    if k.device != v.device or not (k.is_contiguous() and v.is_contiguous()):
        raise ValueError("k and v must be contiguous on one device")
    if on_cpu(k, "attention_operand_planes"):
        return attention_operand_planes_plain(k, v)
    b, kv, s, d = k.shape
    k_planes = torch.empty((2, b * kv, s, d), dtype=torch.float32, device=k.device)
    vt_planes = torch.empty((2, b * kv, d, _plane_keys(s)), dtype=torch.float32, device=k.device)
    if k.numel():
        k, v = _aligned(k, v)
        launch("flash_attention", "attention_operand_planes", k.device,
               k.data_ptr(), v.data_ptr(), k_planes.data_ptr(), vt_planes.data_ptr(), b * kv, s, d)
        flash_attention_fwd.prep_launches += 1
    return k_planes, vt_planes


def _launch(q, k, v, causal, window, sm_scale) -> torch.Tensor:
    """Launch the kernel of the inputs' route on checked CUDA inputs (the
    f32 route runs the prep kernel first, into scratch planes)."""
    out = torch.empty_like(q)
    if q.shape[0] == 0 or q.shape[2] == 0:
        return out
    b, h, s, d = q.shape
    kv = k.shape[1]
    win = _INT32_MAX if window is None else max(-_INT32_MAX, min(int(window), _INT32_MAX))
    scale = float(_scale(d, sm_scale))
    q, k, v = _aligned(q, k, v)
    if attention_route(q.dtype) == "tc":
        launch("flash_attention", "flash_attention_tc", q.device,
               q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, kv, s, d,
               int(causal), win, scale)
        flash_attention_fwd.tc_launches += 1
    else:
        # scratch for the planes; freed on return, it is reused only by work
        # queued after the kernel on this stream (the caching allocator)
        planes = torch.empty(2 * b * kv * d * (s + _plane_keys(s)), dtype=torch.float32,
                             device=q.device)
        launch("flash_attention", "flash_attention_tf32", q.device,
               q.data_ptr(), k.data_ptr(), v.data_ptr(), planes.data_ptr(), out.data_ptr(),
               b, h, kv, s, d, int(causal), win, scale)
        flash_attention_fwd.prep_launches += 1
        flash_attention_fwd.tf32_launches += 1
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
    Both run on the tensor cores: bfloat16 with P as two bf16 terms,
    float32 as three TF32 products (``attention_route``).

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
flash_attention_fwd.tf32_launches = 0
flash_attention_fwd.prep_launches = 0
