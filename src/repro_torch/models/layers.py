"""Shared model layers: parameter makers, norms, rotary embeddings and the
attention math of prefill and decode.

Each parameter maker returns ``(tensor, logical axes)`` (see
``repro_torch.parallel.sharding``), so the axes of every parameter are
built by the same call that makes it and no rule has to match names.  The
makers draw from an explicit ``torch.Generator`` on its device; on the
``meta`` device they allocate nothing (``model.shapes_and_axes``).

The attention functions here are the plain PyTorch rendering of the
reference's XLA programs: ``blockwise_attention`` walks query and key
chunks with Python loops where the reference scans, and
``dense_attention`` serves short sequences.  On the card the model's
prefill takes the hand-written K7 instead (``blocks.attn_apply``).

The RMSNorm and RoPE have two routes, fixed by their inputs (``norm_route``),
never by a failure: plain CUDA tensors with no gradient to take, whose rows
the hand-written L4 reads in place, run one L4 pass a norm, and one a q or
k with its norm and rotation (``kernels.rms_norm``); everything else (the
CPU, DTensors under a mesh, training) runs the float32 chains below, which
the reference's XLA programs compute.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import obs
from repro_torch.kernels.rms_norm import kernel as L4
from repro_torch.parallel.sharding import is_dtensor, replicated

__all__ = [
    "ACTIVATIONS",
    "ParamBlock",
    "param_device",
    "apply_rope",
    "blockwise_attention",
    "decode_attention",
    "dense_attention",
    "dense_param",
    "layer_norm",
    "mrope_angles",
    "norm_route",
    "ones_param",
    "qk_norm_rope",
    "rms_norm",
    "rope_angles",
    "zeros_param",
]

_NEG_INF = -1.0e30

Made = tuple[torch.Tensor, tuple]


# ---------------------------------------------------------------------------
# Parameter makers (optionally stacked over a leading 'layers' axis)
# ---------------------------------------------------------------------------


def param_device(gen: torch.Generator | None, device=None) -> torch.device:
    """Where a block's parameters live: ``device`` if given, else the
    generator's (the CPU without either)."""
    if device is not None:
        return torch.device(device)
    return gen.device if gen is not None else torch.device("cpu")


class ParamBlock(nn.Module):
    """The parameters of one block kind, stacked over stages along a
    leading 'layers' axis as the reference stacks them, with their logical
    axes (``axes``, a dict parallel to the parameters and sub-blocks).

    ``block[name]`` is a parameter or sub-block; ``stage(i)`` is a dict of
    stage ``i``'s views (nested for sub-blocks), the per-stage slice the
    reference's scan hands its body; ``stage(None)`` the whole tensors.
    The apply functions take such dicts, so their bodies read as the
    reference's.  Parameters carry gradients (the training slice); the
    serving entry points run under ``torch.inference_mode()``.
    """

    def __init__(self) -> None:
        super().__init__()
        self.axes: dict = {}

    def add(self, name: str, made: Made) -> None:
        tensor, axes = made
        self.register_parameter(name, nn.Parameter(tensor))
        self.axes[name] = axes

    def add_block(self, name: str, block: "ParamBlock") -> None:
        self.add_module(name, block)
        self.axes[name] = block.axes

    def __getitem__(self, name: str):
        return getattr(self, name)

    def stage(self, i: int | None) -> dict:
        out = {}
        for name in self.axes:
            value = getattr(self, name)
            if isinstance(value, ParamBlock):
                out[name] = value.stage(i)
            else:
                out[name] = value if i is None else value[i]
        return out


def _stacked(shape, axes, stack):
    if stack is None:
        return tuple(shape), tuple(axes)
    return (stack, *shape), ("layers", *axes)


def dense_param(
    gen: torch.Generator | None,
    shape: tuple[int, ...],
    axes: tuple[str | None, ...],
    *,
    stack: int | None = None,
    scale: float | None = None,
    dtype: torch.dtype = torch.float32,
    device: torch.device | str | None = None,
) -> Made:
    """Fan-in-scaled normal parameter (std ``shape[0] ** -0.5`` unless
    ``scale``), drawn in f32 from ``gen`` on ``device`` (default: the
    generator's) and cast to ``dtype``; on ``meta``, uninitialised."""
    std = scale if scale is not None else shape[0] ** -0.5
    full_shape, full_axes = _stacked(shape, axes, stack)
    device = param_device(gen, device)
    if device.type == "meta":
        return torch.empty(full_shape, dtype=dtype, device=device), full_axes
    value = torch.randn(full_shape, generator=gen, dtype=torch.float32, device=device)
    return value.mul_(std).to(dtype), full_axes


def ones_param(shape, axes, *, stack=None, dtype=torch.float32, device=None) -> Made:
    full_shape, full_axes = _stacked(shape, axes, stack)
    return torch.ones(full_shape, dtype=dtype, device=device), full_axes


def zeros_param(shape, axes, *, stack=None, dtype=torch.float32, device=None) -> Made:
    full_shape, full_axes = _stacked(shape, axes, stack)
    return torch.zeros(full_shape, dtype=dtype, device=device), full_axes


# ---------------------------------------------------------------------------
# Norms (f32 inside, the input's type out; L4 or the float32 chain)
# ---------------------------------------------------------------------------


def norm_route(x: torch.Tensor, *others, rotate: bool = False) -> str:
    """The route of a row norm over ``x``'s last dim (with ``rotate``, of
    the q/k norm-and-rotate), its weight and tables among ``others`` (None
    skipped): ``"kernel"`` (L4) for plain CUDA tensors of which no gradient
    is to be taken and whose rows L4 reads where they lie (``L4.fits``:
    bf16 or float32, whole 16-byte vectors within its maximum, 16-byte
    aligned rows), ``"torch"`` otherwise."""
    tensors = (x, *(t for t in others if t is not None))
    if x.device.type != "cuda" or any(is_dtensor(t) for t in tensors):
        return "torch"
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return "torch"
    return "kernel" if L4.fits(x, *others, rotate=rotate) else "torch"


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last dim: one L4 pass on its route (``norm_route``),
    else the float32 chain."""
    with obs.span("model.norm"):
        if norm_route(x, weight) == "kernel":
            obs.add("norm.kernel_calls", 1)
            return L4.rms_norm_fwd(x, weight, eps)
        xf = x.float()
        var = (xf * xf).mean(dim=-1, keepdim=True)
        return (xf * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    out = (xf - mean) * torch.rsqrt(var + eps)
    return (out * weight.float() + bias.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings (standard RoPE + Qwen2-VL M-RoPE)
# ---------------------------------------------------------------------------


def _freqs(half: int, theta: float, like: torch.Tensor) -> torch.Tensor:
    """The rotary frequencies, on ``like``'s device; replicated on its mesh
    if ``like`` is a DTensor."""
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32, device=like.device) / half))
    return replicated(freqs, like.device_mesh) if is_dtensor(like) else freqs


def rope_angles(positions: torch.Tensor, head_dim: int,
                theta: float = 10000.0) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables (..., S, head_dim/2) for integer ``positions`` (..., S)."""
    ang = positions.float()[..., None] * _freqs(head_dim // 2, theta, positions)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate (B, H, S, D) ``x`` by (B, S, D/2) tables (halves, not pairs)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[:, None]
    s = sin[:, None]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def qk_norm_rope(q: torch.Tensor, k: torch.Tensor, q_weight, k_weight, cos, sin,
                 eps: float = 1e-6) -> tuple[torch.Tensor, torch.Tensor]:
    """Attention's q and k (B, H, S, D): the per-head RMSNorm with their
    weights (none if None), then RoPE by ``cos`` and ``sin`` (none if
    None).  Where both take L4's route (``norm_route``), one L4 pass each
    (``L4.qk_rope_fwd``), under ``model.rope`` when they rotate and
    ``model.norm`` when they only normalise; else ``rms_norm`` on each,
    then ``apply_rope`` on both."""
    rotate = cos is not None
    if all(norm_route(x, w, cos, sin, rotate=rotate) == "kernel"
           for x, w in ((q, q_weight), (k, k_weight))):
        with obs.span("model.rope" if rotate else "model.norm"):
            if q_weight is not None:
                obs.add("norm.kernel_calls", 2)
            if rotate:
                obs.add("rope.kernel_calls", 2)
            return (L4.qk_rope_fwd(q, q_weight, cos, sin, eps),
                    L4.qk_rope_fwd(k, k_weight, cos, sin, eps))
    if q_weight is not None:
        q = rms_norm(q, q_weight, eps)
        k = rms_norm(k, k_weight, eps)
    if rotate:
        with obs.span("model.rope"):
            q = apply_rope(q, cos, sin)
            k = apply_rope(k, cos, sin)
    return q, k


def mrope_angles(positions: torch.Tensor, head_dim: int, sections: tuple[int, int, int],
                 theta: float = 10000.0) -> tuple[torch.Tensor, torch.Tensor]:
    """Qwen2-VL multimodal RoPE: the head_dim/2 rotary frequencies split
    into 3 sections, each driven by its own stream of the (3, B, S)
    ``positions``.  Returns (B, S, D/2) cos/sin."""
    half = head_dim // 2
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {sections} must sum to head_dim/2 = {half}")
    section_id = torch.from_numpy(np.repeat(np.arange(3), sections)).to(positions.device)
    pos_per_freq = positions[section_id]  # (half, B, S): stream per freq index
    ang = torch.movedim(pos_per_freq, 0, -1).float() * _freqs(half, theta, positions)
    return torch.cos(ang), torch.sin(ang)


# ---------------------------------------------------------------------------
# Attention math: chunked (flash-style) prefill + cached decode
# ---------------------------------------------------------------------------


def _mask_chunk(q_off: int, k_off: int, q_chunk: int, k_chunk: int, causal: bool,
                window: int | None, device=None) -> torch.Tensor:
    """Visible (query, key) pairs of one chunk: q >= k if ``causal``,
    q - k < ``window`` if given."""
    q_ids = q_off + torch.arange(q_chunk, device=device)[:, None]
    k_ids = k_off + torch.arange(k_chunk, device=device)[None, :]
    mask = torch.ones((q_chunk, k_chunk), dtype=torch.bool, device=device)
    if causal:
        mask &= q_ids >= k_ids
    if window is not None:
        mask &= (q_ids - k_ids) < window
    return mask


def blockwise_attention(
    q: torch.Tensor,  # (B, H, S, D)
    k: torch.Tensor,  # (B, H, S, D)   (kv heads pre-expanded)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    q_chunk: int = 512,
    k_chunk: int = 512,
) -> torch.Tensor:
    """Online-softmax attention, chunked in both q and kv: never more than
    (B, H, q_chunk, k_chunk) of logits.  A sequence that is not a multiple
    of both chunks takes ``dense_attention``, as in the reference."""
    b, h, s, d = q.shape
    if s % q_chunk or s % k_chunk:
        return dense_attention(q, k, v, causal=causal, window=window)
    scale = d ** -0.5
    kf, vf = k.float(), v.float()
    out = torch.empty_like(q)
    for q_off in range(0, s, q_chunk):
        q_blk = q[:, :, q_off:q_off + q_chunk].float()
        m = torch.full((b, h, q_chunk, 1), _NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((b, h, q_chunk, 1), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, h, q_chunk, d), dtype=torch.float32, device=q.device)
        for k_off in range(0, s, k_chunk):
            s_blk = (q_blk @ kf[:, :, k_off:k_off + k_chunk].transpose(-1, -2)) * scale
            mask = _mask_chunk(q_off, k_off, q_chunk, k_chunk, causal, window, q.device)
            s_blk = torch.where(mask, s_blk, _NEG_INF)
            m_new = torch.maximum(m, s_blk.amax(dim=-1, keepdim=True))
            p = torch.where(mask, torch.exp(s_blk - m_new), 0.0)
            alpha = torch.exp(m - m_new)
            l = alpha * l + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + p @ vf[:, :, k_off:k_off + k_chunk]
            m = m_new
        l = torch.where(l == 0.0, 1.0, l)
        out[:, :, q_off:q_off + q_chunk] = (acc / l).to(q.dtype)
    return out


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None) -> torch.Tensor:
    """Dense masked softmax attention in f32 (short sequences)."""
    s, d = q.shape[2], q.shape[3]
    logits = (q.float() @ k.float().transpose(-1, -2)) * d ** -0.5
    mask = _mask_chunk(0, 0, s, s, causal, window, q.device)
    probs = torch.softmax(torch.where(mask, logits, _NEG_INF), dim=-1)
    return (probs @ v.float()).to(q.dtype)


def decode_attention(
    q: torch.Tensor,  # (B, H, 1, D)
    k_cache: torch.Tensor,  # (B, KV, S_max, D)
    v_cache: torch.Tensor,
    pos,  # int, () or (B,): the new token's position
    *,
    window: int | None = None,
) -> torch.Tensor:
    """One query token against a KV cache whose slot i holds position i."""
    b, h, _, d = q.shape
    kv = k_cache.shape[1]
    qg = q.reshape(b, kv, h // kv, d).float()
    logits = (qg @ k_cache.float().transpose(-1, -2)) * d ** -0.5  # (B, KV, rep, S_max)
    k_ids = torch.arange(k_cache.shape[2], device=q.device)
    pos_b = torch.as_tensor(pos, device=q.device).broadcast_to((b,))[:, None]
    valid = k_ids[None, :] <= pos_b
    if window is not None:
        valid &= (pos_b - k_ids[None, :]) < window
    probs = torch.softmax(torch.where(valid[:, None, None, :], logits, _NEG_INF), dim=-1)
    return (probs @ v_cache.float()).reshape(b, h, 1, d).to(q.dtype)


# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------

ACTIVATIONS: dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
}
