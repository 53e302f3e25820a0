"""L3: Mamba's selective scan, forward; its wrapper and plain version.

L3 replaces no TPU kernel: the JAX package scans Mamba's state with
``lax.associative_scan``, an XLA program (``src/repro/models/ssm.py``).
Per channel d and state n, over the tokens in order::

    delta_t = softplus(dt_t + dt_bias)
    h_t     = exp(delta_t * A[d, n]) * h_{t-1} + delta_t * u_t * B_t[n]
    y_t     = (sum_n h_t[n] * C_t[n] + D * u_t) * silu(z_t)

from a zero state.  ``selective_scan_fwd`` launches the kernel
``selective_scan_fwd`` of ``csrc/selective_scan.cu`` for CUDA tensors,
counting it on ``selective_scan_fwd.launches``, and runs the plain
version beside it for CPU tensors; the plain version also runs on CUDA
tensors when called directly, which is how the kernel is checked on the
card.  The note at the top of the ``.cu`` file says what bounds the
kernel and what its design does about that.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels._engine import launch, on_cpu

__all__ = [
    "CHANNEL_MULTIPLE",
    "DTYPES",
    "MAX_BATCH",
    "PLAIN_CHUNK",
    "STATE_SIZES",
    "selective_scan_fwd",
    "selective_scan_fwd_plain",
]

# The kernel's contract: one type for u, dt, z, B and C; d_inner a
# multiple of a block's channels; N its registers' states; the batch
# within the grid's y dimension.
DTYPES = (torch.float32, torch.bfloat16)
CHANNEL_MULTIPLE = 16
STATE_SIZES = (16,)
MAX_BATCH = 65535
# Tokens a step of the plain version takes at once.
PLAIN_CHUNK = 64

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}


def selective_scan_fwd_plain(u, dt, z, b, c, a, d, dt_bias, *, chunk: int = PLAIN_CHUNK):
    """Plain PyTorch version of L3 on any device, in float32 (in float64
    for float64 inputs): ``chunk`` tokens' decays and inputs at once, then
    the recurrence token by token, as the kernel stages them.  Shapes and
    result as ``selective_scan_fwd``."""
    work = torch.float64 if u.dtype == torch.float64 else torch.float32
    bsz, s, di = u.shape
    uf = u.to(work)
    delta = F.softplus(dt.to(work) + dt_bias.to(work))
    du = delta * uf
    a = a.to(work)
    h = torch.zeros((bsz, di, a.shape[-1]), dtype=work, device=u.device)
    y = torch.empty((bsz, s, di), dtype=work, device=u.device)
    for c0 in range(0, s, chunk):
        c1 = min(c0 + chunk, s)
        decay = torch.exp(delta[:, c0:c1, :, None] * a)  # (B, c, di, N)
        inp = du[:, c0:c1, :, None] * b[:, c0:c1, None, :].to(work)
        states = torch.empty_like(decay)
        for t in range(c1 - c0):
            h = torch.addcmul(inp[:, t], decay[:, t], h)
            states[:, t] = h
        y[:, c0:c1] = torch.einsum("bcdn,bcn->bcd", states, c[:, c0:c1].to(work))
    return ((y + d.to(work) * uf) * F.silu(z.to(work))).to(u.dtype)


def _check(u, dt, z, b, c, a, d, dt_bias) -> None:
    tensors = (u, dt, z, b, c, a, d, dt_bias)
    if not all(isinstance(x, torch.Tensor) for x in tensors):
        raise TypeError("every operand must be a tensor")
    if u.ndim != 3 or dt.shape != u.shape or z.shape != u.shape:
        raise ValueError(f"u, dt and z must be (B, S, d_inner) of one shape: "
                         f"{tuple(u.shape)} {tuple(dt.shape)} {tuple(z.shape)}")
    bsz, s, di = u.shape
    n = a.shape[-1] if a.ndim == 2 else -1
    if a.shape != (di, n) or b.shape != (bsz, s, n) or c.shape != (bsz, s, n):
        raise ValueError(f"A must be (d_inner, N) and B, C (B, S, N): {tuple(a.shape)} "
                         f"{tuple(b.shape)} {tuple(c.shape)}")
    if d.shape != (di,) or dt_bias.shape != (di,):
        raise ValueError(f"D and dt_bias must be (d_inner,): {tuple(d.shape)} {tuple(dt_bias.shape)}")
    if len({x.device for x in tensors}) != 1:
        raise ValueError("the operands must lie on one device")
    if len({u.dtype, dt.dtype, z.dtype, b.dtype, c.dtype}) != 1:
        raise TypeError(f"u, dt, z, B and C must share a type, got "
                        f"{[x.dtype for x in (u, dt, z, b, c)]}")


def _launch(u, dt, z, b, c, a, d, dt_bias) -> torch.Tensor:
    bsz, s, di = u.shape
    if u.dtype not in DTYPES:
        raise TypeError(f"the kernel takes {DTYPES}, got {u.dtype}")
    if di % CHANNEL_MULTIPLE or a.shape[-1] not in STATE_SIZES:
        raise ValueError(f"the kernel takes d_inner a multiple of {CHANNEL_MULTIPLE} and N in "
                         f"{STATE_SIZES}, got {di} and {a.shape[-1]}")
    if bsz > MAX_BATCH:
        raise ValueError(f"the kernel takes at most {MAX_BATCH} sequences, got {bsz}")
    # the last dim of each operand contiguous; batch and token strides free
    u, dt, z, b, c = (x if x.stride(-1) == 1 else x.contiguous() for x in (u, dt, z, b, c))
    a, d, dt_bias = (x.float().contiguous() for x in (a, d, dt_bias))
    y = torch.empty((bsz, s, di), dtype=u.dtype, device=u.device)
    if y.numel() == 0:
        return y
    strides = [st for x in (u, dt, z, b, c) for st in x.stride()[:2]]
    launch("selective_scan", "selective_scan_fwd", u.device,
           u.data_ptr(), dt.data_ptr(), z.data_ptr(), b.data_ptr(), c.data_ptr(), a.data_ptr(),
           d.data_ptr(), dt_bias.data_ptr(), y.data_ptr(), bsz, s, di, *strides,
           _DTYPE_CODE[u.dtype])
    selective_scan_fwd.launches += 1
    return y


def selective_scan_fwd(u, dt, z, b, c, a, d, dt_bias) -> torch.Tensor:
    """L3: the selective scan of (B, S, d_inner) ``u`` (the convolution's
    activations), ``dt`` (dt_proj's product, before its bias), ``z`` (the
    gate) and (B, S, N) ``b`` and ``c``, all of one type, with (d_inner,
    N) ``a`` = -exp(A_log) and (d_inner,) ``d`` and ``dt_bias`` (used in
    float32); (B, S, d_inner) ``y`` in u's type, from a zero state.

    On a CUDA device u, dt, z, B and C are float32 or bfloat16, d_inner a
    multiple of ``CHANNEL_MULTIPLE`` and N in ``STATE_SIZES``; any batch
    and token strides, the last dim contiguous (else copied).  Out of that
    contract a CUDA call raises; a CPU call runs the plain version."""
    _check(u, dt, z, b, c, a, d, dt_bias)
    if on_cpu(u, "selective_scan_fwd"):
        return selective_scan_fwd_plain(u, dt, z, b, c, a, d, dt_bias)
    return _launch(u, dt, z, b, c, a, d, dt_bias)


selective_scan_fwd.launches = 0
