"""L4: RMSNorm over rows in one pass, and the q/k norm-and-rotate; its
wrapper and plain versions.

L4 replaces no TPU kernel: the JAX package leaves ``rms_norm`` and
``apply_rope`` to XLA (``src/repro/models/layers.py:76``).  Both entry
points launch ``rms_norm_rows`` of ``csrc/rms_norm.cu``:

* ``rms_norm_fwd(x, weight, eps)``: each row of x's last dim scaled by
  ``rsqrt(mean(x^2) + eps)`` and by ``weight``, in float32, rounded once
  to x's type; x's rows read where they lie, y contiguous.
* ``qk_rope_fwd(x, weight, cos, sin, eps)``: q or k (B, H, S, hd) with any
  batch, head and token strides (the einsum's permuted view): the per-head
  RMSNorm with ``weight`` (or none), rounded to x's type as the torch route
  rounds it, then the rotation of its halves by (B, S, hd/2) float32
  ``cos`` and ``sin`` (or none); y contiguous (B, H, S, hd).

For CPU tensors they run the plain versions beside them; for CUDA tensors
they launch the kernel, add one to their ``.launches`` and raise where the
tensors are out of the kernel's contract (``fits``) or a launch is
refused.  The plain versions also run on CUDA tensors when called
directly, which is how the kernel is checked on the card.  The note at the
top of the ``.cu`` file says what bounds the kernel and what its design
does about that.
"""

from __future__ import annotations

import torch

from repro_torch.kernels._engine import launch, on_cpu

__all__ = [
    "ALIGN",
    "DTYPES",
    "MAX_ROWS",
    "MAX_VECTORS",
    "ROPE_MAX_VECTORS",
    "fits",
    "qk_rope_fwd",
    "qk_rope_fwd_plain",
    "rms_norm_fwd",
    "rms_norm_fwd_plain",
    "row_layout",
]

# The kernel's contract: x and the weight in one of DTYPES; fewer than
# MAX_ROWS rows (its index arithmetic is 32-bit) of whole 16-byte vectors
# (8 bf16 or 4 floats), at most MAX_VECTORS of them (a block of 512
# threads, 8 a thread), whose base and strides are multiples of ALIGN
# bytes; with the rotation, each half at most ROPE_MAX_VECTORS (one warp's
# lanes).
DTYPES = (torch.bfloat16, torch.float32)
ALIGN = 16
MAX_ROWS = 2**31
MAX_VECTORS = 4096
ROPE_MAX_VECTORS = 32

_TYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}


def _vector(dtype: torch.dtype) -> int:
    """Elements of one 16-byte load."""
    return ALIGN // dtype.itemsize


def row_layout(x: torch.Tensor) -> tuple[tuple[int, ...], tuple[int, ...]] | None:
    """x's leading dims as three (n0, n1, n2) with their strides in elements,
    dims that nest in memory merged and ones of size 1 dropped; None where
    more than three remain."""
    sizes, strides = [], []
    for n, st in zip(x.shape[:-1], x.stride()[:-1]):
        if n == 1:
            continue
        if sizes and strides[-1] == st * n:
            sizes[-1] *= n
            strides[-1] = st
        else:
            sizes.append(n)
            strides.append(st)
    if len(sizes) > 3:
        return None
    pad = 3 - len(sizes)
    return (1,) * pad + tuple(sizes), (0,) * pad + tuple(strides)


def _aligned(x: torch.Tensor, sizes, strides) -> bool:
    """x's base and the strides of its dims longer than 1 on 16-byte bounds."""
    return x.data_ptr() % ALIGN == 0 and all(
        n == 1 or st * x.element_size() % ALIGN == 0 for n, st in zip(sizes, strides))


def fits(x: torch.Tensor, weight=None, cos=None, sin=None, *, rotate: bool = False) -> bool:
    """Whether L4 reads ``x``'s rows where they lie: x and ``weight`` in
    ``DTYPES``, ``cos`` and ``sin`` float32; x's last dim contiguous and a
    whole number of vectors (of two with ``rotate``: one a half) within the
    maximum; fewer than ``MAX_ROWS`` rows; at most three leading dims after merging (with ``rotate``,
    (B, H, S, hd) itself); base and strides 16-byte aligned."""
    if x.dtype not in DTYPES or x.ndim < 1 or (rotate and x.ndim != 4):
        return False
    if weight is not None and weight.dtype not in DTYPES:
        return False
    if any(t is not None and t.dtype != torch.float32 for t in (cos, sin)):
        return False
    d, vec = x.shape[-1], _vector(x.dtype)
    limit = 2 * ROPE_MAX_VECTORS if rotate else MAX_VECTORS
    if d == 0 or d % (2 * vec if rotate else vec) or d // vec > limit or x.stride(-1) != 1:
        return False
    if x.numel() // d >= MAX_ROWS:
        return False
    layout = (x.shape[:3], x.stride()[:3]) if rotate else row_layout(x)
    return layout is not None and _aligned(x, *layout)


def rms_norm_fwd_plain(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Plain PyTorch version of ``rms_norm_fwd`` on any device: the float32
    chain, rounded to x's type once, contiguous."""
    xf = x.float()
    r = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (xf * r * weight.float()).to(x.dtype).contiguous()


def qk_rope_fwd_plain(x: torch.Tensor, weight, cos, sin, eps: float = 1e-6) -> torch.Tensor:
    """Plain PyTorch version of ``qk_rope_fwd`` on any device: the norm
    rounded to x's type, then each half's products and sums in float32,
    rounded once; contiguous (B, H, S, hd)."""
    if weight is not None:
        x = rms_norm_fwd_plain(x, weight, eps)
    if cos is None:
        return x.contiguous()
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c, s = cos[:, None], sin[:, None]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype).contiguous()


def _check(x, weight, cos, sin, rotate: bool) -> None:
    tensors = [t for t in (x, weight, cos, sin) if t is not None]
    if not all(isinstance(t, torch.Tensor) for t in tensors):
        raise TypeError("every operand must be a tensor")
    if x.ndim < 1 or (rotate and x.ndim != 4):
        raise ValueError(f"x must be (..., d), and (B, H, S, hd) to rotate: {tuple(x.shape)}")
    d = x.shape[-1]
    if weight is not None and weight.shape != (d,):
        raise ValueError(f"weight must be ({d},): {tuple(weight.shape)}")
    if rotate:
        if sin is None or d % 2:
            raise ValueError(f"cos and sin go together, over an even head dim: {d}")
        want = (x.shape[0], x.shape[2], d // 2)
        for t in (cos, sin):
            if t.ndim != 3 or t.shape[1:] != want[1:] or t.shape[0] not in (1, want[0]):
                raise ValueError(f"cos and sin must be (B, S, hd/2) = {want}: {tuple(t.shape)}")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("the operands must lie on one device")


def _contiguous_aligned(t: torch.Tensor) -> torch.Tensor:
    if t.is_contiguous() and t.data_ptr() % ALIGN == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _launch(x, weight, cos, sin, eps, rotate: bool) -> torch.Tensor:
    if not fits(x, weight, cos, sin, rotate=rotate):
        raise ValueError(
            f"the kernel takes fewer than {MAX_ROWS} {DTYPES} rows (float32 tables) of whole "
            f"16-byte vectors, at most {2 * ROPE_MAX_VECTORS if rotate else MAX_VECTORS} of them, "
            f"the last dim contiguous, 16-byte aligned, at most three leading dims: {x.dtype} "
            f"{tuple(x.shape)} {tuple(x.stride())}")
    dims, strides = (tuple(x.shape[:3]), tuple(x.stride()[:3])) if rotate else row_layout(x)
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    w_ptr, w_code = None, -1
    if weight is not None:
        weight = _contiguous_aligned(weight)
        w_ptr, w_code = weight.data_ptr(), _TYPE_CODE[weight.dtype]
    c_ptr = s_ptr = None
    c_strides = (0, 0)
    if rotate:
        b, _, s, _ = x.shape
        cos, sin = (t.expand(b, s, t.shape[-1]) for t in (cos, sin))
        if (cos.stride() != sin.stride() or cos.stride(-1) != 1
                or not all(_aligned(t, t.shape[:2], t.stride()[:2]) for t in (cos, sin))):
            cos, sin = cos.contiguous(), sin.contiguous()
        c_ptr, s_ptr, c_strides = cos.data_ptr(), sin.data_ptr(), cos.stride()[:2]
    launch("rms_norm", "rms_norm_rows", x.device, x.data_ptr(), w_ptr, c_ptr, s_ptr, y.data_ptr(),
           dims[0] * dims[1] * dims[2], dims[1], dims[2], *strides, *c_strides, x.shape[-1],
           float(eps), _TYPE_CODE[x.dtype], w_code, int(rotate))
    return y


def rms_norm_fwd(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """L4: the RMSNorm of each row of x's last dim with (d,) ``weight``, in
    float32, rounded once to x's type; contiguous, x's shape.

    On a CUDA device x's rows must be what ``fits`` takes (any leading
    strides, 16-byte aligned); out of that contract a CUDA call raises; a
    CPU call runs the plain version."""
    _check(x, weight, None, None, False)
    if on_cpu(x, "rms_norm_fwd"):
        return rms_norm_fwd_plain(x, weight, eps)
    y = _launch(x, weight, None, None, eps, False)
    rms_norm_fwd.launches += 1
    return y


def qk_rope_fwd(x: torch.Tensor, weight, cos, sin, eps: float = 1e-6) -> torch.Tensor:
    """L4 on q or k, (B, H, S, hd) with any batch, head and token strides:
    the per-head RMSNorm with (hd,) ``weight`` rounded to x's type (none if
    ``weight`` is None), then the rotation of the halves by (B, S, hd/2)
    float32 ``cos`` and ``sin`` (none if ``cos`` is None); contiguous
    (B, H, S, hd) in x's type.

    On a CUDA device x must be what ``fits`` takes (``rotate``: each half
    whole vectors, at most ``ROPE_MAX_VECTORS``); out of that contract a
    CUDA call raises; a CPU call runs the plain version."""
    rotate = cos is not None
    if weight is None and not rotate:
        raise ValueError("qk_rope_fwd needs a weight, tables or both")
    _check(x, weight, cos, sin, rotate)
    if on_cpu(x, "qk_rope_fwd"):
        return qk_rope_fwd_plain(x, weight, cos, sin, eps)
    if rotate:
        y = _launch(x, weight, cos, sin, eps, True)
    else:  # the norm alone: (B, H, S) are any three leading dims
        y = _launch(x, weight, None, None, eps, False)
    qk_rope_fwd.launches += 1
    return y


rms_norm_fwd.launches = 0
qk_rope_fwd.launches = 0
