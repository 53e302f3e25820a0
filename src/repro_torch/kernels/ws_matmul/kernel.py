"""K6: the weight-stationary GEMM, its routes and its plain versions.

K6 replaces ``ws_matmul_pallas`` (``src/repro/kernels/ws_matmul/kernel.py``):
``a @ w`` with K innermost and a wide accumulator, int8/int16 -> int32
(wrapping mod 2^32, as the TPU's int32 accumulator does) and bf16/f32 ->
f32.  Every type runs on the tensor cores, in the kernel ``ws_gemm_tc``
(wgmma fed by TMA); ``ws_gemm`` takes one of two routes into it, fixed by
type and shape alone (``gemm_route``), never by a failure:

* ``"tc"``: int8 and int16, after the prep kernel ``gemm_operand_planes``
  has written their int8 planes (K zero-padded to a multiple of 32, w
  transposed; int16 as hi/lo planes whose four products recombine exactly
  mod 2^32); bf16 as it is when its rows are 16-byte multiples (K % 8 ==
  0 and N % 8 == 0), as TMA requires.
* ``"tf32"``: f32 and the other bf16, from f32 planes written by the same
  prep kernel.  An f32 value is split into a TF32 ``big`` and a TF32
  ``small`` part and a product is the sum of three TF32 products,
  a_s.w_b + a_b.w_s + a_b.w_b, within about 3 * 2^-22 * |a| @ |w| of the
  f32 product: one TF32 product alone would not meet the f32 tolerance.
  bf16 is exact in TF32, so it takes one plane and one product.

The note at the top of ``csrc/ws_matmul.cu`` says what bounds the kernels
and what their design does about that.  For CPU tensors ``ws_gemm`` and
``gemm_operand_planes`` run the plain PyTorch version beside them; for
CUDA tensors they launch their kernel, add one to its count on
``ws_gemm`` (``tc_launches``, ``tf32_launches``, and ``prep_launches``
for the planes; ``launches`` counts both GEMM routes), and raise if the
launch is refused.  The plain versions also run on CUDA tensors when
called directly, which is how the kernels are checked on the card.
"""

from __future__ import annotations

import torch

from repro_torch.kernels._engine import launch, on_cpu
from repro_torch.kernels.ws_matmul.ref import wrap_int32

__all__ = [
    "DTYPE_CODES",
    "EXACT_CHUNK_K",
    "PLANE_K",
    "gemm_operand_planes",
    "gemm_operand_planes_plain",
    "gemm_route",
    "round_tf32",
    "tf32_planes",
    "ws_gemm",
    "ws_gemm_plain",
]

# Operand types the kernel takes, by the code its C entry point reads, and
# the result type of each.
DTYPE_CODES = {torch.int8: 0, torch.int16: 1, torch.bfloat16: 2, torch.float32: 3}
_OUT_DTYPE = {torch.int8: torch.int32, torch.int16: torch.int32,
              torch.bfloat16: torch.float32, torch.float32: torch.float32}
# The element type of each operand type's planes.
_PLANE_DTYPE = {torch.int8: torch.int8, torch.int16: torch.int8,
                torch.bfloat16: torch.float32, torch.float32: torch.float32}

# The operand planes pad K to a multiple of this (the int8 wgmma's depth, and
# the TF32 values in one 128-byte row).
PLANE_K = 32

# Reduction rows per float64 product in the plain integer version: int16
# products are below 2^30 in magnitude, so a chunk's sums stay below 2^52
# and every float64 partial sum is an exact integer.
EXACT_CHUNK_K = 1 << 22


def _check(a: torch.Tensor, w: torch.Tensor) -> None:
    if not isinstance(a, torch.Tensor) or not isinstance(w, torch.Tensor):
        raise TypeError("a and w must be tensors")
    if a.ndim != 2 or w.ndim != 2 or a.shape[1] != w.shape[0]:
        raise ValueError(f"bad shapes {tuple(a.shape)} x {tuple(w.shape)}")
    if a.dtype != w.dtype or a.dtype not in DTYPE_CODES:
        raise TypeError(
            f"a and w must share one of {sorted(map(str, DTYPE_CODES))}, got {a.dtype}, {w.dtype}"
        )
    if a.device != w.device:
        raise ValueError(f"a is on {a.device} but w on {w.device}")
    if not (a.is_contiguous() and w.is_contiguous()):
        raise ValueError("a and w must be contiguous")
    if max(a.shape + w.shape) >= 2**31:
        raise ValueError("dimensions must be below 2^31")


def ws_gemm_plain(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K6, on any device.

    Integers: float64 products of ``EXACT_CHUNK_K`` reduction rows at a time
    (exact; PyTorch has no CUDA integer matmul), summed in int64 and wrapped
    to int32.  Floats: an f32 matmul (full f32 unless the caller enables
    TF32).
    """
    if a.dtype.is_floating_point:
        return a.to(torch.float32) @ w.to(torch.float32)
    k = a.shape[1]
    out = torch.zeros((a.shape[0], w.shape[1]), dtype=torch.int64, device=a.device)
    for k0 in range(0, k, EXACT_CHUNK_K):
        part = a[:, k0 : k0 + EXACT_CHUNK_K].double() @ w[k0 : k0 + EXACT_CHUNK_K].double()
        out += part.to(torch.int64)
    return wrap_int32(out)


def gemm_route(dtype: torch.dtype, m: int, k: int, n: int) -> str:
    """The route a CUDA ``ws_gemm`` of (m, k) @ (k, n) operands of ``dtype``
    takes into the tensor-core kernel: ``"tc"`` for int8 and int16 (int8
    planes), and for bf16 whose rows are 16-byte multiples (K % 8 == 0 and
    N % 8 == 0, as TMA requires); ``"tf32"`` (TF32 planes) for f32 and other
    bf16."""
    if dtype not in DTYPE_CODES:
        raise TypeError(f"no GEMM route for {dtype}")
    if dtype in (torch.int8, torch.int16):
        return "tc"
    if dtype == torch.bfloat16 and k % 8 == 0 and n % 8 == 0:
        return "tc"
    return "tf32"


def _plane_count(dtype: torch.dtype) -> int:
    return 2 if dtype in (torch.int16, torch.float32) else 1


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """Finite f32 values rounded to the nearest TF32 value (the low 13
    mantissa bits zero), ties away from zero, as ``cvt.rna.tf32.f32``; a
    value that would round to inf is truncated instead."""
    bits = x.contiguous().view(torch.int32)
    up = (bits + 0x1000) & ~0x1FFF
    to_inf = (up & 0x7FFFFFFF) == 0x7F800000
    return torch.where(to_inf, bits & ~0x1FFF, up).view(torch.float32)


def tf32_planes(x: torch.Tensor) -> torch.Tensor:
    """(2, ...) f32 planes big and small of f32 ``x``: big = x rounded to
    TF32, small = (x - big) rounded to TF32 (the difference is exact); a
    non-finite x goes whole into small and big keeps its sign as +-1, so
    that a_s.w_b + a_b.w_s + a_b.w_b gives inf and NaN as ``a * w`` does."""
    finite = torch.isfinite(x)
    x0 = torch.where(finite, x, 0.0)
    big = round_tf32(x0)
    small = round_tf32(x0 - big)
    return torch.stack([torch.where(finite, big, torch.ones_like(x).copysign(x)),
                        torch.where(finite, small, x)])


def gemm_operand_planes_plain(a: torch.Tensor, w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the prep kernel, on any device: planes
    (P, M, Kp) of ``a`` and (P, N, Kp) of ``w`` transposed, K zero-padded to
    Kp, a multiple of ``PLANE_K``.  int8 gives one int8 plane (the values);
    int16 two, hi = x >> 8 (read as s8) and lo = x & 0xFF (its bits stored
    in int8, read as u8), so x = hi * 2^8 + lo; bf16 one f32 plane (the
    values, exact in TF32); f32 two f32 planes, big and small
    (``tf32_planes``)."""
    k = a.shape[1]
    kp = -(-k // PLANE_K) * PLANE_K
    out = []
    for x in (a, w.t()):
        x = torch.nn.functional.pad(x, (0, kp - k))
        if x.dtype == torch.int8:
            out.append(x.unsqueeze(0).contiguous())
        elif x.dtype == torch.int16:
            x = x.to(torch.int32)
            lo = (x & 0xFF) - ((x & 0x80) << 1)  # the low byte's bits as an int8
            out.append(torch.stack([x >> 8, lo]).to(torch.int8))
        elif x.dtype == torch.bfloat16:
            out.append(x.float().unsqueeze(0).contiguous())
        else:
            out.append(tf32_planes(x.contiguous()))
    return out[0], out[1]


def gemm_operand_planes(a: torch.Tensor, w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The planes of the operands (see the plain version)."""
    _check(a, w)
    if on_cpu(a, "gemm_operand_planes"):
        return gemm_operand_planes_plain(a, w)
    m, k = a.shape
    n = w.shape[1]
    kp = -(-k // PLANE_K) * PLANE_K
    p = _plane_count(a.dtype)
    dtype = _PLANE_DTYPE[a.dtype]
    a_planes = torch.empty((p, m, kp), dtype=dtype, device=a.device)
    w_planes = torch.empty((p, n, kp), dtype=dtype, device=a.device)
    if k and (m or n):
        launch(
            "ws_matmul", "gemm_operand_planes", a.device,
            a.data_ptr(), w.data_ptr(), a_planes.data_ptr(), w_planes.data_ptr(),
            m, k, n, kp, DTYPE_CODES[a.dtype],
        )
        ws_gemm.prep_launches += 1
    return a_planes, w_planes


def _launch(a: torch.Tensor, w: torch.Tensor, route: str) -> torch.Tensor:
    """Launch the tensor-core kernel on checked CUDA operands of ``route``
    (for all but aligned bf16 the one call also runs the prep kernel into
    scratch planes; integers zero the output there too)."""
    m, k = a.shape
    n = w.shape[1]
    out = torch.empty((m, n), dtype=_OUT_DTYPE[a.dtype], device=a.device)
    if out.numel() == 0 or k == 0:
        return out.zero_()
    planes = None
    if a.dtype == torch.bfloat16 and route == "tc":
        # TMA needs 16-byte aligned data (a view with an offset may not be)
        a, w = (x if x.data_ptr() % 16 == 0 else x.clone() for x in (a, w))
    else:
        # scratch for the prep kernel; freed on return, it is reused only by
        # work queued after the GEMM on this stream (the caching allocator)
        kp = -(-k // PLANE_K) * PLANE_K
        planes = torch.empty(_plane_count(a.dtype) * (m + n) * kp, dtype=_PLANE_DTYPE[a.dtype],
                             device=a.device)
    launch(
        "ws_matmul", "ws_gemm_tc", a.device,
        a.data_ptr(), w.data_ptr(), 0 if planes is None else planes.data_ptr(), out.data_ptr(),
        m, k, n, DTYPE_CODES[a.dtype],
    )
    if planes is not None:
        ws_gemm.prep_launches += 1
    if route == "tc":
        ws_gemm.tc_launches += 1
    else:
        ws_gemm.tf32_launches += 1
    ws_gemm.launches += 1
    return out


def ws_gemm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """K6: ``a @ w`` for contiguous (M, K) and (K, N) tensors of one type,
    int8/int16 -> int32 (wrapped mod 2^32) or bf16/f32 -> f32, on ``a``'s
    device, by the kernel ``gemm_route`` names."""
    _check(a, w)
    if on_cpu(a, "ws_gemm"):
        return ws_gemm_plain(a, w)
    return _launch(a, w, gemm_route(a.dtype, *a.shape, w.shape[1]))


ws_gemm.launches = 0
ws_gemm.tc_launches = 0
ws_gemm.tf32_launches = 0
ws_gemm.prep_launches = 0
