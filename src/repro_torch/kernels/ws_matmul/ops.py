"""Public API of the weight-stationary GEMM (kernel K6), any 2-D shapes.

The same entry point as the JAX package's ``ws_matmul/ops.py``, with
``engine="cuda"`` (the default: the kernel on the current CUDA device) or
``engine="torch"`` (its plain PyTorch version on the CPU) in place of
``interpret=``.  Operands are numpy arrays (int8, int16, float32) or
tensors (also bfloat16); numpy input is copied to the engine's device once
and a contiguous tensor already there is used in place.

Deliberate differences from the reference: no ``block_m``/``block_n``/
``block_k`` arguments (TPU tiling knobs) and no zero padding of M and N:
the kernels read zeros past the ragged edges (only the operand planes pad
K).  On the card every type runs on the tensor cores, by
a route chosen by type and shape (``kernel.gemm_route``): int8, int16 and
bf16 with K and N multiples of 8 on the "tc" route, f32 (three TF32
products) and other bf16 on the "tf32" route.
"""

from __future__ import annotations

import torch

from repro_torch.kernels._engine import engine_device, to_engine
from repro_torch.kernels.ws_matmul.kernel import ws_gemm

__all__ = ["ws_matmul"]


def ws_matmul(a, w, *, engine: str = "cuda") -> torch.Tensor:
    """``a @ w`` on the weight-stationary kernel, any 2-D shapes.

    int8/int16 operands give int32, wrapping mod 2^32 where a sum leaves
    the int32 range, exactly as the reference's int32 accumulator;
    bfloat16/float32 operands give float32.  The result lies on the
    engine's device.
    """
    device = engine_device(engine)
    return ws_gemm(to_engine(a, device), to_engine(w, device))
