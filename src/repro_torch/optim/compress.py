"""Gradient compression for cross-pod reduction (distributed-opt trick).

Two compressors, both applied to gradients *before* the optimizer, on trees
of tensors (nested dicts, as ``optim.adamw``):

  * ``bf16``: cast gradients to bfloat16 and back; a reduction in the
    gradient's type then moves half the bytes.
  * ``int8_ef``: per-tensor symmetric int8 quantization with an
    error-feedback residual carried beside the optimizer state
    (1-bit-Adam-style): the quantization error of step t is added back into
    the gradient at step t+1, so the compressed-gradient *sum* is unbiased
    over time and convergence is preserved (property-tested in
    tests/test_torch_optim.py).
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.optim.adamw import tree_map

__all__ = ["compress_bf16", "compress_int8_ef", "init_error_feedback"]


def compress_bf16(grads: Any) -> Any:
    return tree_map(lambda g: g.to(torch.bfloat16).to(g.dtype), grads)


def init_error_feedback(params: Any) -> Any:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)


def _quant_dequant_int8(x: torch.Tensor) -> torch.Tensor:
    amax = x.abs().amax()
    scale = torch.where(amax > 0, amax / 127.0, 1.0)
    q = torch.clamp(torch.round(x / scale), -127, 127)
    return q * scale


def compress_int8_ef(grads: Any, residual: Any) -> tuple[Any, Any]:
    """(compressed grads, new residual). Error feedback: e' = (g+e) - Q(g+e)."""

    def one(g, e):
        gf = g.float() + e
        qd = _quant_dequant_int8(gf)
        return qd.to(g.dtype), gf - qd

    out = tree_map(one, grads, residual)
    return tree_map(lambda t: t[0], out, is_leaf=_is_pair), tree_map(lambda t: t[1], out,
                                                                       is_leaf=_is_pair)


def _is_pair(x) -> bool:
    return isinstance(x, tuple)
