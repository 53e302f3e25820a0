"""Shape-and-type stand-ins (+ logical axes) for every step input.

The reference's dry-run contract: for each (arch, shape) cell, the full
argument trees — parameters, optimizer state, batches, KV/state caches —
as zero-allocation specs, plus the parallel logical-axes trees the
sharding rules consume.  The port's specs are tensors on the ``meta``
device (the reference's ``ShapeDtypeStruct`` from ``eval_shape``): each
has the shape and type, and nothing is allocated.  ``token_shape`` is the
shape authority the serving workload expansion shares.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.models import model
from repro_torch.optim import adamw

__all__ = [
    "cache_specs",
    "decode_batch_specs",
    "input_specs",
    "param_specs",
    "prefill_batch_specs",
    "token_shape",
    "train_batch_specs",
    "train_state_specs",
]

META = torch.device("meta")


def _spec(shape, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


# ---------------------------------------------------------------------------
# Batch specs
# ---------------------------------------------------------------------------


def token_shape(cfg, batch: int, seq: int) -> tuple[int, ...]:
    """Token-array shape for one step: (B, S) or (B, S, codebooks).

    THE shape authority shared by the batch specs below and the serving
    workload expansion (``repro_torch.serving.expand``): decode is
    ``seq == 1``, so ``token_shape(cfg, b, 1)`` is exactly the
    ``decode_batch_specs`` token shape — one helper, no duplicated shape
    math.
    """
    if cfg.num_codebooks > 1:
        return (batch, seq, cfg.num_codebooks)
    return (batch, seq)


def _token_spec(cfg, batch: int, seq: int) -> tuple[torch.Tensor, tuple]:
    shape = token_shape(cfg, batch, seq)
    if len(shape) == 3:
        return _spec(shape, torch.int32), ("batch", "seq", "codebooks")
    return _spec(shape, torch.int32), ("batch", "seq")


def _position_spec(cfg, batch: int, seq: int) -> tuple[torch.Tensor, tuple]:
    if cfg.rope_kind == "mrope":
        return _spec((3, batch, seq), torch.int32), (None, "batch", "seq")
    return _spec((batch, seq), torch.int32), ("batch", "seq")


def train_batch_specs(cfg, shape) -> tuple[dict, dict]:
    b, s = shape.global_batch, shape.seq_len
    tok, tok_ax = _token_spec(cfg, b, s)
    pos, pos_ax = _position_spec(cfg, b, s)
    specs = {"tokens": tok, "labels": tok, "positions": pos}
    axes = {"tokens": tok_ax, "labels": tok_ax, "positions": pos_ax}
    return specs, axes


def prefill_batch_specs(cfg, shape) -> tuple[dict, dict]:
    b, s = shape.global_batch, shape.seq_len
    tok, tok_ax = _token_spec(cfg, b, s)
    pos, pos_ax = _position_spec(cfg, b, s)
    return {"tokens": tok, "positions": pos}, {"tokens": tok_ax, "positions": pos_ax}


def decode_batch_specs(cfg, shape) -> tuple[dict, dict]:
    b = shape.global_batch
    tok, tok_ax = _token_spec(cfg, b, 1)
    return (
        {"tokens": tok, "pos": _spec((), torch.int32)},
        {"tokens": tok_ax, "pos": ()},
    )


# ---------------------------------------------------------------------------
# State / cache specs
# ---------------------------------------------------------------------------


def param_specs(cfg) -> tuple[Any, Any]:
    return model.shapes_and_axes(cfg)


def train_state_specs(cfg, opt_cfg: adamw.AdamWConfig) -> tuple[dict, dict]:
    """{'params', 'opt_state'} spec + axes trees; moments share param axes."""
    p_shapes, p_axes = param_specs(cfg)
    mdt = getattr(torch, opt_cfg.moment_dtype)
    mom = adamw.tree_map(lambda s: _spec(s.shape, mdt), p_shapes)
    state = {
        "params": p_shapes,
        "opt_state": {"m": mom, "v": mom, "step": _spec((), torch.int32)},
    }
    axes = {
        "params": p_axes,
        "opt_state": {"m": p_axes, "v": p_axes, "step": ()},
    }
    return state, axes


def cache_specs(cfg, shape, dtype=None) -> tuple[Any, Any]:
    b, s = shape.global_batch, shape.seq_len
    return model.init_cache(cfg, b, s, dtype, device=META)


def input_specs(cfg, shape) -> tuple[dict, dict]:
    """All step inputs for one (arch, shape) cell, by shape kind.

    train  -> {'state', 'batch'}
    prefill-> {'params', 'batch'}
    decode -> {'params', 'cache', 'batch'}
    """
    if shape.kind == "train":
        state, state_ax = train_state_specs(cfg, adamw.AdamWConfig())
        batch, batch_ax = train_batch_specs(cfg, shape)
        return {"state": state, "batch": batch}, {"state": state_ax, "batch": batch_ax}
    if shape.kind == "prefill":
        params, p_ax = param_specs(cfg)
        batch, batch_ax = prefill_batch_specs(cfg, shape)
        return {"params": params, "batch": batch}, {"params": p_ax, "batch": batch_ax}
    if shape.kind == "decode":
        params, p_ax = param_specs(cfg)
        cache, c_ax = cache_specs(cfg, shape)
        batch, batch_ax = decode_batch_specs(cfg, shape)
        return (
            {"params": params, "cache": cache, "batch": batch},
            {"params": p_ax, "cache": c_ax, "batch": batch_ax},
        )
    raise ValueError(f"unknown shape kind {shape.kind}")
