"""Step functions: training update, serving prefill, serving decode.

The reference's step functions, state in, state out.  The train step runs
the loss's forward and backward (``torch.autograd.grad``, no ``.grad``
left behind), applies the gradient-compression hook, then AdamW, which
writes the parameters and moments in place: there is no ``jit`` and no
buffer donation, and the state returned holds the same tensors.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.models import model
from repro_torch.optim import adamw, compress

__all__ = ["make_decode_step", "make_prefill_step", "make_train_step", "step_for_shape"]

GRAD_COMPRESSION = ("none", "bf16")


def make_train_step(
    cfg,
    opt_cfg: adamw.AdamWConfig,
    grad_compression: str = "none",  # 'none' | 'bf16'
) -> Callable[[dict, dict], tuple[dict, dict]]:
    """``train_step(state, batch) -> (state, metrics)`` with ``state``
    ``{"params", "opt_state"}`` (trees of tensors) and metrics ``loss``,
    ``ce``, ``aux``, ``grad_norm`` and ``lr``, f32 scalars on the device.
    The loss trains through the torch attention route on every device."""
    if grad_compression not in GRAD_COMPRESSION:
        raise ValueError(f"unknown grad_compression {grad_compression!r}; "
                         f"expected one of {GRAD_COMPRESSION}")

    def train_step(state: dict, batch: dict) -> tuple[dict, dict]:
        params = state["params"]
        leaves = adamw.tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        with torch.enable_grad():
            loss, metrics = model.loss_fn(cfg, params, batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
        grads = adamw.tree_unflatten(params, grads)
        if grad_compression == "bf16":
            grads = compress.compress_bf16(grads)
        params, opt_state, om = adamw.apply_updates(opt_cfg, params, state["opt_state"], grads)
        out_metrics = {
            "loss": loss.detach().float(),
            "ce": metrics["ce"].detach().float(),
            "aux": metrics["aux"].detach().float(),
            "grad_norm": om["grad_norm"],
            "lr": om["lr"],
        }
        return {"params": params, "opt_state": opt_state}, out_metrics

    return train_step


def make_prefill_step(cfg) -> Callable[[Any, dict], torch.Tensor]:
    """Serving prefill: next-token logits for the last position (B, V[, K])."""

    def prefill_step(params: Any, batch: dict) -> torch.Tensor:
        logits, _ = model.forward(
            cfg, params, batch["tokens"], batch.get("positions"), last_only=True
        )
        return logits

    return prefill_step


def make_decode_step(cfg) -> Callable[[Any, Any, dict], tuple[torch.Tensor, Any]]:
    """Serving decode: one new token against the KV/state cache (written in
    place)."""

    def decode_step(params: Any, cache: Any, batch: dict) -> tuple[torch.Tensor, Any]:
        return model.decode_step(cfg, params, cache, batch["tokens"], batch["pos"])

    return decode_step


def step_for_shape(cfg, shape, opt_cfg: adamw.AdamWConfig | None = None, **kw):
    """(callable, donate_argnums) for one cell's step function: the
    arguments the reference donates, which the port's steps update in
    place."""
    if shape.kind == "train":
        return make_train_step(cfg, opt_cfg or adamw.AdamWConfig(), **kw), (0,)
    if shape.kind == "prefill":
        return make_prefill_step(cfg), ()
    if shape.kind == "decode":
        return make_decode_step(cfg), (1,)
    raise ValueError(shape.kind)
