"""AdamW with decoupled weight decay, global-norm clipping, moment dtypes.

Functional, as the reference's (no ``torch.optim``: its weight decay and
its epsilon placement round differently).  Parameters, gradients and
moments are trees: nested dicts of tensors with the same keys (the model's
``Model.stage(None)``), walked in sorted key order as ``jax.tree`` walks
dicts.  The optimizer state is ``{"m", "v", "step"}``: moments shaped like
the parameters (same logical axes) and an int32 step counter.

``apply_updates`` writes the parameters and moments in place, under
``torch.no_grad()``, and returns them: a step allocates no second copy of
the state (the reference's ``donate_argnums``).  Every scalar (the norm,
the learning rate, the bias corrections) stays a tensor on the state's
device, so a step never waits for the host.

``moment_dtype`` is a distributed-memory lever: bf16 moments halve the
optimizer's memory (the "8/16-bit optimizer" trick); they are updated in
f32 and rounded once a step, as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

__all__ = [
    "AdamWConfig",
    "apply_updates",
    "global_norm",
    "init_state",
    "tree_leaves",
    "tree_map",
    "tree_unflatten",
]


# ---------------------------------------------------------------------------
# Trees: nested dicts of tensors, walked in sorted key order (jax.tree's)
# ---------------------------------------------------------------------------


def tree_leaves(tree: Any) -> list:
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in tree_leaves(tree[key])]
    return [tree]


def tree_unflatten(like: Any, leaves) -> Any:
    """``leaves`` (in ``tree_leaves`` order) in the structure of ``like``."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {key: build(node[key]) for key in sorted(node)}
        return next(it)

    return build(like)


def tree_map(fn: Callable, tree: Any, *rest: Any, is_leaf: Callable | None = None) -> Any:
    if isinstance(tree, dict) and not (is_leaf and is_leaf(tree)):
        return {key: tree_map(fn, tree[key], *(r[key] for r in rest), is_leaf=is_leaf)
                for key in sorted(tree)}
    return fn(tree, *rest)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float | None = 1.0
    moment_dtype: str = "float32"
    schedule: Callable[[torch.Tensor], torch.Tensor] | None = None  # step -> lr scale


def init_state(cfg: AdamWConfig, params: Any) -> dict:
    dt = getattr(torch, cfg.moment_dtype)
    leaves = tree_leaves(params)
    # zeros placed as the parameter (a DTensor's moments are DTensors)
    zeros = lambda p: torch.zeros_like(p, dtype=dt, memory_format=torch.contiguous_format)
    device = leaves[0].device if leaves else None
    return {
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of every leaf's f32 sum of squares."""
    sums = [g.float().square().sum() for g in tree_leaves(tree)]
    return torch.stack(sums).sum().sqrt()


def _f32(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself if f32 (so that in-place ops write it), else an f32 copy."""
    return t if t.dtype == torch.float32 else t.float()


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params: Any, opt_state: dict, grads: Any
                  ) -> tuple[Any, dict, dict]:
    """One AdamW step. Returns (params, new_state, metrics), the parameters
    and moments written in place; ``grads`` is scaled in place by the clip.

    The reference's arithmetic, rounding for rounding: m' = m b1 + g (1 -
    b1), v' = v b2 + g g (1 - b2), then p - lr (m'/c1 / (sqrt(v'/c2) + eps)
    + wd p), with the bias corrections c = 1 - b ** step in f32."""
    step = opt_state["step"] + 1
    gnorm = global_norm(grads)
    leaves_g = tree_leaves(grads)
    if cfg.clip_norm is not None:
        scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
        for g in leaves_g:
            g.mul_(scale.to(g.dtype))

    lr = torch.full((), cfg.lr, dtype=torch.float32, device=gnorm.device)
    if cfg.schedule is not None:
        lr = lr * cfg.schedule(step)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.float()
    c1 = 1.0 - torch.pow(b1, stepf)
    c2 = 1.0 - torch.pow(b2, stepf)

    for p, g, m, v in zip(tree_leaves(params), leaves_g, tree_leaves(opt_state["m"]),
                          tree_leaves(opt_state["v"])):
        gf = _f32(g)
        mf = _f32(m).mul_(b1).add_(gf * (1.0 - b1))
        vf = _f32(v).mul_(b2).add_(gf * gf * (1.0 - b2))
        pf = _f32(p)
        denom = (vf / c2).sqrt_().add_(cfg.eps)
        delta = (mf / c1).div_(denom).add_(pf * cfg.weight_decay)
        pf.sub_(delta.mul_(lr))
        for dst, src in ((p, pf), (m, mf), (v, vf)):
            if dst is not src:
                dst.copy_(src)
    return (
        params,
        {"m": opt_state["m"], "v": opt_state["v"], "step": step},
        {"grad_norm": gnorm, "lr": lr},
    )
