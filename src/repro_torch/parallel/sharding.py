"""Logical-axis sharding: MaxText-style rules with divisibility fallback.

Every parameter, activation and cache tensor of the models is annotated
with a tuple of *logical* axis names when it is made.  This module maps
logical axes onto a physical mesh through an ordered rule table:

  * each logical axis lists candidate mesh-axis groups, in preference order;
  * a candidate is taken only if (a) all its mesh axes exist, (b) none of
    them is already used by another dim of the same tensor, and (c) the
    product of their sizes divides the dim size.

The fallback is what lets heterogeneous architectures share one mesh:
granite's single KV head ends up replicated, mixtral's 8 experts fall back
from expert-parallel to d_ff tensor-parallel, a batch of 1 leaves 'data'
free for the KV cache's sequence axis.

The rule tables and ``spec_for_axes`` are plain Python: a spec is a tuple
with one entry per dim (a mesh axis name, a tuple of names, or ``None``),
in place of the reference's ``PartitionSpec``, and a mesh is anything with
``axis_names`` and ``devices.shape``.  Placing tensors on a device mesh
(the reference's ``sharding_for``, ``tree_shardings`` and
``activation_sharding``) comes with the port's mesh slice; until then no
mesh is ever active, ``active_mesh()`` is ``None`` and ``shard_hint``
returns its tensor unchanged.
"""

from __future__ import annotations

from typing import Any, Sequence

__all__ = [
    "DEFAULT_ACT_RULES",
    "DEFAULT_PARAM_RULES",
    "active_act_rules",
    "active_mesh",
    "shard_hint",
    "spec_for_axes",
]

Axes = tuple

# Candidate mesh-axis groups per logical axis, in preference order.
# 'batch' prefers the full DP product (pod x data); 'embed' is the FSDP axis.
DEFAULT_PARAM_RULES: dict[str | None, tuple[tuple[str, ...], ...]] = {
    "vocab": (("model",),),
    "heads": (("model",),),
    "kv_heads": (("model",),),
    "mlp": (("model",),),
    "experts": (("model",),),
    "embed": (("data",),),
    "expert_embed": (("data",),),  # expert-weight FSDP axis
    "expert_mlp": (("model",),),
    "inner": (("model",),),  # mamba/xlstm inner projection dim
    "batch": (("pod", "data"), ("data",)),
    "layers": (),
    "seq": (),
    # decode KV caches arrive as step inputs, so their sequence axis needs a
    # rule too: prefer 'data' (free when batch = 1), else 'model' (when the
    # batch already took the DP axes and a replicated cache would not fit).
    "cache_seq": (("data",), ("model",)),
    "state": (),
    "conv": (),
    "codebooks": (),
    None: (),
}

DEFAULT_ACT_RULES: dict[str | None, tuple[tuple[str, ...], ...]] = {
    # 2D batch sharding first: when the global batch divides the full device
    # count, activations are sharded batch-wise over data AND model.  Every
    # 'pod'-bearing candidate precedes every pod-free one: a pod-free
    # assignment on a multi-pod mesh would replicate the batch across pods.
    "batch": (
        ("pod", "data", "model"),
        ("pod", "data"),
        ("data", "model"),
        ("data",),
    ),
    "heads": (("model",),),
    "kv_heads": (("model",),),
    "mlp": (("model",),),
    "experts": (("model",),),
    "expert_cap": (("pod", "data"), ("data",)),  # MoE dispatch-buffer capacity
    # expert weights at compute time: replicated over the FSDP axis
    "expert_embed": (),
    "expert_mlp": (("model",),),
    "inner": (("model",),),
    "vocab": (("model",),),
    "embed": (),
    "seq": (),
    "cache_seq": (("data",), ("model",)),  # batch=1 -> data; else model
    "state": (),
    "codebooks": (),
    "layers": (),
    None: (),
}


def spec_for_axes(
    axes: Sequence[str | None],
    shape: Sequence[int],
    mesh: Any,
    rules: dict[str | None, tuple[tuple[str, ...], ...]],
) -> tuple:
    """Greedy logical->physical assignment with divisibility fallback.

    Returns one entry per dim: ``None`` (replicated), a mesh axis name, or
    a tuple of names for a group of several axes."""
    if len(axes) != len(shape):
        raise ValueError(f"axes {axes} vs shape {shape} rank mismatch")
    used: set[str] = set()
    entries: list[Any] = []
    mesh_sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    for ax, dim in zip(axes, shape):
        chosen = None
        for group in rules.get(ax, ()):
            if not all(g in mesh_sizes for g in group):
                continue
            if any(g in used for g in group):
                continue
            prod = 1
            for g in group:
                prod *= mesh_sizes[g]
            if prod == 0 or dim % prod:
                continue
            chosen = group
            break
        if chosen is None:
            entries.append(None)
        else:
            used.update(chosen)
            entries.append(chosen if len(chosen) > 1 else chosen[0])
    return tuple(entries)


def active_mesh() -> Any | None:
    """The mesh activations are sharded over: ``None`` until the port's
    mesh slice brings device meshes (one device holds every tensor)."""
    return None


def active_act_rules() -> dict | None:
    """The activation rules of the active mesh (``None`` without one)."""
    return None


def shard_hint(x, *axes: str | None):
    """Mark ``x``'s logical axes for the active mesh.  No mesh is ever
    active yet (``active_mesh``), so this is ``x`` unchanged; the models
    call it where the reference does, to mark the layouts the mesh slice
    will pin."""
    return x
