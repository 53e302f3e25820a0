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
in place of the reference's ``PartitionSpec``, and a mesh is a
``torch.distributed.DeviceMesh`` (or anything with ``axis_names`` and
``devices.shape``).

Placement is DTensor's: ``sharding_for`` gives a ``Sharding`` (the mesh,
the spec and its DTensor placements) in place of a ``NamedSharding``.  A
group of mesh axes on one dim, such as ``("pod", "data")``, is ``Shard(d)``
on each of those mesh dims, the group's first axis major, which is the
order of JAX's ``devices_indices_map``; ``Sharding.shard_slices`` gives the
block a mesh coordinate holds.  ``place`` puts a global tensor (or a tree
of them) on the mesh by taking each rank's block locally, with no
communication.  ``activation_sharding`` makes a mesh active for the model
code, as the reference's context does: ``shard_hint`` then redistributes a
DTensor to its hint's placements (the reference's
``with_sharding_constraint``), and plain tensors that the model makes
under it (masks, tables, counters) count as replicated on the mesh
(DTensor's ``implicit_replication``), as constants are in an XLA program.
Outside the context no mesh is active and ``shard_hint`` returns its
tensor unchanged.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any, Sequence

import torch

__all__ = [
    "DEFAULT_ACT_RULES",
    "DEFAULT_PARAM_RULES",
    "Sharding",
    "activation_sharding",
    "active_act_rules",
    "active_mesh",
    "from_local",
    "is_dtensor",
    "local_blocks",
    "mesh_sizes",
    "place",
    "redistribute",
    "reduce_partial",
    "replicated",
    "shard_hint",
    "sharding_for",
    "spec_for_axes",
    "tree_shardings",
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


def mesh_sizes(mesh: Any) -> dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or of a mesh with
    ``axis_names`` and ``devices.shape`` (the reference's)."""
    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(zip(mesh.axis_names, mesh.devices.shape))


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
    sizes = mesh_sizes(mesh)
    for ax, dim in zip(axes, shape):
        chosen = None
        for group in rules.get(ax, ()):
            if not all(g in sizes for g in group):
                continue
            if any(g in used for g in group):
                continue
            prod = 1
            for g in group:
                prod *= sizes[g]
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




# ---------------------------------------------------------------------------
# Placement on a DeviceMesh (the reference's NamedSharding)
# ---------------------------------------------------------------------------


def _mesh_axes(mesh: Any) -> tuple[str, ...]:
    return tuple(mesh_sizes(mesh))


@dataclasses.dataclass(frozen=True)
class Sharding:
    """Where a tensor lives on ``mesh``: one ``spec`` entry per dim, as
    ``spec_for_axes`` gives it.  ``placements`` are DTensor's, one per mesh
    dim; ``shard_shape`` and ``shard_slices`` are those of
    ``NamedSharding.shard_shape`` and ``devices_indices_map``."""

    mesh: Any
    spec: tuple

    def __post_init__(self):
        axes = _mesh_axes(self.mesh)
        for entry in self.spec:
            group = _group(entry)
            order = [axes.index(a) for a in group]
            if order != sorted(order):
                raise ValueError(f"mesh axes {group} of spec {self.spec} are not in the mesh's "
                                 f"order {axes}: DTensor shards a dim over mesh dims major-first")

    @property
    def placements(self) -> tuple:
        from torch.distributed.tensor import Replicate, Shard

        out = [Replicate()] * len(_mesh_axes(self.mesh))
        axes = _mesh_axes(self.mesh)
        for dim, entry in enumerate(self.spec):
            for a in _group(entry):
                out[axes.index(a)] = Shard(dim)
        return tuple(out)

    def _parts(self, dim: int) -> int:
        sizes = mesh_sizes(self.mesh)
        return math.prod(sizes[a] for a in _group(self.spec[dim])) if dim < len(self.spec) else 1

    def shard_shape(self, global_shape: Sequence[int]) -> tuple[int, ...]:
        return tuple(n // self._parts(d) for d, n in enumerate(global_shape))

    def shard_slices(self, global_shape: Sequence[int], coordinate: Sequence[int]
                     ) -> tuple[slice, ...]:
        """The block of the global tensor that the rank at mesh
        ``coordinate`` holds: the group's first axis is major."""
        sizes = mesh_sizes(self.mesh)
        coord = dict(zip(_mesh_axes(self.mesh), coordinate))
        out = []
        for d, n in enumerate(global_shape):
            index = 0
            for a in _group(self.spec[d]) if d < len(self.spec) else ():
                index = index * sizes[a] + coord[a]
            size = n // self._parts(d)
            out.append(slice(index * size, (index + 1) * size))
        return tuple(out)


def _group(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def sharding_for(
    axes: Sequence[str | None],
    shape: Sequence[int],
    mesh: Any,
    rules: dict[str | None, tuple[tuple[str, ...], ...]] | None = None,
) -> Sharding:
    rules = rules if rules is not None else DEFAULT_PARAM_RULES
    return Sharding(mesh, spec_for_axes(axes, shape, mesh, rules))


def _is_axes_leaf(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None))) for e in x)


def tree_shardings(
    axes_tree: Any,
    shape_tree: Any,
    mesh: Any,
    rules: dict[str | None, tuple[tuple[str, ...], ...]] | None = None,
) -> Any:
    """``Sharding`` tree for (axes tree, tree of tensors with shapes)."""
    if _is_axes_leaf(axes_tree):
        return sharding_for(axes_tree, tuple(shape_tree.shape), mesh, rules)
    return {k: tree_shardings(axes_tree[k], shape_tree[k], mesh, rules) for k in shape_tree}


def from_local(local: torch.Tensor, mesh: Any, placements: Sequence, shape=None, stride=None):
    """``DTensor.from_local`` (no check across ranks), differentiable where
    gradients are on.  Where they are off (``no_grad``, ``inference_mode``)
    the block is detached first: DTensor's autograd function would
    otherwise ``detach_`` the DTensor it returns, which DTensor's older
    releases have no sharding rule for."""
    from torch.distributed.tensor import DTensor

    if not torch.is_grad_enabled():
        local = local.detach()
    return DTensor.from_local(local, mesh, placements, run_check=False, shape=shape, stride=stride)


def redistribute(x, placements: Sequence):
    """``x.redistribute`` onto ``placements`` of its mesh.  Where gradients
    are off, a DTensor that requires grad (a parameter) is first rebuilt
    from its detached block, as ``from_local`` does (DTensor's own
    ``detach`` cannot make a view under ``inference_mode``)."""
    if not torch.is_grad_enabled() and x.requires_grad:
        x = from_local(x.to_local(), x.device_mesh, x.placements, shape=x.shape, stride=x.stride())
    return x.redistribute(x.device_mesh, placements)


def replicated(t: torch.Tensor, mesh: Any):
    """A tensor every rank holds whole, as a DTensor replicated on ``mesh``."""
    from torch.distributed.tensor import Replicate

    return from_local(t, mesh, [Replicate()] * mesh.ndim)


def place(tree: Any, shardings: Any) -> Any:
    """A tensor (or tree of tensors) as DTensors on its ``Sharding``'s
    mesh: each rank keeps its own block of the global tensor, taken
    locally (no communication; on a one-rank mesh, the tensor itself)."""
    if isinstance(shardings, Sharding):
        mesh = shardings.mesh
        local = tree[shardings.shard_slices(tree.shape, mesh.get_coordinate())]
        if not local.is_contiguous():
            local = local.contiguous()
        return from_local(local, mesh, shardings.placements, shape=tree.shape,
                          stride=tree.stride())
    return {k: place(tree[k], shardings[k]) for k in tree}


# ---------------------------------------------------------------------------
# Activation shard-hint context (used inside model code)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _ShardCtx:
    mesh: Any = None
    act_rules: dict | None = None


_ctx = threading.local()


def _get_ctx() -> _ShardCtx:
    if not hasattr(_ctx, "v"):
        _ctx.v = _ShardCtx()
    return _ctx.v


@contextlib.contextmanager
def activation_sharding(mesh: Any, act_rules: dict | None = None):
    """Make ``mesh`` the active mesh of the model code: ``shard_hint``
    places activations by ``act_rules``, and plain tensors that meet
    DTensors count as replicated on the mesh."""
    from torch.distributed.tensor.experimental import implicit_replication

    c = _get_ctx()
    prev = (c.mesh, c.act_rules)
    c.mesh, c.act_rules = mesh, act_rules or DEFAULT_ACT_RULES
    try:
        with implicit_replication():
            yield
    finally:
        c.mesh, c.act_rules = prev


def active_mesh() -> Any | None:
    """The mesh of the enclosing ``activation_sharding`` context (or None)."""
    return _get_ctx().mesh


def active_act_rules() -> dict | None:
    return _get_ctx().act_rules


def shard_hint(x, *axes: str | None):
    """Redistribute a DTensor ``x`` to the placements its logical ``axes``
    take on the active mesh (the reference's ``with_sharding_constraint``);
    ``x`` unchanged outside ``activation_sharding`` or if it is a plain
    tensor."""
    c = _get_ctx()
    if c.mesh is None or not is_dtensor(x):
        return x
    placements = Sharding(c.mesh, spec_for_axes(axes, x.shape, c.mesh, c.act_rules)).placements
    if tuple(x.placements) == placements:
        return x
    return redistribute(x, placements)


def reduce_partial(x):
    """``x`` with its pending partial sums reduced: a DTensor's ``Partial``
    placements become ``Replicate`` (an all-reduce); anything else comes
    back unchanged.  DTensor's older releases cannot add a partial sum to a
    sharded tensor (they would make the shard partial)."""
    if not is_dtensor(x) or not any(p.is_partial() for p in x.placements):
        return x
    from torch.distributed.tensor import Replicate

    return redistribute(x, [Replicate() if p.is_partial() else p for p in x.placements])


def local_blocks(fn, xs, ws=(), *, keep, w_dims=()):
    """``fn(*xs, *ws)`` with each rank on its own block, through ``local_map``,
    where DTensor's sharding propagation has no path for ``fn``'s ops.

    ``xs`` are activations that share ``xs[0]``'s layout (DTensors); ``keep``
    names their dims along which ``fn`` is independent: a mesh dim that
    shards one of those keeps it, any other placement is gathered (a
    ``Partial`` sum reduced).  ``ws`` are weights, and ``w_dims[j]`` maps a
    kept activation dim to the dim of ``ws[j]`` that follows it; on a mesh
    dim that shards a kept dim the weight does not follow, the weight is
    whole and its gradient is a partial sum.  ``fn``'s one output has
    ``xs[0]``'s layout."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    # lists: local_map reads a tuple as one placement per output
    x_pl, w_pl, w_grad = [], [[] for _ in ws], [[] for _ in ws]
    for p in xs[0].placements:
        kept = isinstance(p, Shard) and p.dim in keep
        x_pl.append(p if kept else Replicate())
        for j in range(len(ws)):
            dims = w_dims[j]
            if kept and p.dim in dims:
                w_pl[j].append(Shard(dims[p.dim]))
                w_grad[j].append(Shard(dims[p.dim]))
            else:
                w_pl[j].append(Replicate())
                w_grad[j].append(Partial() if kept else Replicate())
    mesh = xs[0].device_mesh
    xs = [redistribute(x, x_pl) for x in xs]
    ws = [redistribute(w if is_dtensor(w) else replicated(w, mesh), pl) for w, pl in zip(ws, w_pl)]
    return local_map(fn, out_placements=x_pl, in_placements=(x_pl,) * len(xs) + tuple(w_pl),
                     in_grad_placements=(x_pl,) * len(xs) + tuple(w_grad),
                     device_mesh=mesh)(*xs, *ws)


def is_dtensor(x) -> bool:
    if not torch.distributed.is_available():
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)
