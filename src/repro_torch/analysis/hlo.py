"""Per-device collective, FLOP and byte accounting.

Two sources of the reference's ``CollectiveStats``:

* ``collective_stats(hlo_text)``, the reference's parser of optimized
  (per-device) HLO text, kept as it is: the sum of the result-buffer bytes
  of every collective op, by op kind.
* ``TraceCounter``, the port's own: a ``TorchDispatchMode`` held over an
  eager step on DTensors.  It returns ``NotImplemented`` for an op on
  DTensors, so that DTensor runs it and the counter sees what each rank
  runs: the local ops on local shards and the functional collectives of
  every redistribution.  It sums, under the reference's op names, the
  local result bytes of every collective; the FLOPs of each local op
  (``torch.utils.flop_counter``'s formulas on local shapes: a DTensor
  matmul sharded over 512 ranks counts its 1/512); the bytes each local op
  reads and writes (every input and output once, views excepted); the
  peak of live intermediate bytes (each new storage from the op that first
  writes it until its tensor is freed, the step's arguments excepted, with
  garbage that only reference cycles hold collected before each new peak; an
  allocation that is never written is not counted, nor are the stand-ins
  of sharding propagation below); and the storages the
  step writes in place.  Counting result buffers is the standard
  approximation (an all-gather counts the gathered size; an all-reduce
  the reduced tensor once).  The byte count is an eager one: each op
  reads its inputs and writes its output, with no fusion.

DTensor's sharding propagation runs new ops on stand-ins of the global
tensors to learn their output shapes and placements: ``FakeTensor``s, or
meta tensors that carry a ``_spec`` (the placements of a decomposition
being tried).  Those runs are not the step's work, and the counter skips
them.
"""

from __future__ import annotations

import dataclasses
import gc
import re
import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

__all__ = [
    "COLLECTIVE_OPS",
    "CollectiveStats",
    "TORCH_COLLECTIVES",
    "TraceCounter",
    "collective_stats",
]

_DTYPE_BYTES = {
    "pred": 1,
    "s4": 1,
    "u4": 1,
    "s8": 1,
    "u8": 1,
    "s16": 2,
    "u16": 2,
    "f16": 2,
    "bf16": 2,
    "s32": 4,
    "u32": 4,
    "f32": 4,
    "s64": 8,
    "u64": 8,
    "f64": 8,
    "c64": 8,
    "c128": 16,
}

COLLECTIVE_OPS = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)

# `%name = TYPE op-name(` where TYPE is `bf16[1,2]{...}` or a tuple of those.
_INSTR_RE = re.compile(
    r"=\s*(\([^)]*\)|[a-z0-9]+\[[0-9,]*\][^\s]*)\s+"
    r"(all-gather|all-reduce|reduce-scatter|all-to-all|collective-permute)"
    r"(?:-start)?\("
)
_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")


def _shape_bytes(shape_text: str) -> int:
    total = 0
    for dtype, dims in _SHAPE_RE.findall(shape_text):
        if dtype not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dtype]
    return total


@dataclasses.dataclass
class CollectiveStats:
    bytes_by_op: dict[str, int]
    count_by_op: dict[str, int]

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_op.values())

    @property
    def total_count(self) -> int:
        return sum(self.count_by_op.values())

    def as_dict(self) -> dict:
        return {
            "bytes_by_op": dict(self.bytes_by_op),
            "count_by_op": dict(self.count_by_op),
            "total_bytes": self.total_bytes,
            "total_count": self.total_count,
        }


def collective_stats(hlo_text: str) -> CollectiveStats:
    """Per-device collective result bytes, by op kind, from optimized HLO."""
    bytes_by = defaultdict(int)
    count_by = defaultdict(int)
    for m in _INSTR_RE.finditer(hlo_text):
        shape_text, op = m.group(1), m.group(2)
        bytes_by[op] += _shape_bytes(shape_text)
        count_by[op] += 1
    return CollectiveStats(bytes_by_op=dict(bytes_by), count_by_op=dict(count_by))


# ---------------------------------------------------------------------------
# The port's source: a dispatch mode over an eager step on DTensors
# ---------------------------------------------------------------------------

# Functional collectives (namespace ``_c10d_functional``, and DTensor's own
# shard-to-shard all-to-all) under the reference's HLO op names.
TORCH_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "permute_tensor": "collective-permute",
}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "c10d_functional", "_dtensor")
# Ops that move no data: allocation without a write, and autograd's
# bookkeeping.
# Composite (decomposable) ops that DTensor may hand a rank whole.
_COMPOSITE_PRODUCTS = ("matmul", "linear", "einsum", "tensordot")
_NO_WORK = ("empty", "empty_strided", "empty_like", "detach", "detach_", "alias", "_wrap_tensor_autograd",
            "wait_tensor", "lift_fresh")


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class TraceCounter(TorchDispatchMode):
    """Counts what one rank runs while it is active (see the module's
    docstring).  ``exclude(tree)`` marks the step's arguments (DTensors or
    plain tensors): their storages are not intermediates."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes_accessed = 0
        self.coll_bytes: dict[str, int] = defaultdict(int)
        self.coll_count: dict[str, int] = defaultdict(int)
        self.live_bytes = 0
        self.peak_bytes = 0
        self.written: set[int] = set()
        self._live: dict[int, int] = {}
        self._args: set[int] = set()
        self._depth = 0

    def __enter__(self):
        if not self._depth:
            # what exists now is not the step's: keep the collections below
            # to the objects the step makes
            gc.collect()
            gc.freeze()
        self._depth += 1  # the mode enters itself again around composite ops
        return super().__enter__()

    def __exit__(self, *exc):
        self._depth -= 1
        if not self._depth:
            gc.unfreeze()
        return super().__exit__(*exc)

    def exclude(self, tree) -> None:
        for t in _local_leaves(tree):
            self._args.add(_storage_key(t))

    @property
    def collectives(self) -> CollectiveStats:
        return CollectiveStats(bytes_by_op=dict(self.coll_bytes), count_by_op=dict(self.coll_count))

    def _free(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    def _track(self, out) -> None:
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            key = _storage_key(t)
            if key in self._args or key in self._live:
                continue
            size = t.untyped_storage().nbytes()
            if self.live_bytes + size > self.peak_bytes:
                # a new peak: first free what only reference cycles hold
                # (DTensor's caught exceptions keep frames alive), which
                # reference counting alone leaves to the cyclic collector
                gc.collect()
            self._live[key] = size
            self.live_bytes += size
            weakref.finalize(t if t._base is None else t._base, self._free, key)
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor runs it; its local ops come back here
        kwargs = kwargs or {}
        if func.namespace == "aten" and func._schema.name[6:] in _COMPOSITE_PRODUCTS:
            # DTensor runs these composite ops whole on the local shards:
            # count the products they are made of
            with self:
                return func.decompose(*args, **kwargs)
        out = func(*args, **kwargs)
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        ins = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
        if any(isinstance(t, FakeTensor) for t in outs) or any(hasattr(t, "_spec") for t in ins):
            return out  # DTensor's sharding propagation, not the step's work
        name = func._schema.name.split("::")[-1]
        if func.namespace in _COLLECTIVE_NAMESPACES and name in TORCH_COLLECTIVES:
            op = TORCH_COLLECTIVES[name]
            self.coll_bytes[op] += sum(_nbytes(t) for t in outs)
            self.coll_count[op] += 1
            self._track(out)
            return out
        for i, arg in enumerate(func._schema.arguments):
            if arg.alias_info is not None and arg.alias_info.is_write:
                value = kwargs.get(arg.name) if i >= len(args) else args[i]
                for t in tree_leaves(value):
                    if isinstance(t, torch.Tensor):
                        self.written.add(_storage_key(t))
                        self._track(t)  # an allocation counts from its first write
        if func.is_view or name in _NO_WORK:
            return out
        from torch.utils.flop_counter import flop_registry

        count = flop_registry.get(func._overloadpacket)
        if count is not None:
            self.flops += count(*args, **kwargs, out_val=out)
        self.bytes_accessed += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        self._track(out)
        return out


def _local_leaves(tree) -> list[torch.Tensor]:
    from torch.distributed.tensor import DTensor

    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _local_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _local_leaves(v)]
    if isinstance(tree, DTensor):
        return [tree.to_local()]
    return [tree] if isinstance(tree, torch.Tensor) else []
