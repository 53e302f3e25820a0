"""Atomic, keep-K checkpointing of full train state (params/opt/step/data).

Design points (the reference's, and its on-disk layout, so that an f32
state saved by either package restores in the other):
  * atomic directory commit (write to ``step_<10 digits>.tmp``, fsync the
    manifest, rename) — a preempted save never corrupts the latest
    checkpoint;
  * per-leaf .npy files named by the leaf's ``/``-joined key path with
    ``/`` -> ``__`` (``params/stages/block0/mixer/wq``,
    ``opt_state/step``), and ``manifest.json`` with ``step``, ``leaves``
    (key, file, dtype, shape, in sorted key order) and ``extra``;
  * keep-last-K garbage collection;
  * ``restore(step, like)`` is pure: leaves as CPU tensors in ``like``'s
    structure, read by key.

A state is a tree: nested dicts whose leaves are tensors (any device; they
are copied to the host), numpy arrays or numbers.  numpy has no bfloat16,
so a bf16 leaf is stored as its raw bits, a uint16 ``.npy``, with
``"dtype": "bfloat16"`` in the manifest, and restored as bf16 (the
reference writes ``ml_dtypes``' bfloat16, which only it reads).

The step-indexed state lives here; the design-space sweep's chunks live in
the content-addressed ``core.store.ContentStore``.  The two share the
atomic-write primitive, ``core.store.atomic_write_bytes``.
"""

from __future__ import annotations

import json
import os
import shutil
from pathlib import Path
from typing import Any

import numpy as np
import torch

from repro_torch.core.store import atomic_write_bytes
from repro_torch.optim.adamw import tree_unflatten

__all__ = ["CheckpointManager"]

_BF16 = "bfloat16"


def _flatten_with_paths(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """(key path, leaf) pairs in sorted key order (``jax.tree``'s order)."""
    if isinstance(tree, dict):
        out = []
        for key in sorted(tree):
            out += _flatten_with_paths(tree[key], f"{prefix}{key}/")
        return out
    return [(prefix[:-1], tree)]


def _to_numpy(leaf: Any) -> tuple[np.ndarray, str]:
    """(array to store, manifest dtype)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), _BF16
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _from_numpy(arr: np.ndarray, dtype: str) -> torch.Tensor:
    arr = np.asarray(arr, order="C")  # keeps a 0-d leaf 0-d
    if dtype == _BF16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


class CheckpointManager:
    def __init__(self, directory: str | Path, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep

    # -- save ---------------------------------------------------------------

    def save(self, step: int, state: Any, extra: dict | None = None) -> Path:
        final = self.dir / f"step_{step:010d}"
        tmp = self.dir / f"step_{step:010d}.tmp"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)

        manifest = {"step": step, "leaves": [], "extra": extra or {}}
        for key, leaf in _flatten_with_paths(state):
            arr, dtype = _to_numpy(leaf)
            fname = key.replace("/", "__") + ".npy"
            np.save(tmp / fname, arr)
            manifest["leaves"].append(
                {"key": key, "file": fname, "dtype": dtype, "shape": list(arr.shape)}
            )
        # manifest lands via tmp+fsync+replace (shared crash-safe primitive),
        # then the whole directory commits atomically via rename
        atomic_write_bytes(tmp / "manifest.json", json.dumps(manifest).encode())
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()
        return final

    # -- restore --------------------------------------------------------------

    def all_steps(self) -> list[int]:
        steps = []
        for p in self.dir.glob("step_*"):
            if p.suffix == ".tmp" or not p.is_dir():
                continue
            try:
                steps.append(int(p.name.split("_")[1]))
            except (IndexError, ValueError):
                continue
        return sorted(steps)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like: Any) -> tuple[Any, dict]:
        """Restore into the structure of ``like`` (a tree of tensors, meta
        tensors or arrays): CPU tensors, read by key."""
        d = self.dir / f"step_{step:010d}"
        manifest = json.loads((d / "manifest.json").read_text())
        by_key = {e["key"]: e for e in manifest["leaves"]}
        leaves = []
        for key, _ in _flatten_with_paths(like):
            e = by_key[key]
            leaves.append(_from_numpy(np.load(d / e["file"]), e["dtype"]))
        return tree_unflatten(like, leaves), manifest.get("extra", {})

    def restore_latest(self, like: Any) -> tuple[int, Any, dict] | None:
        step = self.latest_step()
        if step is None:
            return None
        state, extra = self.restore(step, like)
        return step, state, extra

    # -- gc -------------------------------------------------------------------

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(self.dir / f"step_{s:010d}", ignore_errors=True)
