"""Mesh construction over ``torch.distributed``'s DeviceMesh.

A mesh needs a process group of at least its size, initialised by the
caller: NCCL on cards (one rank a card), gloo on the CPU, or the ``"fake"``
backend of a dry run (``launch.dryrun``), where one process stands for
every rank.  Rank ``r`` sits at ``numpy.unravel_index(r, shape)``, as
device ``r`` does in the reference's mesh.  Importing this module touches
no process group.
"""

from __future__ import annotations

import math

import torch

__all__ = ["make_mesh", "make_production_mesh", "make_test_mesh"]


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """The production mesh: one pod (16x16 = 256 ranks) or two pods
    (2x16x16 = 512 ranks; the leading 'pod' axis is the data-parallel axis
    between pods)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type=device_type)


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...], device_type: str = "cuda"):
    """A ``DeviceMesh`` of the first prod(shape) ranks of the default
    process group, named by ``axes``; raises without a group that large."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    n = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have < n:
        raise ValueError(
            f"mesh {shape} needs {n} devices, have {have} "
            "(dry-runs must initialise the fake process group: repro_torch.launch.dryrun)"
        )
    return DeviceMesh(device_type, torch.arange(n).reshape(shape), mesh_dim_names=tuple(axes))


def make_test_mesh(data: int = 2, model: int = 2, pod: int | None = None,
                   device_type: str = "cuda"):
    """Small mesh for tests (needs a process group of its size)."""
    if pod:
        return make_mesh((pod, data, model), ("pod", "data", "model"), device_type)
    return make_mesh((data, model), ("data", "model"), device_type)
