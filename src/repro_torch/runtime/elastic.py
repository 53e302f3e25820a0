"""Elastic re-meshing: rebuild the run plan when hosts join/leave.

On failure the coordinator (a) evicts dead hosts, (b) computes the largest
usable host count that keeps the mesh factorizable and the global batch
divisible, (c) restarts every survivor from the last checkpoint with a new
DataConfig — the data pipeline is a pure function of (seed, step, host_id),
so re-sharding data across a different host count is just handing out new
host ids. No training state beyond (checkpoint, step) needs migrating.
(The port's own copy of the reference's module, which imports nothing.)
"""

from __future__ import annotations

import dataclasses

__all__ = ["RunPlan", "largest_usable", "plan_remesh"]


@dataclasses.dataclass(frozen=True)
class RunPlan:
    hosts: tuple[int, ...]  # physical host ids, rank order
    num_hosts: int  # logical hosts in use (<= len(hosts))
    global_batch: int
    mesh_data: int  # data-axis size of the per-run mesh
    mesh_model: int


def largest_usable(n_alive: int, global_batch: int, model_axis: int) -> int:
    """Largest host count <= n_alive such that the batch still divides and
    the data axis stays a positive integer. Prefers powers of two (ICI-ring
    friendly), falls back to the largest divisor of global_batch."""
    best = 0
    n = 1
    while n <= n_alive:
        if global_batch % n == 0:
            best = n
        n *= 2
    if best:
        return best
    for n in range(n_alive, 0, -1):
        if global_batch % n == 0:
            return n
    return 1


def plan_remesh(
    alive_hosts: list[int],
    global_batch: int,
    model_axis: int = 1,
) -> RunPlan:
    """New run plan over the surviving hosts (deterministic: sorted ids)."""
    if not alive_hosts:
        raise RuntimeError("no hosts survive; cannot re-mesh")
    hosts = tuple(sorted(alive_hosts))
    n = largest_usable(len(hosts), global_batch, model_axis)
    return RunPlan(
        hosts=hosts[:n],
        num_hosts=n,
        global_batch=global_batch,
        mesh_data=n,
        mesh_model=model_axis,
    )
