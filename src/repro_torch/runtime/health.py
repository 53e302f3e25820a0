"""Cluster health: heartbeats + straggler detection.

Transport-agnostic (the coordinator feeds observations in; tests drive it
with simulated hosts). Policies:

  * a host is DEAD when its last heartbeat is older than ``timeout_s``;
  * a host is a STRAGGLER when the EMA of its per-step time exceeds the
    cluster median by ``straggler_factor`` for ``patience`` consecutive
    steps — the standard mitigation trigger (re-shard its data, or evict).
"""

from __future__ import annotations

import dataclasses
import statistics
from typing import Iterable


@dataclasses.dataclass
class HostState:
    host_id: int
    last_heartbeat: float = 0.0
    step_time_ema: float | None = None
    slow_streak: int = 0
    alive: bool = True


class HealthMonitor:
    def __init__(
        self,
        host_ids: Iterable[int],
        timeout_s: float = 60.0,
        straggler_factor: float = 1.5,
        patience: int = 3,
        ema_alpha: float = 0.3,
    ):
        self.hosts = {h: HostState(h) for h in host_ids}
        self.timeout_s = timeout_s
        self.straggler_factor = straggler_factor
        self.patience = patience
        self.ema_alpha = ema_alpha

    # -- observations ---------------------------------------------------------

    def heartbeat(self, host_id: int, now: float) -> None:
        h = self.hosts[host_id]
        h.last_heartbeat = now
        h.alive = True

    def report_step_time(self, host_id: int, seconds: float) -> None:
        h = self.hosts[host_id]
        if h.step_time_ema is None:
            h.step_time_ema = seconds
        else:
            a = self.ema_alpha
            h.step_time_ema = a * seconds + (1 - a) * h.step_time_ema

    # -- policies ---------------------------------------------------------------

    def dead_hosts(self, now: float) -> list[int]:
        out = []
        for h in self.hosts.values():
            if h.alive and now - h.last_heartbeat > self.timeout_s:
                h.alive = False
            if not h.alive:
                out.append(h.host_id)
        return sorted(out)

    def stragglers(self) -> list[int]:
        emas = [
            h.step_time_ema
            for h in self.hosts.values()
            if h.alive and h.step_time_ema is not None
        ]
        if len(emas) < 2:
            return []
        med = statistics.median(emas)
        out = []
        for h in self.hosts.values():
            if not h.alive or h.step_time_ema is None:
                continue
            if h.step_time_ema > self.straggler_factor * med:
                h.slow_streak += 1
            else:
                h.slow_streak = 0
            if h.slow_streak >= self.patience:
                out.append(h.host_id)
        return sorted(out)

    def alive_hosts(self) -> list[int]:
        return sorted(h.host_id for h in self.hosts.values() if h.alive)

    def evict(self, host_id: int) -> None:
        self.hosts[host_id].alive = False
