"""Fault-tolerant training coordinator.

Drives the train step with:
  * periodic atomic checkpoints (params, optimizer, step, data-iterator),
  * preemption hook (SIGTERM -> checkpoint -> exit 143),
  * failure injection + restart-from-latest (tested for bit-identical resume),
  * health monitoring + elastic re-mesh planning on host loss.

Synchronous and single-process, as the reference's: on a cluster each host
runs one coordinator and the HealthMonitor observations arrive over the
cluster transport.  All decision logic (what to save, when to evict, how to
re-plan) is host-count agnostic and unit-tested with simulated hosts.

``init_state(device=None)`` builds the initial state on the run's device,
or on ``device``: the coordinator asks for it on ``meta`` (shapes only,
nothing drawn; the reference's ``eval_shape``) as the structure a
checkpoint restores into, then moves each restored leaf to ``device``.
Batches go to ``device`` too.
"""

from __future__ import annotations

import dataclasses
import signal
import time
from typing import Callable

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data.pipeline import DataConfig, DataIterator
from repro_torch.optim.adamw import tree_map
from repro_torch.runtime.elastic import plan_remesh
from repro_torch.runtime.health import HealthMonitor

__all__ = ["CoordinatorConfig", "TrainingCoordinator"]


@dataclasses.dataclass
class CoordinatorConfig:
    checkpoint_every: int = 50
    keep_checkpoints: int = 3
    max_steps: int = 1000
    heartbeat_timeout_s: float = 60.0


class TrainingCoordinator:
    def __init__(
        self,
        train_step: Callable[[dict, dict], tuple[dict, dict]],
        init_state: Callable[..., dict],
        data_cfg: DataConfig,
        ckpt: CheckpointManager,
        cfg: CoordinatorConfig = CoordinatorConfig(),
        host_ids: tuple[int, ...] = (0,),
        *,
        device: torch.device | str,
    ):
        self.train_step = train_step
        self.init_state_fn = init_state
        self.data_cfg = data_cfg
        self.ckpt = ckpt
        self.cfg = cfg
        self.device = torch.device(device)
        self.health = HealthMonitor(host_ids, timeout_s=cfg.heartbeat_timeout_s)
        self._preempted = False
        self.metrics_log: list[dict] = []

    # -- lifecycle -------------------------------------------------------------

    def install_preemption_handler(self) -> None:
        def handler(signum, frame):
            self._preempted = True

        signal.signal(signal.SIGTERM, handler)

    def _restore_or_init(self) -> tuple[int, dict]:
        latest = self.ckpt.restore_latest(like=self.init_state_fn(device="meta"))
        if latest is None:
            return 0, self.init_state_fn()
        step, state_host, extra = latest
        state = tree_map(lambda x: x.to(self.device), state_host)
        data_step = int(extra.get("data_step", step))
        return data_step, state

    # -- main loop ---------------------------------------------------------------

    def run(
        self,
        steps: int | None = None,
        fail_at_step: int | None = None,
    ) -> tuple[int, dict]:
        """Run until ``steps``; optionally inject a crash (for tests).

        Returns (last_step, final_state). Re-entrant: calling run() again
        resumes from the latest checkpoint, replaying nothing (data is a pure
        function of step) and duplicating nothing (checkpoints are atomic).
        """
        total = steps if steps is not None else self.cfg.max_steps
        start_step, state = self._restore_or_init()
        it = DataIterator(self.data_cfg, start_step=start_step)

        step = start_step
        while step < total:
            if self._preempted:
                self._save(step, state)
                raise SystemExit(143)
            t0 = time.time()
            step, batch = next(it)
            batch = {k: torch.from_numpy(v).to(self.device) for k, v in batch.items()}
            state, metrics = self.train_step(state, batch)
            loss = float(metrics["loss"])  # waits for the step
            dt = time.time() - t0
            self.health.heartbeat(self.data_cfg.host_id, time.time())
            self.health.report_step_time(self.data_cfg.host_id, dt)
            self.metrics_log.append({"step": step, "loss": loss, "sec": dt})
            step += 1
            if fail_at_step is not None and step == fail_at_step:
                raise RuntimeError(f"injected failure at step {step}")
            if step % self.cfg.checkpoint_every == 0 or step == total:
                self._save(step, state)
        return step, state

    def _save(self, step: int, state: dict) -> None:
        self.ckpt.save(step, state, extra={"data_step": step})

    # -- failure handling ---------------------------------------------------------

    def handle_host_failure(self, now: float, global_batch: int, model_axis: int):
        """Evict dead hosts and produce the new run plan (elastic restart)."""
        dead = self.health.dead_hosts(now)
        for h in dead:
            self.health.evict(h)
        return plan_remesh(self.health.alive_hosts(), global_batch, model_axis)
