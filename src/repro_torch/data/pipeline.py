"""Deterministic sharded synthetic-token data pipeline.

Production posture without external data: an infinite, seekable stream of
language-model batches that is

  * deterministic in (seed, step) — restarts resume bit-identically from a
    checkpointed step with no iterator state to persist beyond the step id;
  * host-sharded — each host generates only its slice of the global batch
    (disjoint by host_id), the standard multi-host input pattern;
  * structurally faithful — zipf-ish token marginals (real vocab usage is
    heavy-tailed, which matters for the SA switching-activity profiler that
    consumes these streams), next-token labels, packed positions.

numpy only: the port keeps its own copy of the reference's module, and its
batches equal the reference's byte for byte.  The training step moves them
to the device.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["DataConfig", "DataIterator", "batch_at_step"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    num_hosts: int = 1
    host_id: int = 0
    seed: int = 0
    num_codebooks: int = 1
    zipf_a: float = 1.2  # heavy-tail exponent for token marginals

    def __post_init__(self):
        if self.global_batch % self.num_hosts:
            raise ValueError("global_batch must divide evenly across hosts")

    @property
    def host_batch(self) -> int:
        return self.global_batch // self.num_hosts


def _zipf_tokens(rng: np.random.Generator, shape, vocab: int, a: float) -> np.ndarray:
    """Zipf-distributed token ids, clipped to the vocab."""
    z = rng.zipf(a, size=shape)
    return np.minimum(z - 1, vocab - 1).astype(np.int32)


def batch_at_step(cfg: DataConfig, step: int) -> dict[str, np.ndarray]:
    """The (host-local) batch for a given global step. Pure function of
    (seed, step, host_id) — the whole fault-tolerance story for data."""
    rng = np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, cfg.host_id])
    )
    b, s = cfg.host_batch, cfg.seq_len
    shape = (b, s + 1) if cfg.num_codebooks == 1 else (b, s + 1, cfg.num_codebooks)
    stream = _zipf_tokens(rng, shape, cfg.vocab_size, cfg.zipf_a)
    tokens = stream[:, :-1]
    labels = stream[:, 1:]
    positions = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    return {"tokens": tokens, "labels": labels, "positions": positions}


class DataIterator:
    """Stateful wrapper: next() -> (step, batch); seekable for restart."""

    def __init__(self, cfg: DataConfig, start_step: int = 0):
        self.cfg = cfg
        self.step = start_step

    def __iter__(self):
        return self

    def __next__(self) -> tuple[int, dict[str, np.ndarray]]:
        batch = batch_at_step(self.cfg, self.step)
        step = self.step
        self.step += 1
        return step, batch

    def state(self) -> dict:
        return {"step": self.step}

    @classmethod
    def restore(cls, cfg: DataConfig, state: dict) -> "DataIterator":
        return cls(cfg, start_step=int(state["step"]))
