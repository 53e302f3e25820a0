"""Faults of the timed path that ``correct`` has to catch, as what they
do to a step's (B, V) logits.  ``readings.py`` reads them at a cell's
size; ``tests/faults.py`` plants them under a CPU run."""

from __future__ import annotations

import torch


def altered_token(logits: torch.Tensor) -> torch.Tensor:
    """The first prompt's served token altered where it is produced: the
    token after its best is lifted above it."""
    out = logits.clone()
    best = int(out[0].argmax())
    out[0, (best + 1) % out.shape[-1]] = out[0].amax() + 1.0
    return out


def half_batch(logits: torch.Tensor) -> torch.Tensor:
    """Half of the batch left out: the first half's answers given to the
    second half too."""
    half = max(logits.shape[0] // 2, 1)
    return logits[:half].repeat((logits.shape[0] + half - 1) // half, 1)[:logits.shape[0]]
