"""Input shapes shared by the launchers and the serving workload expansion.

The reference's module also builds the dry run's batch, parameter,
optimizer-state and cache specs; they come with the training slice, which
brings the optimizer they need (the models' own shapes are
``repro_torch.models.model.shapes_and_axes``).  This file holds the token
shape they all derive from.
"""

from __future__ import annotations

__all__ = ["token_shape"]


def token_shape(cfg, batch: int, seq: int) -> tuple[int, ...]:
    """Token-array shape for one step: (B, S) or (B, S, codebooks).

    THE shape authority shared by the launchers' batch specs and the
    serving workload expansion (``repro_torch.serving.expand``): decode is
    ``seq == 1``, so ``token_shape(cfg, b, 1)`` is exactly the decode
    step's token shape — one helper, no duplicated shape math.
    """
    if cfg.num_codebooks > 1:
        return (batch, seq, cfg.num_codebooks)
    return (batch, seq)
