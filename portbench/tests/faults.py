"""The timed path broken underneath, for the tests that see ``correct``
come out false: each is a stand-in for ``harness.forward``."""

from __future__ import annotations

from portbench import faults, harness


def altered_token(cfg, model, tokens):
    return faults.altered_token(harness.forward(cfg, model, tokens))


def half_batch(cfg, model, tokens):
    return faults.half_batch(harness.forward(cfg, model, tokens))


_FIRST = {}


def stale_answer(cfg, model, tokens):
    """The state left unchanged: every step answers with the first step's
    logits."""
    if "logits" not in _FIRST:
        _FIRST["logits"] = harness.forward(cfg, model, tokens)
    return _FIRST["logits"]
