"""Spans and counters of the model stack, off unless ``tracing()`` is on.

``span(name)`` marks a block on ``torch.profiler``'s own clock
(``record_function``), so that a trace holds the blocks on the host
beside the device records they launch; nesting on the host thread gives
each span its parent.  Off, it returns one shared ``nullcontext`` and
costs a flag test: it never enters ``record_function``, which costs
microseconds even with no profiler running.

``add(name, n)`` accumulates a counter: ``n`` a Python int, or a 0-d
tensor summed on its device with no sync.  Off, it does nothing; a
caller whose ``n`` costs work guards it with ``on()``.  ``counters()``
reads them, with one sync.

    with obs.tracing(), torch.profiler.profile(activities=...) as prof:
        forward(cfg, model, tokens)
    prof.export_chrome_trace("trace.json")
    obs.counters()  # {"moe.slots": ..., ...}
"""

from __future__ import annotations

import contextlib

import torch

__all__ = ["add", "counters", "on", "span", "tracing"]

_OFF = contextlib.nullcontext()
_on = False
_counts: dict = {}


def on() -> bool:
    return _on


def span(name: str):
    """A context manager: ``record_function(name)`` while tracing, else a no-op."""
    if not _on:
        return _OFF
    return torch.profiler.record_function(name)


def add(name: str, n) -> None:
    if _on:
        _counts[name] = _counts[name] + n if name in _counts else n


@contextlib.contextmanager
def tracing():
    """Spans and counters on, the counters zeroed; the previous state on exit."""
    global _on
    before = _on
    _on = True
    _counts.clear()
    try:
        yield
    finally:
        _on = before


def counters() -> dict[str, int]:
    """Each counter as an int: the device-side ones read in one transfer."""
    out = {k: v for k, v in _counts.items() if not isinstance(v, torch.Tensor)}
    held = {k: v for k, v in _counts.items() if isinstance(v, torch.Tensor)}
    if held:
        first = next(iter(held.values()))
        values = torch.stack([v.to(first.device, torch.int64) for v in held.values()]).tolist()
        out.update(zip(held, values))
    return {k: int(v) for k, v in sorted(out.items())}
