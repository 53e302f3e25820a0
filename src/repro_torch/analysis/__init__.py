"""Roofline and per-device cost analysis: ``roofline`` (the three-term
model, one H100 SXM by default, and ``model_flops_for``) and ``hlo``
(``collective_stats``, the reference's collective accounting of HLO text,
and ``TraceCounter``, the port's per-device FLOP, byte, collective and
memory counter over an eager step on DTensors)."""

__all__ = ["hlo", "roofline"]
