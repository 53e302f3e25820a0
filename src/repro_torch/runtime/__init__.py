"""Fault-tolerance runtime: failure taxonomy + retry/degradation ladder
(``resilience``), deterministic fault injection (``faults``) and device
health/straggler policies (``health``)."""
