"""Launchers: ``specs`` (the step inputs' shapes and axes on the meta
device, and ``token_shape``, the shape authority the serving expansion
shares), ``steps`` (train, prefill and decode steps), ``serve`` (batched
prefill + greedy decode), ``train`` (the fault-tolerant training
launcher), ``mesh`` (DeviceMeshes over an initialised process group: the
production 16x16 and 2x16x16 meshes) and ``dryrun`` (every cell's step
traced on meta DTensors over a fake 512-rank process group, with its
per-device memory, cost, collectives and roofline)."""

__all__ = ["dryrun", "mesh", "serve", "specs", "steps", "train"]
