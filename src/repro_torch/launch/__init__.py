"""Launchers: ``specs`` (the step inputs' shapes and axes on the meta
device, and ``token_shape``, the shape authority the serving expansion
shares), ``steps`` (train, prefill and decode steps), ``serve`` (batched
prefill + greedy decode) and ``train`` (the fault-tolerant training
launcher).  The mesh and dry-run launchers come with a later slice."""
