"""Launchers: ``specs.token_shape`` (the shape authority the serving
expansion shares) and ``serve`` (batched prefill + greedy decode).  The
mesh, step and training launchers come with later slices of the port."""
