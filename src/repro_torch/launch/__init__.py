"""Launchers.  So far ``specs.token_shape``, the shape authority the
serving expansion shares; the mesh, step and serve launchers come with the
port's model slice."""
