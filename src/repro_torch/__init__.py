"""PyTorch/CUDA port of the asymmetric systolic-array floorplanning system.

Same module paths as the JAX package ``repro``: each ported module has one
counterpart there, which is the reference it is tested against.  The port
imports ``torch`` and numpy, never ``jax`` and nothing of ``repro``.

Entry points run on the CUDA card unless the caller asks for the CPU
(``backend="torch"`` or ``"numpy"`` in ``core.switching.profile_gemm``;
``engine="torch"`` or ``"numpy"`` in the design-space and layout evaluators).
"""
