"""Hand-written CUDA kernels for Hopper (``csrc/``) and their plain PyTorch
versions; ``_build`` compiles and loads the sources at first use."""
