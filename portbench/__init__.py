"""The benchmark of the PyTorch/CUDA port ``repro_torch``: data-driven
cells of the serving prefill path, run by ``python -m portbench.run``."""
