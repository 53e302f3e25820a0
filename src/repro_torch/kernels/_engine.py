"""Engine selection and kernel launch, shared by every kernel package.

An entry point's ``engine`` names where it runs: ``"cuda"`` (the default)
launches the hand-written kernels on the current CUDA device and raises
``CudaUnavailableError`` where there is none (it never falls back);
``"torch"`` runs their plain PyTorch versions on the CPU.  A kernel wrapper
itself decides by its tensors' device: a CPU tensor takes the plain
version, a CUDA tensor the kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _build

__all__ = ["ENGINES", "CudaUnavailableError", "engine_device", "launch", "on_cpu", "to_engine"]

ENGINES = ("cuda", "torch")


class CudaUnavailableError(RuntimeError):
    """``engine="cuda"`` was asked for on a host with no CUDA device."""


def engine_device(engine: str) -> torch.device:
    """The device ``engine`` runs on: the current CUDA device for
    ``"cuda"``, the CPU for ``"torch"``."""
    if engine == "torch":
        return torch.device("cpu")
    if engine == "cuda":
        if not torch.cuda.is_available():
            raise CudaUnavailableError(
                "engine='cuda' needs a CUDA device; use engine='torch' for the CPU"
            )
        return torch.device("cuda", torch.cuda.current_device())
    raise ValueError(f"unknown engine {engine!r}; expected one of {ENGINES}")


def to_engine(x, device: torch.device) -> torch.Tensor:
    """A numpy array or tensor as a contiguous tensor on ``device``: numpy
    input is copied there once, a contiguous tensor already there is used
    in place."""
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))
    return t.to(device).contiguous()


def on_cpu(x: torch.Tensor, fn_name: str) -> bool:
    """True for a CPU tensor (plain version), False for a CUDA one (kernel)."""
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"{fn_name} runs on cpu or cuda tensors, not {x.device}")
    return False


def launch(source: str, fn_name: str, device: torch.device, *args) -> None:
    """Call the C entry point ``fn_name`` of ``csrc/<source>.cu`` on
    ``device``'s current stream; raise if it reports a CUDA error.  The
    device is made current around the call only when it is not already.
    The stream handle comes from PyTorch's raw getter (the one its own
    kernel launchers use), which skips building a ``torch.cuda.Stream``:
    a few microseconds a call."""
    fn = getattr(_build.load(source), fn_name)
    current = torch.cuda.current_device()
    index = current if device.index is None else device.index
    if index == current:
        err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(f"{fn_name}: CUDA launch failed with error {err}")
