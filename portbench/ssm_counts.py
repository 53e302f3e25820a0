"""The yardstick of L3, the port's fused selective scan
(``selective_scan_fwd``): the bytes and operations one launch of a Mamba
layer's scan needs, from the shapes alone, and its bound on the card.

* Bytes: u, dt and z (B, S, d_inner) read once and y written once, B and
  C (B, S, N) read once, in the served type.
* Operations: 7 a (token, channel, state): delta times A, its exponential,
  the decayed state (a product), delta u times B, their sum, and C times
  the state summed over the states (a product and a sum); 10 a (token,
  channel): the bias add, softplus (an exponential and a log1p), delta
  times u, D times u and its sum, silu(z) (an exponential, a sum and a
  quotient) and the gate's product.  Counted at the CUDA cores' float32
  rate: the scan multiplies no matrix.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet: FP32, 67 TFLOP/s (CUDA cores, dense), at 700 W.
F32_FLOPS_PER_S = 67e12
OPS_PER_STATE = 7
OPS_PER_CHANNEL = 10


def _inner(model: dict) -> tuple[int, int]:
    return model["mamba_expand"] * model["d_model"], model["mamba_d_state"]


def scan_bytes(model: dict, batch: int, seq: int, elem_bytes: int = 2) -> int:
    di, n = _inner(model)
    return (4 * di + 2 * n) * batch * seq * elem_bytes


def scan_ops(model: dict, batch: int, seq: int) -> int:
    di, n = _inner(model)
    return (OPS_PER_STATE * n + OPS_PER_CHANNEL) * batch * seq * di


def scan_bound_s(model: dict, batch: int, seq: int, peaks: dict) -> float:
    """Least time one launch of a layer's scan could take on the card."""
    return max(scan_ops(model, batch, seq) / F32_FLOPS_PER_S,
               scan_bytes(model, batch, seq) / peaks["hbm_bytes_per_s"])
