"""The benchmark's yardstick of work: operations and bytes a prefill step
needs, computed from the shapes alone, and the card's peaks.

* Model FLOPs of a step = 2 x (matmul weights a token multiplies through,
  the embedding and the head left out; for a mixture of experts the
  router and its top-k experts) x tokens, + 2 x D x V x B for the head on
  each prompt's last row, + 4 x head_dim x H_q x (visible query-key pairs)
  for each attention layer.  A capacity-padded slot an MoE computes and
  drops is not counted.
* K7 (the program's fused attention) per launch: 4 x head_dim x H_q x
  pairs operations; bytes are Q, K, V read once and O written once in the
  served type.  Its bound is the larger of operations over the peak
  FLOP/s and bytes over the peak bytes/s.
"""

from __future__ import annotations

import json
from pathlib import Path

PEAKS = Path(__file__).resolve().parent / "peaks.json"


def peaks_for(kind: str) -> dict | None:
    """The card's published peaks by its ``torch.cuda.get_device_name``,
    or None for a device the table does not hold."""
    return json.loads(PEAKS.read_text()).get(kind)


def visible_pairs(seq: int, window: int | None = None) -> int:
    """Query-key pairs one causal sequence of ``seq`` attends: key j is
    visible to query i where j <= i and, with a window, i - j < window."""
    if window is None or window >= seq:
        return seq * (seq + 1) // 2
    return window * (window + 1) // 2 + (seq - window) * window


def attention_flops(model: dict, batch: int, seq: int) -> int:
    """One attention layer's Q K^T and P V products over the visible pairs."""
    pairs = batch * visible_pairs(seq, model.get("window"))
    return 4 * model["head_dim"] * model["num_heads"] * pairs


def step_flops(model: dict, family, batch: int, seq: int) -> int:
    """Model FLOPs of one prefill step of ``batch`` prompts of ``seq``
    tokens that ends in the last position's logits."""
    tokens = batch * seq
    products = 2 * family.active_matmul_params(model) * tokens
    head = 2 * model["d_model"] * model["vocab_size"] * batch
    return products + head + model["n_layers"] * attention_flops(model, batch, seq)


def k7_bytes(model: dict, batch: int, seq: int, elem_bytes: int = 2) -> int:
    h, kv, hd = model["num_heads"], model["num_kv_heads"], model["head_dim"]
    return (2 * batch * h * seq * hd + 2 * batch * kv * seq * hd) * elem_bytes


def k7_bound_s(model: dict, batch: int, seq: int, peaks: dict) -> float:
    """Least time one K7 launch of a layer could take on the card."""
    return max(attention_flops(model, batch, seq) / peaks["bf16_flops_per_s"],
               k7_bytes(model, batch, seq) / peaks["hbm_bytes_per_s"])
