"""Reference of the Qwen3 dense family (hf:Qwen/Qwen3-8B): pre-norm
decoder, GQA attention with per-head RMSNorm on q and k before RoPE
(halves rotated), SwiGLU MLP, untied head.  Plain PyTorch in float32
(``_plain``), one layer's weights cast at a time.

``param_specs`` is the layout the benchmark draws the weights in, each
stacked over the layers: its names and shapes are the ones both sides
read.  ``active_matmul_params`` counts the weights a token multiplies
through, the embedding and the head left out.
"""

from __future__ import annotations

from portbench.reference import _plain

NORM = "norm"  # drawn as 1 + 0.1 N


def param_specs(model: dict) -> dict:
    """name -> (shape, init): init is NORM or the normal's std."""
    L, d, v = model["n_layers"], model["d_model"], model["vocab_size"]
    h, kv, hd, ff = model["num_heads"], model["num_kv_heads"], model["head_dim"], model["d_ff"]
    pre = "stages.block0."
    specs = {
        "embed": ((v, d), 1.0),
        "head": ((d, v), d ** -0.5),
        "final_norm": ((d,), NORM),
        pre + "ln1": ((L, d), NORM),
        pre + "ln2": ((L, d), NORM),
        pre + "mixer.wq": ((L, d, h, hd), d ** -0.5),
        pre + "mixer.wk": ((L, d, kv, hd), d ** -0.5),
        pre + "mixer.wv": ((L, d, kv, hd), d ** -0.5),
        pre + "mixer.wo": ((L, h, hd, d), (h * hd) ** -0.5),
        pre + "mlp.w_gate": ((L, d, ff), d ** -0.5),
        pre + "mlp.w_up": ((L, d, ff), d ** -0.5),
        pre + "mlp.w_down": ((L, ff, d), ff ** -0.5),
    }
    if model.get("qk_norm"):
        specs[pre + "mixer.q_norm"] = ((L, hd), NORM)
        specs[pre + "mixer.k_norm"] = ((L, hd), NORM)
    return specs


def active_matmul_params(model: dict) -> int:
    d, h, kv, hd = model["d_model"], model["num_heads"], model["num_kv_heads"], model["head_dim"]
    attn = d * h * hd * 2 + d * kv * hd * 2
    return model["n_layers"] * (attn + 3 * d * model["d_ff"])


def last_logits(model: dict, weights: dict, tokens, mm=_plain.f32_mm):
    """(B, V) float32 logits at the last position of each prompt."""
    pre = "stages.block0.mlp."

    def mlp(x, i):
        w = _plain.layer_weights(weights, pre, i)
        return _plain.swiglu(x, w["w_gate"], w["w_up"], w["w_down"], mm)

    with _plain.strict_f32():
        return _plain.decoder_last_logits(model, weights, tokens, mlp, mm)
