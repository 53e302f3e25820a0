"""Plain float32 pieces of a decoder-only transformer, shared by the
reference families in this folder.

Everything here is PyTorch on whatever device its tensors are on, in
float32 with TF32 off, and imports nothing of the program under test.
The weights arrive in the layout the benchmark draws them in (stacked
over layers, the names of ``param_specs`` in each family file); a family
casts one layer's weights to float32 at a time, so that the reference fits
on the card beside the weights it shares with the program.

``mm`` is the one product every weight passes through.  ``f32_mm`` is the
reference's own.  ``fp8_mm`` is the control's: both operands rounded to
float8 e4m3 (per-row scales for the activations, per-column scales for the
weights, each scale a power of two), then multiplied with float32
accumulation, which is what an fp8 GEMM computes.  A float8 value has four
significant bits, so TF32's eleven hold it exactly and the control may run
its products on the TF32 path without changing a bit of them.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0
_NEG_INF = float("-inf")


@contextlib.contextmanager
def strict_f32():
    """TF32 off for matrix products and convolutions, restored after."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def f32_mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x @ w


def to_e4m3(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one power-of-two scale per slice
    along ``dim`` (the slice's largest magnitude maps to at most 448),
    returned in float32."""
    amax = t.abs().amax(dim=dim, keepdim=True).clamp_min(torch.finfo(torch.float32).tiny)
    scale = torch.exp2(torch.ceil(torch.log2(amax / E4M3_MAX)))
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def fp8_mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    xq = to_e4m3(x, -1)
    wq = to_e4m3(w, 0)
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True  # exact on e4m3 operands
    try:
        return xq @ wq
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) * weight


def rope_tables(seq: int, head_dim: int, theta: float, device) -> tuple[torch.Tensor, torch.Tensor]:
    """cos and sin, (S, head_dim / 2), for positions 0 .. S-1."""
    half = head_dim // 2
    inv = 1.0 / theta ** (torch.arange(half, dtype=torch.float64, device=device) * 2 / head_dim)
    ang = torch.arange(seq, dtype=torch.float64, device=device)[:, None] * inv
    return torch.cos(ang).float(), torch.sin(ang).float()


def rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate (B, H, S, D) by the halves of D (the published models'
    ``rotate_half``)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int | None,
                     chunk: int = 1024) -> torch.Tensor:
    """Softmax attention of (B, H, S, D) queries over (B, KV, S, D) keys
    and values, query head h on KV head h // (H / KV); causal, and within
    ``window`` positions if one is given.  Exact softmax over each query
    chunk's visible keys."""
    b, h, s, d = q.shape
    kv = k.shape[1]
    rep = h // kv
    scale = d ** -0.5
    out = torch.empty_like(q)
    qg = q.reshape(b, kv, rep, s, d)
    for q0 in range(0, s, chunk):
        q1 = min(q0 + chunk, s)
        k0 = 0 if window is None else max(0, q0 - window + 1)
        rows = qg[:, :, :, q0:q1].reshape(b, kv, rep * (q1 - q0), d)
        logits = (rows @ k[:, :, k0:q1].transpose(-1, -2)) * scale  # (B, KV, rep*c, n)
        qi = torch.arange(q0, q1, device=q.device).repeat(rep)[:, None]
        kj = torch.arange(k0, q1, device=q.device)[None, :]
        hidden = kj > qi
        if window is not None:
            hidden |= qi - kj >= window
        probs = torch.softmax(logits.masked_fill_(hidden, _NEG_INF), dim=-1)
        o = probs @ v[:, :, k0:q1]
        out[:, :, q0:q1] = o.reshape(b, kv, rep, q1 - q0, d).reshape(b, h, q1 - q0, d)
    return out


def qkv(model: dict, w: dict, x: torch.Tensor, cos, sin, mm):
    """Queries (B, H, S, hd), keys and values (B, KV, S, hd) of (B, S, D)
    ``x`` with one layer's float32 weights ``w`` (wq (D, H, hd), wk and wv
    (D, KV, hd), optional per-head q_norm and k_norm (hd,)); RoPE at the
    positions of ``cos`` and ``sin``."""
    b, s, dm = x.shape
    h, kv, hd = model["num_heads"], model["num_kv_heads"], model["head_dim"]
    q = mm(x, w["wq"].reshape(dm, h * hd)).reshape(b, s, h, hd).transpose(1, 2)
    k = mm(x, w["wk"].reshape(dm, kv * hd)).reshape(b, s, kv, hd).transpose(1, 2)
    v = mm(x, w["wv"].reshape(dm, kv * hd)).reshape(b, s, kv, hd).transpose(1, 2)
    if "q_norm" in w:
        q = rms_norm(q, w["q_norm"], model["rms_eps"])
        k = rms_norm(k, w["k_norm"], model["rms_eps"])
    return rope(q, cos, sin), rope(k, cos, sin).contiguous(), v.contiguous()


def attention_block(model: dict, w: dict, x: torch.Tensor, cos, sin, mm, kept=None) -> torch.Tensor:
    """GQA self-attention of (B, S, D) ``x`` with one layer's float32
    weights ``w`` (``qkv``; wo (H, hd, D)).  Appends the layer's keys and
    values to ``kept`` if it is given."""
    b, s, dm = x.shape
    h, hd = model["num_heads"], model["head_dim"]
    q, k, v = qkv(model, w, x, cos, sin, mm)
    if kept is not None:
        kept.append((k, v))
    o = causal_attention(q, k, v, model.get("window"))
    return mm(o.transpose(1, 2).reshape(b, s, h * hd), w["wo"].reshape(h * hd, dm))


def swiglu(x: torch.Tensor, w_gate, w_up, w_down, mm) -> torch.Tensor:
    return mm(F.silu(mm(x, w_gate)) * mm(x, w_up), w_down)


def layer_weights(weights: dict, prefix: str, i: int) -> dict:
    """Layer ``i``'s weights under ``prefix``, in float32, keyed by the
    last part of their names."""
    return {name[len(prefix):]: t[i].float() for name, t in weights.items()
            if name.startswith(prefix) and "." not in name[len(prefix):]}


def decoder_last_logits(model: dict, weights: dict, tokens: torch.Tensor, mlp, mm,
                        kept=None) -> torch.Tensor:
    """Next-token logits (B, V) at the last position of every prompt in
    ``tokens`` (B, S): embedding, ``n_layers`` pre-norm blocks of
    attention and ``mlp(h, layer) -> (B, S, D)``, final norm, head.
    Appends each layer's keys and values, (B, KV, S, hd) after RoPE, to
    ``kept`` if it is given."""
    eps = model["rms_eps"]
    s = tokens.shape[1]
    cos, sin = rope_tables(s, model["head_dim"], model["rope_theta"], tokens.device)
    x = weights["embed"][tokens.long()].float()
    pre = "stages.block0."
    for i in range(model["n_layers"]):
        norms = layer_weights(weights, pre, i)
        attn = layer_weights(weights, pre + "mixer.", i)
        x = x + attention_block(model, attn, rms_norm(x, norms["ln1"], eps), cos, sin, mm, kept)
        x = x + mlp(rms_norm(x, norms["ln2"], eps), i)
    return head_logits(model, weights, x[:, -1], mm)


def head_logits(model: dict, weights: dict, last: torch.Tensor, mm) -> torch.Tensor:
    """Logits (N, V) of (N, D) last-position rows: final norm, head."""
    return mm(rms_norm(last, weights["final_norm"].float(), model["rms_eps"]),
              weights["head"].float())


def last_query_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, k_last: torch.Tensor,
                         v_last: torch.Tensor, window: int | None) -> torch.Tensor:
    """Attention of the last position's queries (N, H, hd) over a prompt's
    keys and values (KV, S, hd) with the last position's own replaced by
    (N, KV, hd) ``k_last`` and ``v_last``: (N, H, hd)."""
    n, h, hd = q.shape
    kv, s, _ = k.shape
    k0 = 0 if window is None else max(0, s - window)
    qg = q.reshape(n, kv, h // kv, hd)
    earlier = torch.einsum("nkrd,ksd->nkrs", qg, k[:, k0:s - 1])
    own = torch.einsum("nkrd,nkd->nkr", qg, k_last)[..., None]
    probs = torch.softmax(torch.cat([earlier, own], dim=-1) * hd ** -0.5, dim=-1)
    o = (torch.einsum("nkrs,ksd->nkrd", probs[..., :-1], v[:, k0:s - 1])
         + probs[..., -1:] * v_last[:, :, None])
    return o.reshape(n, h, hd)
