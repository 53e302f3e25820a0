"""Transformer building blocks: GQA attention, dense MLP, routed MoE.

Each block kind is a ``layers.ParamBlock`` whose constructor draws its
parameters stacked over stages (the reference's ``<block>_init``), with
apply functions for the full-sequence forward and the single-token cached
decode that take one stage's parameter dict.

Attention's forward has two routes, chosen by the caller (``attention=``),
never by a failure: ``"kernel"`` runs the hand-written K7
(``kernels.flash_attention.kernel.flash_attention_fwd``: its kernel on a
CUDA tensor, its plain version on a CPU one) on the KV heads as they are;
``"torch"`` runs the reference's program, KV heads repeated, through
``layers.blockwise_attention`` / ``dense_attention``.  Decode attention,
one query against a cache, stays a torch program, as do the MLP and MoE
products.  Decode updates the cache in place.

The MoE dispatch and combine run device-local, as one shard of the
reference's ``shard_map``: with no mesh active, local is global.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd
from repro_torch.models.layers import (
    ACTIVATIONS,
    ParamBlock,
    apply_rope,
    blockwise_attention,
    dense_attention,
    dense_param,
    mrope_angles,
    ones_param,
    param_device,
    rms_norm,
    rope_angles,
    zeros_param,
)
from repro_torch.parallel.sharding import shard_hint

__all__ = [
    "ATTENTION_ROUTES",
    "Attention",
    "Mlp",
    "Moe",
    "attn_apply",
    "attn_cache_init",
    "attn_decode",
    "mlp_apply",
    "moe_apply",
]

ATTENTION_ROUTES = ("kernel", "torch")


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


class Attention(ParamBlock):
    """GQA attention's projections (``attn_init`` in the reference)."""

    def __init__(self, gen, cfg, stack, *, dtype=torch.float32, device=None):
        super().__init__()
        d, hd = cfg.d_model, cfg.head_dim
        h, kv = cfg.num_heads, cfg.num_kv_heads
        mk = dict(stack=stack, dtype=dtype, device=param_device(gen, device))
        self.add("wq", dense_param(gen, (d, h, hd), ("embed", "heads", None), **mk))
        self.add("wk", dense_param(gen, (d, kv, hd), ("embed", "kv_heads", None), **mk))
        self.add("wv", dense_param(gen, (d, kv, hd), ("embed", "kv_heads", None), **mk))
        self.add("wo", dense_param(gen, (h, hd, d), ("heads", None, "embed"), **mk))
        if cfg.qkv_bias:
            self.add("bq", zeros_param((h, hd), ("heads", None), **mk))
            self.add("bk", zeros_param((kv, hd), ("kv_heads", None), **mk))
            self.add("bv", zeros_param((kv, hd), ("kv_heads", None), **mk))
        if cfg.qk_norm:
            self.add("q_norm", ones_param((hd,), (None,), **mk))
            self.add("k_norm", ones_param((hd,), (None,), **mk))


def _qkv(p, x, cfg, cos, sin):
    """Project + (bias) + (qk-norm) + rope. x: (B, S, D) -> q/k/v (B, H, S, hd)."""
    q = torch.einsum("bsd,dhk->bhsk", x, p["wq"].to(x.dtype))
    k = torch.einsum("bsd,dhk->bhsk", x, p["wk"].to(x.dtype))
    v = torch.einsum("bsd,dhk->bhsk", x, p["wv"].to(x.dtype))
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)[None, :, None, :]
        k = k + p["bk"].to(x.dtype)[None, :, None, :]
        v = v + p["bv"].to(x.dtype)[None, :, None, :]
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    if cos is not None:
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    return q, k, v


def _rope_tables(cfg, positions):
    """positions: (B, S) integers, or (3, B, S) for M-RoPE archs."""
    if positions is None or cfg.rope_kind == "none":
        return None, None
    if cfg.rope_kind == "mrope":
        return mrope_angles(positions, cfg.head_dim, cfg.mrope_sections, cfg.rope_theta)
    return rope_angles(positions, cfg.head_dim, cfg.rope_theta)


def attn_apply(p, x, cfg, positions, attention: str = "torch") -> torch.Tensor:
    """Full-sequence causal (or sliding-window) attention. x: (B, S, D).

    ``attention="kernel"`` runs K7 on q (B, H, S, hd) against k and v
    (B, KV, S, hd), which indexes the KV head itself; ``"torch"`` repeats
    the KV heads and runs the reference's program (blockwise above
    ``cfg.attn_chunk`` tokens, dense below).  A shape outside K7's contract
    raises on the kernel route."""
    s = x.shape[1]
    cos, sin = _rope_tables(cfg, positions)
    q, k, v = _qkv(p, x, cfg, cos, sin)
    q = shard_hint(q, "batch", "heads", None, None)
    k = shard_hint(k, "batch", "kv_heads", None, None)
    v = shard_hint(v, "batch", "kv_heads", None, None)
    if attention == "kernel":
        o = flash_attention_fwd(q.contiguous(), k.contiguous(), v.contiguous(),
                                causal=True, window=cfg.window)
    elif attention == "torch":
        rep = cfg.num_heads // cfg.num_kv_heads
        if rep > 1:
            k = k.repeat_interleave(rep, dim=1)
            v = v.repeat_interleave(rep, dim=1)
        if s > cfg.attn_chunk:
            o = blockwise_attention(q, k, v, causal=True, window=cfg.window,
                                    q_chunk=cfg.attn_chunk, k_chunk=cfg.attn_chunk)
        else:
            o = dense_attention(q, k, v, causal=True, window=cfg.window)
    else:
        raise ValueError(f"unknown attention route {attention!r}; expected one of {ATTENTION_ROUTES}")
    out = torch.einsum("bhsk,hkd->bsd", o, p["wo"].to(x.dtype))
    return shard_hint(out, "batch", "seq", "embed")


def attn_cache_init(cfg, batch: int, cache_len: int, stack: int, dtype,
                    device=None) -> tuple[dict, dict]:
    """KV cache (+ per-slot position ring for SWA), stacked over stages."""
    shape = (stack, batch, cfg.num_kv_heads, cache_len, cfg.head_dim)
    axes = ("layers", "batch", "kv_heads", "cache_seq", None)
    cache = {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "slot_pos": torch.full((stack, cache_len), -1, dtype=torch.int32, device=device),
    }
    return cache, {"k": axes, "v": axes, "slot_pos": ("layers", "cache_seq")}


def attn_decode(p, x, cache, pos: int, cfg) -> tuple[torch.Tensor, dict]:
    """One-token decode. x: (B, 1, D); ``cache`` holds one stage's views,
    k and v (B, KV, S_cache, hd) and slot_pos (S_cache,), which are
    written in place; ``pos`` is the new token's position."""
    b = x.shape[0]
    cache_len = cache["k"].shape[2]
    if cfg.rope_kind == "mrope":
        # decode: all three M-RoPE streams advance with the text position
        pos_arr = torch.full((3, b, 1), pos, dtype=torch.int32, device=x.device)
    else:
        pos_arr = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    cos, sin = _rope_tables(cfg, pos_arr)
    q, k_new, v_new = _qkv(p, x, cfg, cos, sin)

    if cfg.window is not None and cache_len == cfg.window:
        slot = pos % cache_len  # SWA ring buffer
    else:
        slot = min(pos, cache_len - 1)
    k, v, slot_pos = cache["k"], cache["v"], cache["slot_pos"]
    k[:, :, slot] = k_new[:, :, 0]
    v[:, :, slot] = v_new[:, :, 0]
    slot_pos[slot] = pos

    kv_heads, hd = cfg.num_kv_heads, cfg.head_dim
    qg = q.reshape(b, kv_heads, cfg.num_heads // kv_heads, hd)
    logits = (qg.float() @ k.float().transpose(-1, -2)) * hd ** -0.5  # (B, KV, rep, S)
    valid = slot_pos >= 0  # ring slots hold only in-window entries
    probs = torch.softmax(torch.where(valid, logits, -1.0e30), dim=-1)
    o = (probs @ v.float()).reshape(b, cfg.num_heads, 1, hd).to(x.dtype)
    out = torch.einsum("bhsk,hkd->bsd", o, p["wo"].to(x.dtype))
    return out, cache


# ---------------------------------------------------------------------------
# Dense (SwiGLU) MLP
# ---------------------------------------------------------------------------


class Mlp(ParamBlock):
    """SwiGLU (or plain two-matrix) MLP (``mlp_init`` in the reference)."""

    def __init__(self, gen, cfg, stack, d_ff: int | None = None, *, dtype=torch.float32,
                 device=None):
        super().__init__()
        d = cfg.d_model
        ff = d_ff if d_ff is not None else cfg.d_ff
        mk = dict(stack=stack, dtype=dtype, device=param_device(gen, device))
        self.add("w_gate", dense_param(gen, (d, ff), ("embed", "mlp"), **mk))
        if cfg.gated_mlp:
            self.add("w_up", dense_param(gen, (d, ff), ("embed", "mlp"), **mk))
        self.add("w_down", dense_param(gen, (ff, d), ("mlp", "embed"), **mk))


def mlp_apply(p, x, cfg) -> torch.Tensor:
    act = ACTIVATIONS[cfg.activation]
    h = act(x @ p["w_gate"].to(x.dtype))
    if cfg.gated_mlp:
        h = h * (x @ p["w_up"].to(x.dtype))
    h = shard_hint(h, *(("batch", None, "mlp") if x.ndim == 3 else ("batch", "mlp")))
    return h @ p["w_down"].to(x.dtype)


# ---------------------------------------------------------------------------
# Routed MoE (gather/scatter dispatch — no dense one-hot einsum flops)
# ---------------------------------------------------------------------------


class Moe(ParamBlock):
    """Router, expert tables and optional shared experts (``moe_init`` in
    the reference)."""

    def __init__(self, gen, cfg, stack, *, dtype=torch.float32, device=None):
        super().__init__()
        d, e = cfg.d_model, cfg.num_experts
        ff = cfg.moe_d_ff or cfg.d_ff
        device = param_device(gen, device)
        mk = dict(stack=stack, dtype=dtype, device=device)
        up_axes = ("experts", "expert_embed", "expert_mlp")
        self.add("router", dense_param(gen, (d, e), ("embed", None), **mk))
        self.add("w_gate", dense_param(gen, (e, d, ff), up_axes, **mk))
        self.add("w_up", dense_param(gen, (e, d, ff), up_axes, **mk))
        self.add("w_down", dense_param(gen, (e, ff, d), ("experts", "expert_mlp", "expert_embed"),
                                       **mk))
        if cfg.num_shared_experts:
            self.add_block("shared", Mlp(gen, cfg, stack, d_ff=ff * cfg.num_shared_experts,
                                         dtype=dtype, device=device))


def _top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest of each row, ties to the lower index (``lax.top_k``'s
    order): a stable descending sort, on the CPU and the card alike."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _dispatch_local(x_loc, expert_idx_loc, e: int, k_top: int, capacity: int, shards: int):
    """Per-shard (device-local) capacity dispatch. x_loc: (T_loc, D).

    Sort-based ranking (a stable sort: a slot's rank is its order among the
    slots routed to its expert), static capacity, overflow dropped.
    Returns the expert buffers reshaped to (shards, E*capacity/shards, D)
    (replication groups split an expert's capacity rows contiguously) and
    the slot -> buffer-row map for the combine (E*capacity for a drop)."""
    t_loc, d = x_loc.shape
    dev = x_loc.device
    eids = expert_idx_loc.reshape(-1).long()  # (T_loc*k,) slot-major
    slots = torch.arange(t_loc * k_top, device=dev)
    sort_idx = torch.argsort(eids, stable=True)
    sorted_eids = eids[sort_idx]
    group_start = torch.searchsorted(sorted_eids, torch.arange(e, device=dev))
    rank = torch.empty_like(slots)
    rank[sort_idx] = slots - group_start[sorted_eids]

    valid = rank < capacity
    dest = torch.where(valid, eids * capacity + rank, e * capacity)  # overflow row
    gathered = x_loc[slots // k_top]  # (T_loc*k, D)
    buf = torch.zeros((e * capacity + 1, d), dtype=x_loc.dtype, device=dev)
    buf.index_add_(0, dest, gathered * valid[:, None].to(x_loc.dtype))
    return buf[:-1].reshape(shards, e * capacity // shards, d), dest


def _combine_local(expert_out_loc, dest, gate_vals_loc, k_top: int):
    """Inverse of _dispatch_local: gather slots back to (T_loc, D), each
    weighted by its gate (a dropped slot by 0)."""
    d = expert_out_loc.shape[-1]
    flat = expert_out_loc.reshape(-1, d)  # same linear order dest indexes
    padded = torch.cat([flat, flat.new_zeros((1, d))])
    valid = (dest < flat.shape[0]).to(flat.dtype)
    per_slot = padded[dest] * (gate_vals_loc.reshape(-1) * valid)[:, None].to(flat.dtype)
    return per_slot.reshape(gate_vals_loc.shape[0], k_top, d).sum(dim=1)


def moe_apply(p, x, cfg, dropless: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Token-dispatch MoE. x: (B, S, D) -> (out, aux_loss).

    ``dropless=True`` sizes capacity at the worst case (T*k rows per
    expert) so no token is ever dropped: the decode setting, where a drop
    would make cached decoding diverge from the prefill forward pass."""
    b, s, d = x.shape
    e, k_top = cfg.num_experts, cfg.top_k
    t = b * s
    xt = x.reshape(t, d)

    router_logits = (xt @ p["router"].to(xt.dtype)).float()
    probs = torch.softmax(router_logits, dim=-1)  # (T, E)
    gate_vals, expert_idx = _top_k(probs, k_top)  # (T, k)
    if cfg.renormalize_topk:
        gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)

    # aux load-balance loss (Switch): E * sum_e f_e * P_e
    pe = probs.mean(dim=0)
    fe = F.one_hot(expert_idx[:, 0], e).float().mean(dim=0)
    aux = e * (fe * pe).sum()

    shards = cfg.expert_shards or e
    rep = shards // e
    if dropless:
        capacity = t * k_top
    else:
        capacity = max(int(t * k_top * cfg.capacity_factor) // e, 1)
    capacity = -(-capacity // rep) * rep  # the physical split must divide
    expert_in, dest = _dispatch_local(xt, expert_idx, e, k_top, capacity, shards)
    expert_out = _expert_ffn(p, expert_in, cfg)
    out = _combine_local(expert_out, dest, gate_vals, k_top)
    if cfg.num_shared_experts:
        out = out + mlp_apply(p["shared"], xt, cfg)
    return out.reshape(b, s, d), aux


def _expert_ffn(p, expert_in, cfg):
    """Batched SwiGLU over the physical expert buffers (shards, C_phys, D):
    with ``cfg.expert_shards`` > E, each expert's weights serve
    shards / E consecutive buffers (the dispatch split its capacity rows
    between them), which leaves the output unchanged."""
    act = ACTIVATIONS[cfg.activation]
    dt = expert_in.dtype
    e = cfg.num_experts
    shards = cfg.expert_shards or e
    rep = shards // e

    def phys(w):
        w = w.to(dt)
        if rep > 1:
            w = w[:, None].expand((e, rep) + w.shape[1:]).reshape((shards,) + w.shape[1:])
        return w

    h = act(torch.bmm(expert_in, phys(p["w_gate"])))
    h = h * torch.bmm(expert_in, phys(p["w_up"]))
    h = shard_hint(h, "experts", "expert_cap", "mlp")
    out = torch.bmm(h, phys(p["w_down"]))
    return shard_hint(out, "experts", "expert_cap", "embed")
