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
``layers.blockwise_attention`` / ``dense_attention``.  Before either, q and
k take their per-head norms and RoPE in one hand-written L4 pass each
where ``layers.norm_route`` finds plain CUDA rows with no gradient to
take (``layers.qk_norm_rope``), else the float32 chains.  Decode attention,
one query against a cache, stays a torch program, as do the MLP and MoE
products.  Decode updates the cache in place.

The MoE dispatch and combine run device-local: on each rank's tokens
under an active mesh (``local_map``, the reference's ``shard_map``), on
all of them without one.  On one device, at a mean routed load of a
tensor-core tile of rows or more, the expert products run on the routed
rows alone, sorted by expert (``COMPACT_MIN_ROWS``).  Under an active
mesh (DTensor inputs), either attention route runs on each rank's batch
and head shards through ``local_map``.
"""

from __future__ import annotations

import math

import torch

from repro_torch import obs
from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd
from repro_torch.models.layers import (
    ACTIVATIONS,
    ParamBlock,
    blockwise_attention,
    dense_attention,
    dense_param,
    mrope_angles,
    ones_param,
    param_device,
    qk_norm_rope,
    rope_angles,
    zeros_param,
)
from repro_torch.parallel.sharding import (
    Sharding,
    active_act_rules,
    active_mesh,
    is_dtensor,
    mesh_sizes,
    redistribute,
    replicated,
    shard_hint,
    spec_for_axes,
)

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
    # under a mesh, the projections' heads are split as the activation
    # rules split them (or replicated), never their flattened (heads x
    # head_dim) columns, which a head count the mesh does not divide could
    # not be unflattened from
    wq = shard_hint(p["wq"].to(x.dtype), "embed", "heads", None)
    wk = shard_hint(p["wk"].to(x.dtype), "embed", "kv_heads", None)
    wv = shard_hint(p["wv"].to(x.dtype), "embed", "kv_heads", None)
    q = torch.einsum("bsd,dhk->bhsk", x, wq)
    k = torch.einsum("bsd,dhk->bhsk", x, wk)
    v = torch.einsum("bsd,dhk->bhsk", x, wv)
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)[None, :, None, :]
        k = k + p["bk"].to(x.dtype)[None, :, None, :]
        v = v + p["bv"].to(x.dtype)[None, :, None, :]
    if cfg.qk_norm or cos is not None:
        weights = (p["q_norm"], p["k_norm"]) if cfg.qk_norm else (None, None)
        q, k = qk_norm_rope(q, k, *weights, cos, sin)
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
    if attention not in ATTENTION_ROUTES:
        raise ValueError(f"unknown attention route {attention!r}; expected one of {ATTENTION_ROUTES}")
    cos, sin = _rope_tables(cfg, positions)
    q, k, v = _qkv(p, x, cfg, cos, sin)
    q = shard_hint(q, "batch", "heads", None, None)
    k = shard_hint(k, "batch", "kv_heads", None, None)
    v = shard_hint(v, "batch", "kv_heads", None, None)
    o = _attention(q, k, v, cfg, attention)
    out = torch.einsum("bhsk,hkd->bsd", o, p["wo"].to(x.dtype))
    return shard_hint(out, "batch", "seq", "embed")


def _attention_local(q, k, v, cfg, route: str) -> torch.Tensor:
    """Attention of plain tensors on ``route``: q (B, H, S, hd) against k
    and v (B, KV, S, hd), each query head attending its KV head."""
    if route == "kernel":
        return flash_attention_fwd(q.contiguous(), k.contiguous(), v.contiguous(),
                                   causal=True, window=cfg.window)
    rep = q.shape[1] // k.shape[1]
    if rep > 1:
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    if q.shape[2] > cfg.attn_chunk:
        return blockwise_attention(q, k, v, causal=True, window=cfg.window,
                                   q_chunk=cfg.attn_chunk, k_chunk=cfg.attn_chunk)
    return dense_attention(q, k, v, causal=True, window=cfg.window)


def _attention(q, k, v, cfg, route: str) -> torch.Tensor:
    """``_attention_local``; on DTensors, on each rank's batch and head
    shards (``local_map``: attention is batch- and head-parallel, so that
    neither K7 nor the torch route's chunk loops redistribute anything),
    with k and v placed as q (no communication where the KV heads split as
    the query heads do; where they cannot, the KV heads are repeated to the
    query heads first)."""
    if not is_dtensor(q):
        return _attention_local(q, k, v, cfg, route)
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = q.device_mesh
    placements = [Replicate() if p.is_partial() else p for p in q.placements]
    if any(p.is_shard() and p.dim > 1 for p in placements):
        raise ValueError(f"attention needs whole sequences and heads on each rank: {q.placements}")
    head_parts = math.prod(mesh.size(i) for i, p in enumerate(placements) if p == Shard(1))
    if cfg.num_kv_heads % head_parts:
        rep = cfg.num_heads // cfg.num_kv_heads
        k, v = k.repeat_interleave(rep, dim=1), v.repeat_interleave(rep, dim=1)
    q, k, v = (redistribute(t, placements) for t in (q, k, v))
    return local_map(lambda ql, kl, vl: _attention_local(ql, kl, vl, cfg, route),
                     out_placements=placements, in_placements=(placements,) * 3,
                     device_mesh=mesh)(q, k, v)


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
    _write_slot(k, 2, slot, k_new[:, :, 0])
    _write_slot(v, 2, slot, v_new[:, :, 0])
    _write_slot(slot_pos, 0, slot, pos)

    kv_heads, hd = cfg.num_kv_heads, cfg.head_dim
    qg = q.reshape(b, kv_heads, cfg.num_heads // kv_heads, hd)
    logits = (qg.float() @ k.float().transpose(-1, -2)) * hd ** -0.5  # (B, KV, rep, S)
    valid = slot_pos >= 0  # ring slots hold only in-window entries
    probs = torch.softmax(torch.where(valid, logits, -1.0e30), dim=-1)
    o = (probs @ v.float()).reshape(b, cfg.num_heads, 1, hd).to(x.dtype)
    out = torch.einsum("bhsk,hkd->bsd", o, p["wo"].to(x.dtype))
    return out, cache


def _write_slot(buf: torch.Tensor, dim: int, slot: int, value) -> None:
    """``buf.select(dim, slot)[...] = value``, in place.  On a DTensor the
    rank whose block of ``dim`` holds ``slot`` writes its own block (the
    reference's ``dynamic_update_slice`` of a sharded cache); DTensor's own
    indexing would write a redistributed copy of a sharded ``dim``."""
    if not is_dtensor(buf):
        buf.select(dim, slot)[...] = value
        return
    from torch.distributed.tensor import Replicate, Shard

    mesh = buf.device_mesh
    along = [i for i, p in enumerate(buf.placements) if p == Shard(dim)]
    block = 0
    for i in along:
        block = block * mesh.size(i) + mesh.get_coordinate()[i]
    n_loc = buf.shape[dim] // math.prod(mesh.size(i) for i in along)
    if isinstance(value, torch.Tensor):
        # the value's placements: the buffer's with ``dim`` taken out
        placements = [Replicate() if p == Shard(dim)
                      else Shard(p.dim - 1) if p.is_shard() and p.dim > dim else p
                      for p in buf.placements]
        if not is_dtensor(value):
            value = replicated(value, mesh)
        value = redistribute(value, placements).to_local()
    if block * n_loc <= slot < (block + 1) * n_loc:
        buf.to_local().select(dim, slot - block * n_loc)[...] = value


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


def _rank_slots(expert_idx, e: int):
    """Sort-based ranking (a stable sort: a slot's rank is its order among
    the slots routed to its expert).  Returns the slot-major expert ids,
    the slots sorted by expert, each expert's first place in that order,
    and each slot's rank."""
    dev = expert_idx.device
    eids = expert_idx.reshape(-1).long()  # (T*k,) slot-major
    slots = torch.arange(eids.shape[0], device=dev)
    sort_idx = torch.argsort(eids, stable=True)
    sorted_eids = eids[sort_idx]
    group_start = torch.searchsorted(sorted_eids, torch.arange(e, device=dev))
    rank = torch.empty_like(slots)
    rank[sort_idx] = slots - group_start[sorted_eids]
    return eids, sort_idx, group_start, rank


def _dispatch_local(x_loc, expert_idx_loc, e: int, k_top: int, capacity: int, shards: int):
    """Per-shard (device-local) capacity dispatch. x_loc: (T_loc, D).

    ``_rank_slots``' ranking, static capacity, overflow dropped.
    Returns the expert buffers reshaped to (shards, E*capacity/shards, D)
    (replication groups split an expert's capacity rows contiguously) and
    the slot -> buffer-row map for the combine (E*capacity for a drop)."""
    with obs.span("model.moe.dispatch"):
        t_loc, d = x_loc.shape
        dev = x_loc.device
        eids, _, _, rank = _rank_slots(expert_idx_loc, e)
        valid = rank < capacity
        if obs.on():  # under a mesh, this rank's own drops
            obs.add("moe.slots_dropped", (~valid).sum())
        dest = torch.where(valid, eids * capacity + rank, e * capacity)  # overflow row
        gathered = x_loc[torch.arange(t_loc * k_top, device=dev) // k_top]  # (T_loc*k, D)
        buf = torch.zeros((e * capacity + 1, d), dtype=x_loc.dtype, device=dev)
        buf.index_add_(0, dest, gathered * valid[:, None].to(x_loc.dtype))
        return buf[:-1].reshape(shards, e * capacity // shards, d), dest


def _combine_rows(padded, dest, gate_vals, k_top: int):
    """Each slot's row of ``padded`` (whose last row is zero: a dropped
    slot's), weighted by its gate (a dropped slot by 0), summed over k."""
    d = padded.shape[-1]
    valid = (dest < padded.shape[0] - 1).to(padded.dtype)
    per_slot = padded[dest] * (gate_vals.reshape(-1) * valid)[:, None].to(padded.dtype)
    return per_slot.reshape(gate_vals.shape[0], k_top, d).sum(dim=1)


def _combine_local(expert_out_loc, dest, gate_vals_loc, k_top: int):
    """Inverse of _dispatch_local: gather slots back to (T_loc, D), each
    weighted by its gate (a dropped slot by 0)."""
    with obs.span("model.moe.combine"):
        d = expert_out_loc.shape[-1]
        flat = expert_out_loc.reshape(-1, d)  # same linear order dest indexes
        return _combine_rows(torch.cat([flat, flat.new_zeros((1, d))]), dest, gate_vals_loc, k_top)


# The compact path's rule: it runs where the mean routed load T * k / E is
# at least one tensor-core tile of rows.  Below that, the expert products
# are bound by reading the experts' weights, which the capacity buffers'
# padding does not change, and the compact path's one read of the row
# counts to the host a layer would only cost time.
COMPACT_MIN_ROWS = 128


def _dispatch_compact(x, expert_idx, e: int, k_top: int, capacity: int):
    """Every slot's row, sorted by expert: no padding. x: (T, D).

    ``_rank_slots``' ranking and ``_dispatch_local``'s drop rule (a slot
    is kept iff its rank is below ``capacity``).  Returns x's rows of the
    slots in the sorted order, (T*k, D): expert i's ``loads[i]`` rows
    follow the experts' before it, its kept ones first; ``loads``, a host
    list (the path's one sync); and the slot -> row map for the combine
    (a slot's sorted place; T*k, one zero row past the slots', for a drop)."""
    with obs.span("model.moe.dispatch"):
        eids, sort_idx, group_start, rank = _rank_slots(expert_idx, e)
        group_end = torch.searchsorted(eids[sort_idx], torch.arange(e, device=x.device), right=True)
        loads = (group_end - group_start).to("cpu", non_blocking=True)
        ready = None
        if x.is_cuda:
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(x.device))
        # queued before the host waits for the loads: the card gathers
        # while the host wakes
        rows = x[sort_idx // k_top]
        dest = torch.where(rank < capacity, group_start[eids] + rank, eids.shape[0])
        if ready is not None:
            ready.synchronize()
        loads = loads.tolist()
        obs.add("moe.slots_dropped", sum(max(n - capacity, 0) for n in loads))
        return rows, loads, dest


def _expert_ffn_compact(weights: list, rows, loads: list, capacity: int, cfg):
    """SwiGLU of each expert on its kept rows alone (the first
    min(loads[i], capacity) of its ``loads[i]``), each expert's weights
    (``weights[i]``: gate, up, down) used once.  Returns (T*k + 1, D) for
    ``_combine_rows``, whose last row is zero.  The combine reads no
    dropped slot's row, so without gradients the down products write
    straight into an uninitialised buffer; with them, zeros stand in for
    the dropped rows."""
    with obs.span("model.moe.experts"):
        slots, d = rows.shape
        act = ACTIVATIONS[cfg.activation]
        grad = torch.is_grad_enabled()
        out = None if grad else rows.new_empty((slots + 1, d))
        parts, start, kept = [], 0, 0
        for (w_gate, w_up, w_down), load in zip(weights, loads):
            count = min(load, capacity)
            if count:
                x_e = rows[start:start + count]
                h = act(x_e @ w_gate) * (x_e @ w_up)
                if grad:
                    parts.append(h @ w_down)
                else:
                    torch.matmul(h, w_down, out=out[start:start + count])
            if grad and load > count:
                parts.append(rows.new_zeros((load - count, d)))
            start += load
            kept += count
        obs.add("moe.expert_rows", kept)
        if grad:
            return torch.cat(parts + [rows.new_zeros((1, d))])
        out[slots].zero_()
        return out


def _token_partition(mesh, t: int, act_rules) -> tuple[str, ...] | None:
    """Mesh axes the flat token dim is sharded over (from the batch rule)."""
    entry = spec_for_axes(("batch",), (t,), mesh, act_rules)[0]
    if entry is None:
        return None
    return entry if isinstance(entry, tuple) else (entry,)


def moe_apply(p, x, cfg, dropless: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Token-dispatch MoE. x: (B, S, D) -> (out, aux_loss).

    ``dropless=True`` sizes capacity at the worst case (T*k rows per
    expert) so no token is ever dropped: the decode setting, where a drop
    would make cached decoding diverge from the prefill forward pass.

    Under an active mesh whose batch rule shards the tokens, the dispatch
    scatter and the combine gather run on each rank's own tokens
    (``local_map``, the reference's ``shard_map``) with a per-shard
    capacity, and only the dense (E, C, D) buffers cross ranks: resharded
    from capacity-sharded to expert-sharded (``shard_hint``, the
    expert-parallel all-to-all) and back.  Otherwise local is global.

    On a plain tensor whose mean routed load T * k / E is at least
    ``COMPACT_MIN_ROWS``, the dispatch sorts the slots' rows by expert with
    no padding, and the expert products run on the kept rows alone
    (``_dispatch_compact``, ``_expert_ffn_compact``; the same drops): the
    same result for one read of the E loads to the host.  Below it, and on
    DTensors, the (E, C, D) capacity buffers."""
    b, s, d = x.shape
    e, k_top = cfg.num_experts, cfg.top_k
    t = b * s
    xt = x.reshape(t, d)

    obs.add("moe.slots", t * k_top)
    with obs.span("model.moe.route"):
        router_logits = (xt @ p["router"].to(xt.dtype)).float()
        probs = torch.softmax(router_logits, dim=-1)  # (T, E)
        gate_vals, expert_idx = _top_k(probs, k_top)  # (T, k)
        if cfg.renormalize_topk:
            gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)

        # aux load-balance loss (Switch): E * sum_e f_e * P_e
        pe = probs.mean(dim=0)
        fe = (expert_idx[:, 0, None] == torch.arange(e, device=expert_idx.device)).float().mean(0)
        aux = e * (fe * pe).sum()

    mesh = active_mesh()
    tok_axes = (_token_partition(mesh, t, active_act_rules())
                if mesh is not None and is_dtensor(xt) else None)
    shards = cfg.expert_shards or e
    rep = shards // e

    t_loc = t // math.prod(mesh_sizes(mesh)[a] for a in tok_axes) if tok_axes else t
    if dropless:
        capacity = t_loc * k_top
    else:
        capacity = max(int(t_loc * k_top * cfg.capacity_factor) // e, 1)
    capacity = -(-capacity // rep) * rep  # the physical split must divide

    if not is_dtensor(xt) and t * k_top >= COMPACT_MIN_ROWS * e:
        # the compact path: a plain tensor, so no mesh shards the tokens
        obs.add("moe.compact_layers", 1)
        # the weights' views first: host work done while the card still
        # runs the router, before the dispatch waits for the loads
        weights = list(zip(*(p[name].to(xt.dtype).unbind(0)
                             for name in ("w_gate", "w_up", "w_down"))))
        rows, loads, dest = _dispatch_compact(xt, expert_idx, e, k_top, capacity)
        expert_out = _expert_ffn_compact(weights, rows, loads, capacity, cfg)
        with obs.span("model.moe.combine"):
            out = _combine_rows(expert_out, dest, gate_vals, k_top)
    elif tok_axes is None:
        # single-device / tiny-batch path: local == global
        expert_in, dest = _dispatch_local(xt, expert_idx, e, k_top, capacity, shards)
        expert_out = _expert_ffn(p, expert_in, cfg)
        out = _combine_local(expert_out, dest, gate_vals, k_top)
    else:
        from torch.distributed.tensor import Replicate
        from torch.distributed.tensor.experimental import local_map

        # the tokens' own placements, whose (B, S) the reshape below can
        # unflatten (a partial sum reduced); placements as lists, a tuple
        # would be one per output to local_map
        back = [Replicate() if p.is_partial() else p for p in xt.placements]
        tok = list(Sharding(mesh, (tok_axes, None)).placements)  # (T, .) sharded by token
        cap = list(Sharding(mesh, (None, tok_axes, None)).placements)  # (shards, C, D) by capacity
        slot = list(Sharding(mesh, (tok_axes,)).placements)  # (T*k,)
        x_tok, expert_idx, gate_vals = (redistribute(a, tok) for a in (xt, expert_idx, gate_vals))
        expert_in, dest = local_map(
            lambda xl, il: _dispatch_local(xl, il, e, k_top, capacity, shards),
            out_placements=(cap, slot), in_placements=(tok, tok), device_mesh=mesh,
        )(x_tok, expert_idx)
        # EP all-to-all: capacity-sharded -> expert-sharded (+ cap on DP axes)
        expert_in = shard_hint(expert_in, "experts", "expert_cap", "embed")
        expert_out = _expert_ffn(p, expert_in, cfg)
        # reverse all-to-all back to capacity-sharded for the local combine
        expert_out = redistribute(expert_out, cap)
        out = local_map(
            lambda eo, de, gv: _combine_local(eo, de, gv, k_top),
            out_placements=tok, in_placements=(cap, slot, tok), device_mesh=mesh,
        )(expert_out, dest, gate_vals)
        out = redistribute(out, back)

    if cfg.num_shared_experts:
        out = out + mlp_apply(p["shared"], xt, cfg)
    return out.reshape(b, s, d), aux


def _expert_ffn(p, expert_in, cfg):
    """Batched SwiGLU over the physical expert buffers (shards, C_phys, D):
    with ``cfg.expert_shards`` > E, each expert's weights serve
    shards / E consecutive buffers (the dispatch split its capacity rows
    between them), which leaves the output unchanged."""
    with obs.span("model.moe.experts"):
        obs.add("moe.expert_rows", expert_in.shape[0] * expert_in.shape[1])
        act = ACTIVATIONS[cfg.activation]
        dt = expert_in.dtype
        e = cfg.num_experts
        shards = cfg.expert_shards or e
        rep = shards // e

        def phys(w, axes):
            w = w.to(dt)
            if rep > 1:
                w = w[:, None].expand((e, rep) + w.shape[1:]).reshape((shards,) + w.shape[1:])
            return shard_hint(w, *axes)

        up_axes = ("experts", "expert_embed", "expert_mlp")  # (E, D, F)
        down_axes = ("experts", "expert_mlp", "expert_embed")  # (E, F, D)
        h = act(torch.bmm(expert_in, phys(p["w_gate"], up_axes)))
        h = h * torch.bmm(expert_in, phys(p["w_up"], up_axes))
        h = shard_hint(h, "experts", "expert_cap", "mlp")
        out = torch.bmm(h, phys(p["w_down"], down_axes))
        # pin the output layout, as the reference does
        return shard_hint(out, "experts", "expert_cap", "embed")
