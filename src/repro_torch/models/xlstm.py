"""xLSTM blocks: mLSTM (matrix memory, chunkwise-parallel) and sLSTM (scalar).

mLSTM is a gated linear-attention recurrence with per-head scalar gates:

    C_t = f_t C_{t-1} + i_t k_t v_t^T        (matrix memory, dh x dh)
    n_t = f_t n_{t-1} + i_t k_t              (normalizer)
    h_t = (C_t^T q_t) / max(|n_t . q_t|, 1)

The forward uses the chunkwise-parallel form (intra-chunk quadratic,
inter-chunk carried state), a Python loop over chunks where the reference
scans.  As in the reference: sigmoid input and forget gates (bounded,
stabilizer-free) in place of the paper's exponential input gate.

sLSTM keeps the paper's exponential gating with the m-state stabilizer and
a per-head block-diagonal recurrent matrix; it steps through time in a
Python loop.  Decode writes both caches in place.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.models.layers import ParamBlock, dense_param, ones_param, param_device, zeros_param
from repro_torch.parallel.sharding import is_dtensor, local_blocks, shard_hint

__all__ = [
    "MLstm",
    "SLstm",
    "mlstm_apply",
    "mlstm_cache_init",
    "mlstm_decode",
    "slstm_apply",
    "slstm_cache_init",
    "slstm_decode",
]

_GATES = ("z", "i", "f", "o")


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


class MLstm(ParamBlock):
    """mLSTM's up-projection, per-head q/k/v, gates and down-projection
    (``mlstm_init`` in the reference)."""

    def __init__(self, gen, cfg, stack, *, dtype=torch.float32, device=None):
        super().__init__()
        d = cfg.d_model
        di = int(cfg.xlstm_proj_factor * d)  # pre-up-projection inner width
        h = cfg.num_heads
        dh = di // h
        mk = dict(stack=stack, dtype=dtype, device=param_device(gen, device))
        self.add("w_up", dense_param(gen, (d, 2 * di), ("embed", "inner"), **mk))
        # block-diagonal (per-head) q/k/v projections, as in the xLSTM reference
        for name in ("wq", "wk", "wv"):
            self.add(name, dense_param(gen, (h, dh, dh), ("heads", None, None), scale=dh ** -0.5,
                                       **mk))
        self.add("w_igate", dense_param(gen, (di, h), ("inner", "heads"), **mk))
        self.add("w_fgate", dense_param(gen, (di, h), ("inner", "heads"), **mk))
        self.add("b_fgate", ones_param((h,), ("heads",), **mk))  # bias > 0: long memory
        self.add("out_norm", ones_param((di,), ("inner",), **mk))
        self.add("w_down", dense_param(gen, (di, d), ("inner", "embed"), **mk))


def _mlstm_chunk(q, k, v, li, lf, c0, n0):
    """One chunk of the chunkwise-parallel mLSTM.

    q/k/v: (B, H, c, dh); li/lf: (B, H, c) log input/forget gates.
    c0: (B, H, dh, dh); n0: (B, H, dh). Returns (h, c1, n1)."""
    cum = torch.cumsum(lf, dim=-1)  # log decay from chunk start (inclusive)
    # intra-chunk decay matrix: M[t, j] = exp(cum_t - cum_j + li_j), j <= t
    log_m = cum[..., :, None] - cum[..., None, :] + li[..., None, :]
    c = q.shape[2]
    tri = torch.ones((c, c), dtype=torch.bool, device=q.device).tril()
    m = torch.where(tri, torch.exp(log_m), 0.0)

    scale = q.shape[-1] ** -0.5
    w = (q @ k.transpose(-1, -2)) * scale * m  # (B, H, c, c)
    intra = w @ v
    decay_t = torch.exp(cum)[..., None]  # (B, H, c, 1)
    inter = decay_t * ((q * scale) @ c0)
    # normalizer: q.n_t = decay_t * (q.n0) + row-sum of the gated qk matrix
    qn = decay_t[..., 0] * torch.einsum("bhtd,bhd->bht", q * scale, n0) + w.sum(dim=-1)
    h = (intra + inter) / torch.clamp(qn.abs(), min=1.0)[..., None]

    # carry updates: decay from t to chunk end (input gate included)
    total = cum[..., -1:]  # (B, H, 1)
    dec_end = torch.exp(total - cum + li)  # (B, H, c)
    c1 = torch.exp(total)[..., None] * c0 + torch.einsum("bhtd,bhte,bht->bhde", k, v, dec_end)
    n1 = torch.exp(total) * n0 + torch.einsum("bhtd,bht->bhd", k, dec_end)
    return h, c1, n1


def _mlstm_scan(q, k, v, li, lf, *, chunk):
    """The chunkwise-parallel recurrence over the sequence from zero state:
    q/k/v (B, H, S, dh), li/lf (B, H, S) -> h (B, H, S, dh)."""
    b, hh, s, dh = q.shape
    c0 = torch.zeros((b, hh, dh, dh), dtype=torch.float32, device=q.device)
    n0 = torch.zeros((b, hh, dh), dtype=torch.float32, device=q.device)
    hs = []
    for t0 in range(0, s, chunk):
        sl = slice(t0, t0 + chunk)
        h_c, c0, n0 = _mlstm_chunk(q[:, :, sl], k[:, :, sl], v[:, :, sl], li[..., sl],
                                   lf[..., sl], c0, n0)
        hs.append(h_c)
    return torch.cat(hs, dim=2)


def _logsigmoid(x):
    """``F.logsigmoid``; on a DTensor each rank takes its own block (a
    ``Partial`` sum reduced first), since DTensor has no sharding rule for
    ``aten.log_sigmoid_backward``.  The same kernel runs either way, so the
    sharded gates keep the unsharded bits."""
    if not is_dtensor(x):
        return F.logsigmoid(x)
    return local_blocks(F.logsigmoid, [x], keep=range(x.ndim))


def _rms(x, w, eps=1e-6):
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.float()).to(x.dtype)


def mlstm_apply(p, x, cfg) -> torch.Tensor:
    """Full-sequence mLSTM. x: (B, S, D)."""
    b, s, d = x.shape
    hh = cfg.num_heads
    di = int(cfg.xlstm_proj_factor * d)
    dh = di // hh
    dtype = x.dtype
    chunk = cfg.scan_chunk if s % cfg.scan_chunk == 0 else s

    up = x @ p["w_up"].to(dtype)
    inner, z = up.chunk(2, dim=-1)  # (B, S, di)
    inner = shard_hint(inner, "batch", None, "inner")
    inner_h = inner.reshape(b, s, hh, dh).transpose(1, 2)  # (B, H, S, dh)
    q, k, v = (torch.einsum("bhsd,hde->bhse", inner_h, p[name].to(dtype)).float()
               for name in ("wq", "wk", "wv"))
    li = _logsigmoid(inner @ p["w_igate"].to(dtype)).float().transpose(1, 2)  # (B, H, S)
    lf = _logsigmoid(inner @ p["w_fgate"].to(dtype) + p["b_fgate"].to(dtype)).float()
    lf = lf.transpose(1, 2)

    scan = functools.partial(_mlstm_scan, chunk=chunk)
    if is_dtensor(q):
        # (batch, head) blocks are independent: each rank runs its own, so no
        # op meets DTensor's propagation (2.11's cannot flatten the sharded
        # (B, H) dims that the recurrence's batched products view as one)
        h = local_blocks(scan, [q, k, v, li, lf], keep=(0, 1))
    else:
        h = scan(q, k, v, li, lf)
    h = h.transpose(1, 2).reshape(b, s, di).to(dtype)
    h = _rms(h, p["out_norm"])
    h = h * F.silu(z)
    return h @ p["w_down"].to(dtype)


def mlstm_cache_init(cfg, batch: int, stack: int, dtype, device=None) -> tuple[dict, dict]:
    hh = cfg.num_heads
    dh = int(cfg.xlstm_proj_factor * cfg.d_model) // hh
    cache = {
        "C": torch.zeros((stack, batch, hh, dh, dh), dtype=torch.float32, device=device),
        "n": torch.zeros((stack, batch, hh, dh), dtype=torch.float32, device=device),
    }
    axes = {
        "C": ("layers", "batch", "heads", None, None),
        "n": ("layers", "batch", "heads", None),
    }
    return cache, axes


def mlstm_decode(p, x, cache, cfg) -> tuple[torch.Tensor, dict]:
    """One-token mLSTM decode. x: (B, 1, D); the cache is written in place."""
    b, d = x.shape[0], cfg.d_model
    hh = cfg.num_heads
    di = int(cfg.xlstm_proj_factor * d)
    dh = di // hh
    dtype = x.dtype

    up = x[:, 0] @ p["w_up"].to(dtype)
    inner, z = up.chunk(2, dim=-1)
    inner_h = inner.reshape(b, hh, dh)
    q, k, v = (torch.einsum("bhd,hde->bhe", inner_h, p[name].to(dtype)).float()
               for name in ("wq", "wk", "wv"))
    i_g = torch.sigmoid(inner @ p["w_igate"].to(dtype)).float()  # (B, H)
    f_g = torch.sigmoid(inner @ p["w_fgate"].to(dtype) + p["b_fgate"].to(dtype)).float()

    c1 = f_g[..., None, None] * cache["C"] + i_g[..., None, None] * (k[..., :, None] * v[..., None, :])
    n1 = f_g[..., None] * cache["n"] + i_g[..., None] * k
    scale = dh ** -0.5
    num = torch.einsum("bhde,bhd->bhe", c1, q * scale)
    qn = torch.einsum("bhd,bhd->bh", n1, q * scale)
    h = num / torch.clamp(qn.abs(), min=1.0)[..., None]
    h = h.reshape(b, di).to(dtype)
    h = _rms(h, p["out_norm"])
    h = h * F.silu(z)
    out = (h @ p["w_down"].to(dtype))[:, None, :]
    cache["C"].copy_(c1)
    cache["n"].copy_(n1)
    return out, cache


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


class SLstm(ParamBlock):
    """sLSTM's gate projections, recurrent matrices and gated FFN
    (``slstm_init`` in the reference)."""

    def __init__(self, gen, cfg, stack, *, dtype=torch.float32, device=None):
        super().__init__()
        d = cfg.d_model
        hh = cfg.num_heads
        dh = d // hh
        mk = dict(stack=stack, dtype=dtype, device=param_device(gen, device))
        for gate in _GATES:
            self.add(f"w_{gate}", dense_param(gen, (d, d), ("embed", "inner"), **mk))
        for gate in _GATES:
            self.add(f"r_{gate}", dense_param(gen, (hh, dh, dh), ("heads", None, None),
                                              scale=dh ** -0.5, **mk))
        for gate in _GATES:
            self.add(f"b_{gate}", zeros_param((d,), ("inner",), **mk))
        self.add("out_norm", ones_param((d,), ("embed",), **mk))
        # post-recurrence gated MLP (xLSTM block: PF 4/3), rounded to 128
        ff = max(128, int(round(cfg.xlstm_slstm_pf * d / 128)) * 128)
        self.add("w_ff_gate", dense_param(gen, (d, ff), ("embed", "mlp"), **mk))
        self.add("w_ff_down", dense_param(gen, (ff, d), ("mlp", "embed"), **mk))


def _slstm_cell(pre, rec, c, n, m):
    """One sLSTM step from the gates' input and recurrent parts."""
    z = torch.tanh(pre["z"] + rec["z"])
    i_t = pre["i"] + rec["i"]
    f_t = pre["f"] + rec["f"]
    o = torch.sigmoid(pre["o"] + rec["o"])
    # exponential gating with a per-(B, H, dh) log-stabilizer state m
    m_new = torch.maximum(f_t + m, i_t)
    i_p = torch.exp(i_t - m_new)
    f_p = torch.exp(f_t + m - m_new)
    c_new = f_p * c + i_p * z
    n_new = f_p * n + i_p
    h_new = o * c_new / torch.clamp(n_new, min=1.0)
    return c_new, n_new, h_new, m_new


def _slstm_scan(*pre_r):
    """The sLSTM recurrence from zero state: the gates' input parts (B, S,
    H, dh) and then their recurrent matrices (H, dh, dh), both in
    ``_GATES`` order -> h (B, S, H, dh)."""
    pre = dict(zip(_GATES, pre_r[:len(_GATES)]))
    r = dict(zip(_GATES, pre_r[len(_GATES):]))
    b, _, hh, dh = pre["z"].shape
    c = n = h = m = torch.zeros((b, hh, dh), dtype=torch.float32, device=pre["z"].device)
    hs = []
    for t in range(pre["z"].shape[1]):
        rec = {g: torch.einsum("bhd,hde->bhe", h, r[g]) for g in _GATES}
        c, n, h, m = _slstm_cell({g: pre[g][:, t] for g in _GATES}, rec, c, n, m)
        hs.append(h)
    return torch.stack(hs, dim=1)


def _slstm_ffn(p, h, dtype):
    h = _rms(h, p["out_norm"])
    return F.gelu(h @ p["w_ff_gate"].to(dtype), approximate="tanh") @ p["w_ff_down"].to(dtype)


def slstm_apply(p, x, cfg) -> torch.Tensor:
    """Full-sequence sLSTM (sequential over time). x: (B, S, D)."""
    b, s, d = x.shape
    hh = cfg.num_heads
    dh = d // hh
    dtype = x.dtype
    # the gates' input contributions for all steps: (B, S, H, dh) each
    pre = [(x @ p[f"w_{g}"].to(dtype) + p[f"b_{g}"].to(dtype)).float().reshape(b, s, hh, dh)
           for g in _GATES]
    r = [p[f"r_{g}"].float() for g in _GATES]
    if is_dtensor(pre[0]):
        # (batch, head) blocks are independent and each head's recurrent
        # matrix follows its head: each rank walks its own block, so the
        # S sequential steps are plain tensor ops, not DTensor dispatches
        h = local_blocks(_slstm_scan, pre, r, keep=(0, 2), w_dims=({2: 0},) * len(r))
    else:
        h = _slstm_scan(*pre, *r)
    h = h.reshape(b, s, d).to(dtype)
    return _slstm_ffn(p, h, dtype)


def slstm_cache_init(cfg, batch: int, stack: int, dtype, device=None) -> tuple[dict, dict]:
    shape = (stack, batch, cfg.num_heads, cfg.d_model // cfg.num_heads)
    cache = {key: torch.zeros(shape, dtype=torch.float32, device=device)
             for key in ("c", "n", "h", "m")}
    return cache, {key: ("layers", "batch", "heads", None) for key in cache}


def slstm_decode(p, x, cache, cfg) -> tuple[torch.Tensor, dict]:
    """One-token sLSTM decode. x: (B, 1, D); the cache is written in place."""
    b, d = x.shape[0], cfg.d_model
    hh = cfg.num_heads
    dh = d // hh
    dtype = x.dtype
    rec = {g: torch.einsum("bhd,hde->bhe", cache["h"], p[f"r_{g}"].float()) for g in _GATES}
    pre = {g: (x[:, 0] @ p[f"w_{g}"].to(dtype) + p[f"b_{g}"].to(dtype)).float().reshape(b, hh, dh)
           for g in _GATES}
    state = _slstm_cell(pre, rec, cache["c"], cache["n"], cache["m"])
    for key, value in zip(("c", "n", "h", "m"), state):
        cache[key].copy_(value)
    out = _slstm_ffn(p, state[2].reshape(b, d).to(dtype), dtype)
    return out[:, None, :], cache
