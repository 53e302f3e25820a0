"""Reference of the Jamba family (arXiv:2403.19887; hf:ai21labs/AI21-Jamba2-Mini):
a pre-norm decoder whose layers mix the sequence either by GQA attention
or by a Mamba-1 selective SSM, and whose MLP is either a dense SwiGLU or a
sparse MoE of SwiGLU experts.  Layer i attends where
i % attn_layer_period == attn_layer_offset and runs Mamba elsewhere; its
MLP is the MoE where i % expert_layer_period == expert_layer_offset.
Plain PyTorch in float32 (``_plain``, TF32 off), one layer's and one
expert's weights cast at a time.

* Attention: causal, no positional encoding (Jamba attends without one).
  ``_plain``'s attention rotates by zero angles here (cos 1, sin 0), which
  leaves q and k as they are, bit for bit.
* Mamba (HF ``JambaMambaMixer``): in_proj to (x, z); a causal depthwise
  convolution of width d_conv with bias; SiLU; x_proj to (dt, B, C); an
  RMSNorm with its own weight on each of dt, B and C; dt_proj with bias,
  softplus; the recurrence h_t = exp(delta_t A) h_{t-1} + delta_t x_t B_t
  from a zero state, computed token by token (``scan_block`` tokens'
  decays and inputs at a time, so that it fits on the card);
  y = (h_t . C_t + D x_t) silu(z_t); out_proj.  No bias on the projections.
* MoE (HF ``JambaSparseMoeBlock``): softmax over the experts of a linear
  router's logits, the top_k experts, their probabilities as the gates
  with no renormalisation; every routed token computed (dropless).

Departures from the published model: RMSNorm computes ``x * rsqrt(mean(x^2)
+ eps) * w`` in float32 throughout (HF rounds to the served type before
the weight); every weight product, the router's included, is float32,
where a deployment multiplies in bf16; weights are drawn from a seed, not
trained (``param_specs`` draws A_log, dt_bias and dt_proj so that some
channels keep a long memory, as a trained Mamba's small delta does).

``last_logit_candidates`` gives, for each prompt, the logits of every path
its last token may take through the experts when the router's logits are
known only to within ``margin`` (as ``mixtral.py``): the last token is
read by no other position, so a path changes only the last row from the
layer where it departs.  Each attention layer keeps the reference's keys
and values of the prompt, each Mamba layer its convolution window and
state at the last position (the d_conv - 1 inputs before it and the state
after the token before it), computed once by the full pass.
"""

from __future__ import annotations

import itertools

import torch
import torch.nn.functional as F

from portbench.reference import _plain

NORM = "norm"  # drawn as 1 + 0.1 N
MAX_PATHS = 256  # the most paths of one prompt's last token kept in a layer
SCAN_BLOCK = 256  # tokens whose decays and inputs the scan holds at once
# Normal draws of A_log and dt_bias: log(delta |A|) then spreads about
# sqrt(1 + 3^2 + 2^2) = 3.7 around 0 (dt_proj's product is about N(0, 1)),
# so about 3% of the (channel, state) pairs decay by less than 0.1% a token
# (delta |A| < 1e-3) and carry state across the whole prompt.
A_LOG_STD = 2.0
DT_BIAS_STD = 3.0


def _gcd(a: int, b: int) -> int:
    while b:
        a, b = b, a % b
    return a


def period(model: dict) -> int:
    """Layers of one repetition of the attention and MoE pattern."""
    a, e = model["attn_layer_period"], model["expert_layer_period"]
    return a * e // _gcd(a, e)


def is_attention(model: dict, layer: int) -> bool:
    return layer % model["attn_layer_period"] == model["attn_layer_offset"]


def is_moe(model: dict, layer: int) -> bool:
    return layer % model["expert_layer_period"] == model["expert_layer_offset"]


def _where(model: dict, layer: int) -> tuple:
    """(name prefix of the layer's block, its index on the stacked axis)."""
    p = period(model)
    return f"stages.block{layer % p}.", layer // p


def param_specs(model: dict) -> dict:
    """name -> (shape, init): init is NORM or the normal's std.  The names
    and stacking are the program's: block i of the repeated pattern,
    stacked over its repetitions."""
    d, v = model["d_model"], model["vocab_size"]
    h, kv, hd, ff = model["num_heads"], model["num_kv_heads"], model["head_dim"], model["d_ff"]
    e, n, k = model["num_experts"], model["mamba_d_state"], model["mamba_d_conv"]
    di, dtr = model["mamba_expand"] * d, model["mamba_dt_rank"]
    reps = model["n_layers"] // period(model)
    specs = {"embed": ((v, d), 1.0), "head": ((d, v), d ** -0.5), "final_norm": ((d,), NORM)}
    for layer in range(period(model)):
        pre = _where(model, layer)[0]
        specs[pre + "ln1"] = ((reps, d), NORM)
        specs[pre + "ln2"] = ((reps, d), NORM)
        if is_attention(model, layer):
            mixer = {"wq": ((d, h, hd), d ** -0.5), "wk": ((d, kv, hd), d ** -0.5),
                     "wv": ((d, kv, hd), d ** -0.5), "wo": ((h, hd, d), (h * hd) ** -0.5)}
        else:
            mixer = {"in_proj": ((d, 2 * di), d ** -0.5), "conv_w": ((k, di), k ** -0.5),
                     "conv_b": ((di,), 0.1), "x_proj": ((di, dtr + 2 * n), di ** -0.5),
                     "dt_proj": ((dtr, di), dtr ** -0.5), "dt_bias": ((di,), DT_BIAS_STD),
                     "A_log": ((di, n), A_LOG_STD), "D": ((di,), NORM),
                     "out_proj": ((di, d), di ** -0.5)}
            if model["mamba_inner_norms"]:
                mixer.update(dt_norm=((dtr,), NORM), b_norm=((n,), NORM), c_norm=((n,), NORM))
        if is_moe(model, layer):
            mlp = {"router": ((d, e), d ** -0.5), "w_gate": ((e, d, ff), d ** -0.5),
                   "w_up": ((e, d, ff), d ** -0.5), "w_down": ((e, ff, d), ff ** -0.5)}
        else:
            mlp = {"w_gate": ((d, ff), d ** -0.5), "w_up": ((d, ff), d ** -0.5),
                   "w_down": ((ff, d), ff ** -0.5)}
        for part, group in (("mixer.", mixer), ("mlp.", mlp)):
            for name, (shape, init) in group.items():
                specs[pre + part + name] = ((reps, *shape), init)
    return specs


def active_matmul_params(model: dict) -> int:
    """The weights a token multiplies through, the embedding and the head
    left out: each layer's mixer, and its dense MLP or the router and its
    top_k experts."""
    d, h, kv, hd, ff = (model[k] for k in ("d_model", "num_heads", "num_kv_heads", "head_dim",
                                           "d_ff"))
    di, dtr, n = model["mamba_expand"] * d, model["mamba_dt_rank"], model["mamba_d_state"]
    attn = d * h * hd * 2 + d * kv * hd * 2
    mamba = d * 2 * di + di * (dtr + 2 * n) + dtr * di + di * d
    total = 0
    for layer in range(model["n_layers"]):
        total += attn if is_attention(model, layer) else mamba
        total += (d * model["num_experts"] + model["top_k"] * 3 * d * ff if is_moe(model, layer)
                  else 3 * d * ff)
    return total


def _no_rotation(seq: int, head_dim: int, device) -> tuple:
    shape = (seq, head_dim // 2)
    return torch.ones(shape, device=device), torch.zeros(shape, device=device)


def _conv_inputs(x_in: torch.Tensor, width: int) -> torch.Tensor:
    """(B, S + width - 1, di): x_in after width - 1 zero positions."""
    return F.pad(x_in, (0, 0, width - 1, 0))


def _mamba_params(model: dict, w: dict, x_act: torch.Tensor, mm) -> tuple:
    """delta (..., di), B and C (..., N) of the convolution's activations."""
    dtr, n, eps = model["mamba_dt_rank"], model["mamba_d_state"], model["rms_eps"]
    dbc = mm(x_act, w["x_proj"])
    dt_low, b, c = dbc[..., :dtr], dbc[..., dtr:dtr + n], dbc[..., dtr + n:]
    if model["mamba_inner_norms"]:
        dt_low = _plain.rms_norm(dt_low, w["dt_norm"], eps)
        b = _plain.rms_norm(b, w["b_norm"], eps)
        c = _plain.rms_norm(c, w["c_norm"], eps)
    return F.softplus(mm(dt_low, w["dt_proj"]) + w["dt_bias"]), b, c


def scan(x_act, delta, a, b, c, block: int = SCAN_BLOCK) -> tuple:
    """sum_n h_t[n] C_t[n] of the recurrence h_t = exp(delta_t A) h_{t-1} +
    delta_t x_t B_t from a zero state, (B, S, di), token by token; and the
    state after the last token but one, (B, di, N)."""
    bsz, s, di = x_act.shape
    h = torch.zeros((bsz, di, a.shape[-1]), dtype=x_act.dtype, device=x_act.device)
    before_last = h
    y = torch.empty_like(x_act)
    for t0 in range(0, s, block):
        t1 = min(t0 + block, s)
        decay = torch.exp(delta[:, t0:t1, :, None] * a)  # (B, c, di, N)
        states = (delta * x_act)[:, t0:t1, :, None] * b[:, t0:t1, None, :]
        for t in range(t1 - t0):
            if t0 + t == s - 1:
                before_last = h
            h = states[:, t].addcmul_(decay[:, t], h)  # the input, plus the decayed state
        y[:, t0:t1] = torch.einsum("bcdn,bcn->bcd", states, c[:, t0:t1])
    return y, before_last.clone()


def mamba_block(model: dict, w: dict, x: torch.Tensor, mm, kept=None) -> torch.Tensor:
    """The Mamba mixer of (B, S, D) ``x`` with one layer's float32 weights
    ``w``; appends (convolution window (B, d_conv - 1, di), state (B, di,
    N)) at the last position to ``kept`` if it is given."""
    di, width = model["mamba_expand"] * model["d_model"], model["mamba_d_conv"]
    s = x.shape[1]
    xz = mm(x, w["in_proj"])
    x_in, z = xz[..., :di], xz[..., di:]
    padded = _conv_inputs(x_in, width)
    x_conv = w["conv_b"] + sum(padded[:, i:i + s] * w["conv_w"][i] for i in range(width))
    x_act = F.silu(x_conv)
    delta, b, c = _mamba_params(model, w, x_act, mm)
    y, before_last = scan(x_act, delta, -torch.exp(w["A_log"]), b, c)
    if kept is not None:
        kept.append((padded[:, s - 1:s + width - 2].clone(), before_last))
    return mm((y + w["D"] * x_act) * F.silu(z), w["out_proj"])


def _expert(weights: dict, pre: str, i: int, j: int) -> tuple:
    return tuple(weights[pre + w][i, j].float() for w in ("w_gate", "w_up", "w_down"))


def last_logits(model: dict, weights: dict, tokens, mm=_plain.f32_mm, expert_loads=None,
                last_routes=None, last_router=None, kept=None):
    """(B, V) float32 logits at the last position of each prompt; appends,
    per MoE layer, its largest expert load (tokens) to ``expert_loads``,
    its last tokens' experts, (B, top_k), to ``last_routes`` and their
    router logits, (B, E), to ``last_router``; and per layer what
    ``last_token_paths`` reads of it to ``kept``: the keys and values,
    (B, KV, S, hd), of an attention layer, the convolution window and
    state of a Mamba layer (``mamba_block``)."""
    e, k, eps = model["num_experts"], model["top_k"], model["rms_eps"]

    def moe(x, pre, i):
        b, s, d = x.shape
        t = x.reshape(b * s, d)
        logits = mm(t, weights[pre + "router"][i].float())
        gates, chosen = torch.topk(torch.softmax(logits, dim=-1), k, dim=-1)
        out = torch.zeros_like(t)
        loads = []
        for j in range(e):
            rows, slot = (chosen == j).nonzero(as_tuple=True)
            loads.append(rows.numel())
            if rows.numel():
                y = _plain.swiglu(t[rows], *_expert(weights, pre, i, j), mm)
                out.index_add_(0, rows, y * gates[rows, slot, None])
        if expert_loads is not None:
            expert_loads.append(max(loads))
        if last_routes is not None:
            last_routes.append(chosen.reshape(b, s, k)[:, -1].cpu())
        if last_router is not None:
            last_router.append(logits.reshape(b, s, e)[:, -1].cpu())
        return out.reshape(b, s, d)

    with _plain.strict_f32():
        s = tokens.shape[1]
        cos, sin = _no_rotation(s, model["head_dim"], tokens.device)
        x = weights["embed"][tokens.long()].float()
        for layer in range(model["n_layers"]):
            pre, i = _where(model, layer)
            norms = _plain.layer_weights(weights, pre, i)
            mixer = _plain.layer_weights(weights, pre + "mixer.", i)
            h = _plain.rms_norm(x, norms["ln1"], eps)
            if is_attention(model, layer):
                x = x + _plain.attention_block(model, mixer, h, cos, sin, mm, kept)
            else:
                x = x + mamba_block(model, mixer, h, mm, kept)
            del mixer
            h = _plain.rms_norm(x, norms["ln2"], eps)
            if is_moe(model, layer):
                x = x + moe(h, pre + "mlp.", i)
            else:
                w = _plain.layer_weights(weights, pre + "mlp.", i)
                x = x + _plain.swiglu(h, w["w_gate"], w["w_up"], w["w_down"], mm)
        return _plain.head_logits(model, weights, x[:, -1], mm)


def departures(logits: torch.Tensor, sets: list) -> torch.Tensor:
    """(N, len(sets)): for each row of (N, E) router logits and each
    expert set, how far below an expert left out the set's least logit
    lies (0 for the row's top-k set)."""
    chosen = torch.tensor(sets)
    inside = logits[:, chosen].amin(dim=-1)
    left_out = torch.ones(len(sets), logits.shape[1], dtype=torch.bool)
    left_out[torch.arange(len(sets))[:, None], chosen] = False
    outside = logits[:, None, :].masked_fill(~left_out, float("-inf")).amax(dim=-1)
    return (outside - inside).clamp_min(0.0)


def last_logit_candidates(model: dict, weights: dict, tokens, margin: float, info=None) -> list:
    """For each prompt, (C, V) float32 logits of the paths its last token
    may take within ``margin`` of the router's logits (the first row is
    the reference's own routing).  ``info`` (a dict) receives
    ``expert_loads``, ``paths`` (C of each prompt) and ``capped`` (prompts
    whose paths ran over ``MAX_PATHS`` in a layer and were cut to the
    nearest)."""
    info = {} if info is None else info
    kept = []
    with _plain.strict_f32():
        last_logits(model, weights, tokens, expert_loads=info.setdefault("expert_loads", []),
                    kept=kept)
        out = []
        for b in range(tokens.shape[0]):
            rows, capped = last_token_paths(model, weights, int(tokens[b, -1]),
                                             [(k[b], v[b]) for k, v in kept], margin)
            out.append(rows)
            info.setdefault("paths", []).append(rows.shape[0])
            info["capped"] = info.get("capped", 0) + capped
    return out


def _mamba_last(model: dict, w: dict, x: torch.Tensor, window: torch.Tensor,
                state: torch.Tensor) -> torch.Tensor:
    """The Mamba mixer's output at the last position for (N, D) rows ``x``
    there, from the prompt's (d_conv - 1, di) window and (di, N) state."""
    di = model["mamba_expand"] * model["d_model"]
    xz = x @ w["in_proj"]
    x_in, z = xz[:, :di], xz[:, di:]
    width = model["mamba_d_conv"]
    x_conv = (w["conv_b"] + (window * w["conv_w"][:width - 1]).sum(0)
              + x_in * w["conv_w"][width - 1])
    x_act = F.silu(x_conv)
    delta, b, c = _mamba_params(model, w, x_act, _plain.f32_mm)
    a = -torch.exp(w["A_log"])
    h = torch.exp(delta[:, :, None] * a) * state + (delta * x_act)[:, :, None] * b[:, None, :]
    y = (h * c[:, None, :]).sum(-1) + w["D"] * x_act
    return (y * F.silu(z)) @ w["out_proj"]


def last_token_paths(model: dict, weights: dict, last_token: int, kept: list,
                      margin: float) -> tuple:
    """(C, V) logits of every path of one prompt's last token (the
    reference's own first) and whether a layer had to cut its paths.
    ``kept`` holds each layer's pair as ``last_logits`` keeps it, for this
    prompt: keys and values (KV, S, hd), or window (d_conv - 1, di) and
    state (di, N)."""
    eps, window = model["rms_eps"], model.get("window")
    h, hd, e, k = model["num_heads"], model["head_dim"], model["num_experts"], model["top_k"]
    d = model["d_model"]
    cos, sin = _no_rotation(1, hd, kept[0][0].device)
    rows = weights["embed"][last_token].float()[None]  # (N, D): one row a path
    away = [0.0]  # each path's summed departure from the reference's own routing
    capped = False
    sets = list(itertools.combinations(range(e), k))
    for layer, (first, second) in enumerate(kept):
        pre, i = _where(model, layer)
        norms = _plain.layer_weights(weights, pre, i)
        mixer = _plain.layer_weights(weights, pre + "mixer.", i)
        x = _plain.rms_norm(rows, norms["ln1"], eps)
        if is_attention(model, layer):
            q, k_last, v_last = _plain.qkv(model, mixer, x[:, None], cos, sin, _plain.f32_mm)
            o = _plain.last_query_attention(q[:, :, 0], first, second, k_last[:, :, 0],
                                            v_last[:, :, 0], window)
            rows = rows + o.reshape(-1, h * hd) @ mixer["wo"].reshape(h * hd, d)
        else:
            rows = rows + _mamba_last(model, mixer, x, first, second)
        x = _plain.rms_norm(rows, norms["ln2"], eps)
        if not is_moe(model, layer):
            w = _plain.layer_weights(weights, pre + "mlp.", i)
            rows = rows + _plain.swiglu(x, w["w_gate"], w["w_up"], w["w_down"], _plain.f32_mm)
            continue
        logits = x @ weights[pre + "mlp.router"][i].float()
        probs = torch.softmax(logits, dim=-1)
        dep = departures(logits.cpu().double(), sets).tolist()
        children = sorted((away[p] + dep[p][n], p, c) for p in range(rows.shape[0])
                          for n, c in enumerate(sets) if dep[p][n] <= margin)
        capped |= len(children) > MAX_PATHS
        children = children[:MAX_PATHS]
        y = {}
        for j in range(e):
            parents = sorted({p for _, p, c in children if j in c})
            if parents:
                out = _plain.swiglu(x[parents], *_expert(weights, pre + "mlp.", i, j),
                                    _plain.f32_mm)
                y.update({(p, j): out[n] for n, p in enumerate(parents)})
        rows = torch.stack([rows[p] + sum(probs[p, j] * y[(p, j)] for j in c)
                            for _, p, c in children])
        away = [a for a, _, _ in children]
    return _plain.head_logits(model, weights, rows, _plain.f32_mm), capped
