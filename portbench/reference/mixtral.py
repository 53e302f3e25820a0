"""Reference of the Mixtral family (arXiv:2401.04088): pre-norm decoder,
GQA attention with RoPE (halves rotated), and in every layer a sparse
MoE of SwiGLU experts: softmax router, top-k experts per token, their
gates renormalized over the k, every routed token computed (dropless, as
published).  Plain PyTorch in float32 (``_plain``), one layer's and one
expert's weights cast at a time.

``param_specs`` is the layout the benchmark draws the weights in (each
stacked over the layers, experts on the next axis).  ``last_logits``
also records, per layer, the most tokens routed to one expert
(``expert_loads``), which says whether a capacity bound would bind, the
experts each prompt's last token takes (``last_routes``) and its router
logits (``last_router``).

``last_logit_candidates`` gives, for each prompt, the logits of every
path its last token may take through the experts when the router's
logits are known only to within ``margin``: in every layer, each top-k
set whose every member's logit lies at most ``margin`` below the logit of
every expert left out.  The last token is attended by no other position,
so a path changes only the last row from the layer where it departs; the
other positions' keys and values are the reference's own.  A lower
precision re-routes a token whose 2nd and 3rd experts nearly tie, which
is a sound answer; these paths are the answers it may give.
"""

from __future__ import annotations

import itertools

import torch

from portbench.reference import _plain

NORM = "norm"  # drawn as 1 + 0.1 N
MAX_PATHS = 256  # the most paths of one prompt's last token kept in a layer


def param_specs(model: dict) -> dict:
    """name -> (shape, init): init is NORM or the normal's std."""
    L, d, v = model["n_layers"], model["d_model"], model["vocab_size"]
    h, kv, hd, ff = model["num_heads"], model["num_kv_heads"], model["head_dim"], model["d_ff"]
    e = model["num_experts"]
    pre = "stages.block0."
    return {
        "embed": ((v, d), 1.0),
        "head": ((d, v), d ** -0.5),
        "final_norm": ((d,), NORM),
        pre + "ln1": ((L, d), NORM),
        pre + "ln2": ((L, d), NORM),
        pre + "mixer.wq": ((L, d, h, hd), d ** -0.5),
        pre + "mixer.wk": ((L, d, kv, hd), d ** -0.5),
        pre + "mixer.wv": ((L, d, kv, hd), d ** -0.5),
        pre + "mixer.wo": ((L, h, hd, d), (h * hd) ** -0.5),
        pre + "mlp.router": ((L, d, e), d ** -0.5),
        pre + "mlp.w_gate": ((L, e, d, ff), d ** -0.5),
        pre + "mlp.w_up": ((L, e, d, ff), d ** -0.5),
        pre + "mlp.w_down": ((L, e, ff, d), ff ** -0.5),
    }


def active_matmul_params(model: dict) -> int:
    d, h, kv, hd = model["d_model"], model["num_heads"], model["num_kv_heads"], model["head_dim"]
    attn = d * h * hd * 2 + d * kv * hd * 2
    moe = d * model["num_experts"] + model["top_k"] * 3 * d * model["d_ff"]
    return model["n_layers"] * (attn + moe)


def last_logits(model: dict, weights: dict, tokens, mm=_plain.f32_mm, expert_loads=None,
                last_routes=None, last_router=None, kept=None):
    """(B, V) float32 logits at the last position of each prompt; appends
    each layer's largest expert load (tokens) to ``expert_loads``, its
    last tokens' experts, (B, top_k), to ``last_routes`` and their router
    logits, (B, E), to ``last_router``; ``kept`` as in
    ``_plain.decoder_last_logits``."""
    pre = "stages.block0.mlp."
    e, k = model["num_experts"], model["top_k"]

    def moe(x, i):
        b, s, d = x.shape
        t = x.reshape(b * s, d)
        logits = mm(t, weights[pre + "router"][i].float())
        probs = torch.softmax(logits, dim=-1)
        gates, chosen = torch.topk(probs, k, dim=-1)
        gates = gates / gates.sum(dim=-1, keepdim=True)
        out = torch.zeros_like(t)
        loads = []
        for j in range(e):
            rows, slot = (chosen == j).nonzero(as_tuple=True)
            loads.append(rows.numel())
            if not rows.numel():
                continue
            y = _plain.swiglu(t[rows], *_expert(weights, i, j), mm)
            out.index_add_(0, rows, y * gates[rows, slot, None])
        if expert_loads is not None:
            expert_loads.append(max(loads))
        if last_routes is not None:
            last_routes.append(chosen.reshape(b, s, k)[:, -1].cpu())
        if last_router is not None:
            last_router.append(logits.reshape(b, s, e)[:, -1].cpu())
        return out.reshape(b, s, d)

    with _plain.strict_f32():
        return _plain.decoder_last_logits(model, weights, tokens, moe, mm, kept)


def _expert(weights: dict, i: int, j: int) -> tuple:
    pre = "stages.block0.mlp."
    return tuple(weights[pre + w][i, j].float() for w in ("w_gate", "w_up", "w_down"))


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


def last_token_paths(model: dict, weights: dict, last_token: int, kept: list,
                      margin: float) -> tuple:
    """(C, V) logits of every path of one prompt's last token (the
    reference's own first) and whether a layer had to cut its paths.
    ``kept`` holds each layer's (KV, S, hd) keys and values of the prompt."""
    eps, window = model["rms_eps"], model.get("window")
    h, hd, e, k = model["num_heads"], model["head_dim"], model["num_experts"], model["top_k"]
    d = model["d_model"]
    s = kept[0][0].shape[1]
    cos, sin = _plain.rope_tables(s, hd, model["rope_theta"], kept[0][0].device)
    cos, sin = cos[-1:], sin[-1:]
    pre = "stages.block0."
    rows = weights["embed"][last_token].float()[None]  # (N, D): one row a path
    away = [0.0]  # each path's summed departure from the reference's own routing
    capped = False
    sets = list(itertools.combinations(range(e), k))
    for i, (keys, values) in enumerate(kept):
        norms = _plain.layer_weights(weights, pre, i)
        attn = _plain.layer_weights(weights, pre + "mixer.", i)
        q, k_last, v_last = _plain.qkv(model, attn, _plain.rms_norm(rows, norms["ln1"], eps)[:, None],
                                       cos, sin, _plain.f32_mm)
        o = _plain.last_query_attention(q[:, :, 0], keys, values, k_last[:, :, 0], v_last[:, :, 0],
                                        window)
        rows = rows + o.reshape(-1, h * hd) @ attn["wo"].reshape(h * hd, d)
        x = _plain.rms_norm(rows, norms["ln2"], eps)
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
                out = _plain.swiglu(x[parents], *_expert(weights, i, j), _plain.f32_mm)
                y.update({(p, j): out[n] for n, p in enumerate(parents)})
        nxt = []
        for _, p, c in children:
            gates = probs[p, list(c)] / probs[p, list(c)].sum()
            nxt.append(rows[p] + sum(g * y[(p, j)] for g, j in zip(gates, c)))
        rows = torch.stack(nxt)
        away = [a for a, _, _ in children]
    return _plain.head_logits(model, weights, rows, _plain.f32_mm), capped
