"""The MoE's compact path (``blocks._dispatch_compact``,
``_expert_ffn_compact``: the routed rows packed expert by expert, no
padding) against its capacity path (the zero-padded (E, C, D) buffers),
on the CPU in float32; the rule that picks it; its counters.

Tolerances: the two paths run the same products on the same rows, so
they differ only in the order of float32 sums inside each matrix product
(a row block of another height): outputs, aux loss and every gradient
within rtol = 1e-5 and atol = 1e-5 times the capacity path's largest
magnitude (``tests/test_torch_moe.py``'s rule), the kept rows and the
slot map exactly."""

import dataclasses

import numpy as np
import pytest
import torch
from _hyp import given, settings, st  # optional-hypothesis shim

from repro_torch import obs
from repro_torch.configs.registry import get_arch
from repro_torch.models import blocks as TB
from repro_torch.models.model import Model, forward

TOL = 1e-5
E = 8
T = TB.COMPACT_MIN_ROWS * E // 2  # top-2: a mean load of exactly the rule's rows


def _cfg(arch="mixtral_8x7b", **replace):
    return dataclasses.replace(get_arch(arch).reduced(), num_experts=E, **replace)


def _params(cfg, seed=0, skew=0.0, idle=None):
    """One MoE block's parameters as leaves with gradients on.  ``skew``
    raises expert 0's router logits (so that capacity 1.25 drops slots);
    ``idle`` lowers one expert's below every other, so that it gets no row."""
    block = TB.Moe(torch.Generator().manual_seed(seed), cfg, None).stage(None)
    params = {k: v.detach().clone() for k, v in block.items() if not isinstance(v, dict)}
    if cfg.num_shared_experts:
        params["shared"] = {k: v.detach().clone() for k, v in block["shared"].items()}
    params["router"][:, 0] += skew
    if idle is not None:
        params["router"][:, idle] = -10.0
    return params


def _leaves(tree, prefix=""):
    for name, value in sorted(tree.items()):
        if isinstance(value, dict):
            yield from _leaves(value, f"{prefix}{name}/")
        else:
            yield prefix + name, value


def _run(cfg, params, x, capacity_path: bool, monkeypatch):
    """(out, aux, {leaf: gradient}, counters) of one ``moe_apply`` under
    autograd, on the path asked for."""
    leaves = dict(_leaves(params))
    for t in leaves.values():
        t.requires_grad_(True)
    x = x.clone().requires_grad_(True)
    with monkeypatch.context() as m:
        if capacity_path:
            m.setattr(TB, "COMPACT_MIN_ROWS", 2**62)
        with obs.tracing():
            out, aux = TB.moe_apply(params, x, cfg)
            counters = obs.counters()
    loss = (out * torch.linspace(-1, 1, out.shape[-1])).sum() + 10 * aux
    grads = torch.autograd.grad(loss, [x, *leaves.values()])
    return out.detach(), aux.detach(), dict(zip(["x", *leaves], grads)), counters


def _close(got, want):
    want = want.numpy()
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL * np.abs(want).max())


CASES = {
    "no_drop": dict(cfg={"capacity_factor": 4.0}),
    "drops": dict(cfg={"capacity_factor": 1.25}, skew=0.5),
    "not_renormalized": dict(cfg={"renormalize_topk": False}, skew=0.5),
    "shared_expert": dict(arch="llama4_maverick_400b", cfg={}, skew=0.5, tokens=2 * T),
    "expert_shards": dict(cfg={"expert_shards": 2 * E, "capacity_factor": 1.25}, skew=0.5),
    "idle_expert": dict(cfg={"capacity_factor": 1.25}, idle=3),  # on positive inputs
}


@pytest.mark.parametrize("case", CASES)
def test_compact_path_matches_capacity_path(case, monkeypatch):
    spec = CASES[case]
    cfg = _cfg(spec.get("arch", "mixtral_8x7b"), **spec["cfg"])
    tokens = spec.get("tokens", T)  # top-1 (Llama-4) takes twice the tokens to the rule
    assert tokens * cfg.top_k == TB.COMPACT_MIN_ROWS * cfg.num_experts
    params = _params(cfg, skew=spec.get("skew", 0.0), idle=spec.get("idle"))
    x = torch.randn((2, tokens // 2, cfg.d_model), generator=torch.Generator().manual_seed(1))
    if spec.get("idle") is not None:
        x = x.abs()  # the idle expert's router logit is -10 times the row's sum
    got = _run(cfg, params, x, False, monkeypatch)
    want = _run(cfg, params, x, True, monkeypatch)

    assert got[3].get("moe.compact_layers") == 1 and "moe.compact_layers" not in want[3]
    assert got[3]["moe.slots_dropped"] == want[3]["moe.slots_dropped"]
    assert got[3]["moe.expert_rows"] == got[3]["moe.slots"] - got[3]["moe.slots_dropped"]
    if case in ("drops", "not_renormalized", "expert_shards", "idle_expert"):
        assert want[3]["moe.slots_dropped"] > 0
    _close(got[0], want[0])
    assert got[1].item() == pytest.approx(want[1].item(), rel=TOL)
    assert set(got[2]) == set(want[2]) >= {"x", "router", "w_gate", "w_up", "w_down"}
    if cfg.num_shared_experts:
        assert {"shared/w_gate", "shared/w_up", "shared/w_down"} <= set(got[2])
    for name in want[2]:
        _close(got[2][name], want[2][name])
    if case == "idle_expert":
        for name in ("w_gate", "w_up", "w_down"):
            assert not got[2][name][3].any() and not want[2][name][3].any()


def test_compact_products_leave_no_unwritten_row_to_the_combine(monkeypatch):
    """Without gradients the down products write into one uninitialised
    buffer, whose dropped slots' rows they never write: filled with NaN at
    allocation, the output is still the capacity path's (a dropped slot
    reads the zero last row)."""
    cfg = _cfg(capacity_factor=1.25)
    params = _params(cfg, skew=0.5)
    x = torch.randn((2, T // 2, cfg.d_model), generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        with monkeypatch.context() as m:
            m.setattr(torch.Tensor, "new_empty",
                      lambda self, size: self.new_full(size, float("nan")))
            with obs.tracing():
                got, _ = TB.moe_apply(params, x, cfg)
                assert obs.counters()["moe.slots_dropped"] > 0
        monkeypatch.setattr(TB, "COMPACT_MIN_ROWS", 2**62)
        want, _ = TB.moe_apply(params, x, cfg)
    assert torch.isfinite(got).all()
    _close(got, want)


@settings(deadline=None, max_examples=25)
@given(t=st.integers(4, 64), e=st.integers(2, 8), k=st.integers(1, 2), tight=st.booleans(),
       seed=st.integers(0, 100))
def test_compact_dispatch_keeps_the_capacity_dispatchs_slots(t, e, k, tight, seed):
    """Each slot the capacity dispatch keeps, the compact one keeps on a row
    of the same token, expert by expert in rank order; the drops agree."""
    rng = np.random.default_rng(seed)
    d = 8
    cap = max((t * k) // (2 * e if tight else e), 1)
    x = torch.from_numpy(rng.normal(size=(t, d)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, e, size=(t, k)).astype(np.int32))
    buf, dest = TB._dispatch_local(x, idx, e, k, cap, e)
    rows, loads, row_of = TB._dispatch_compact(x, idx, e, k, cap)
    buf, dest, rows, row_of = (a.numpy() for a in (buf, dest, rows, row_of))
    assert loads == np.bincount(idx.reshape(-1).numpy(), minlength=e).tolist()
    assert rows.shape == (t * k, d)
    kept = dest < e * cap
    np.testing.assert_array_equal(kept, row_of < t * k)
    assert (row_of[~kept] == t * k).all()
    # expert i's rows follow the rows of the experts before it, in rank order
    row_start = np.cumsum(loads) - loads
    expert, rank = dest[kept] // cap, dest[kept] % cap
    np.testing.assert_array_equal(row_of[kept], row_start[expert] + rank)
    np.testing.assert_array_equal(rows[row_of[kept]], buf.reshape(-1, d)[dest[kept]])
    # every slot's row is its token's, in the stable sort's order
    order = np.argsort(idx.reshape(-1).numpy(), kind="stable")
    np.testing.assert_array_equal(rows, x.numpy()[order // k])


@pytest.mark.parametrize("tokens,dropless,compact", [
    (T, False, True),  # a mean load of 128 rows an expert
    (T - 4, False, False),  # 127
    (T - 4, True, False),  # dropless sizing does not move the rule
    (16, True, False),  # decode: B = 16, one token each
])
def test_the_compact_rule_reads_the_mean_load(tokens, dropless, compact):
    cfg = _cfg()
    params = _params(cfg)
    seq = 1 if tokens == 16 else 4
    x = torch.randn((tokens // seq, seq, cfg.d_model), generator=torch.Generator().manual_seed(2))
    with torch.no_grad(), obs.tracing():
        TB.moe_apply(params, x, cfg, dropless=dropless)
        counters = obs.counters()
    assert counters.get("moe.compact_layers", 0) == int(compact)
    if compact:
        assert counters["moe.expert_rows"] == tokens * cfg.top_k - counters["moe.slots_dropped"]
    else:  # the capacity buffers: E x capacity rows
        assert counters["moe.expert_rows"] % cfg.num_experts == 0


LAYERS = 2


@pytest.mark.parametrize("capacity_factor", [1.25, 4.0])
def test_compact_counters_count_the_rows_run(capacity_factor, monkeypatch):
    """Through the model's forward (2 MoE layers, 2 x 128 tokens: the rule's
    mean load at 4 experts, top-2): the products' rows are the kept slots,
    one compact layer a MoE layer, and the capacity path drops the same
    slots."""
    cfg = dataclasses.replace(get_arch("mixtral_8x7b").reduced(), n_layers=LAYERS,
                              capacity_factor=capacity_factor)
    model = Model(cfg, torch.Generator().manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (2, 128), generator=torch.Generator().manual_seed(5))
    assert 2 * 128 * cfg.top_k == TB.COMPACT_MIN_ROWS * cfg.num_experts
    with obs.tracing():
        compact = forward(cfg, model, tokens, last_only=True)[0]
        got = obs.counters()
    monkeypatch.setattr(TB, "COMPACT_MIN_ROWS", 2**62)
    with obs.tracing():
        padded = forward(cfg, model, tokens, last_only=True)[0]
        want = obs.counters()
    assert got["moe.compact_layers"] == LAYERS and "moe.compact_layers" not in want
    assert got["moe.expert_rows"] == got["moe.slots"] - got["moe.slots_dropped"]
    assert got["moe.slots"] == want["moe.slots"] == LAYERS * 2 * 128 * cfg.top_k
    assert got["moe.slots_dropped"] == want["moe.slots_dropped"]
    capacity = int(2 * 128 * cfg.top_k * capacity_factor) // cfg.num_experts
    assert want["moe.expert_rows"] == LAYERS * cfg.num_experts * capacity
    _close(compact, padded)
