"""The yardstick on the CPU: the reference families against the port's
forward at small widths in float32, the model-FLOP count against the
port's own operation counter, K7's pair count against a mask, and the
control's float8 rounding."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest
import torch

from portbench import counts, harness
from portbench.reference import _plain
from portbench.tests.conftest import TINY_MODELS, tiny_config

REFERENCE = Path(harness.PKG) / "reference"


def _setup(name: str, seed: int = 3, dtype: str = "float32"):
    doc = tiny_config(name, dtype)
    cfg = harness.port_config(doc)
    family = harness.load_module(REFERENCE / f"{doc['family']}.py")
    weights = harness.draw_weights(family.param_specs(doc["model"]), seed, "cpu",
                                   getattr(torch, dtype))
    tokens = torch.randint(0, doc["model"]["vocab_size"], (3, 80),
                           generator=torch.Generator().manual_seed(seed), dtype=torch.int32)
    return doc, cfg, family, weights, tokens


@pytest.mark.parametrize("route", ["torch", "kernel"])
@pytest.mark.parametrize("name", sorted(TINY_MODELS))
def test_reference_family_matches_the_port_in_float32(name, route):
    from repro_torch.models.model import forward

    doc, cfg, family, weights, tokens = _setup(name)
    program = harness.load_program(cfg, weights)
    got = forward(cfg, program, tokens, last_only=True, attention=route)[0]
    want = family.last_logits(doc["model"], weights, tokens)
    assert got.shape == want.shape == (3, doc["model"]["vocab_size"])
    rel = ((got - want).norm(dim=-1) / want.norm(dim=-1)).max().item()
    assert rel < 1e-5, rel


def test_weights_are_the_programs_own_tensors():
    doc, cfg, family, weights, _ = _setup("tiny_qwen3")
    program = harness.load_program(cfg, weights)
    state = program.state_dict()
    assert set(state) == set(weights)
    assert all(state[k].data_ptr() == weights[k].data_ptr() for k in weights)


def test_weights_follow_the_seed():
    specs = _setup("tiny_mixtral")[2].param_specs(tiny_config("tiny_mixtral")["model"])
    a = harness.draw_weights(specs, 2**31 + 5, "cpu", torch.bfloat16)
    b = harness.draw_weights(specs, 2**31 + 5, "cpu", torch.bfloat16)
    c = harness.draw_weights(specs, 2**31 + 6, "cpu", torch.bfloat16)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["embed"], c["embed"])
    assert all(v.dtype == torch.bfloat16 for v in a.values())


def _counted_flops(cfg, weights, tokens) -> int:
    from repro_torch.analysis.hlo import TraceCounter
    from repro_torch.models.model import forward

    program = harness.load_program(cfg, weights)
    counter = TraceCounter()
    with counter:
        forward(cfg, program, tokens, last_only=True, attention="torch")
    return counter.flops


def test_step_flops_match_the_ports_counter_on_a_dense_model():
    """The torch route attends every (query, key) pair of the square, the
    count only the causal ones; the rest must agree to the FLOP."""
    doc, cfg, family, weights, tokens = _setup("tiny_qwen3")
    m = doc["model"]
    b, s = tokens.shape
    square = m["n_layers"] * 4 * m["head_dim"] * m["num_heads"] * b * s * s
    ours = counts.step_flops(m, family, b, s)
    causal = m["n_layers"] * counts.attention_flops(m, b, s)
    assert _counted_flops(cfg, weights, tokens) == ours - causal + square


def test_step_flops_leave_out_the_moe_capacity_padding():
    """The program computes every expert's capacity-padded buffer; the
    count holds only the routed slots, so it lies below the counter by
    exactly the padding."""
    doc, cfg, family, weights, tokens = _setup("tiny_mixtral")
    m = doc["model"]
    b, s = tokens.shape
    t, e, k = b * s, m["num_experts"], m["top_k"]
    rep = cfg.expert_shards // e
    capacity = max(int(t * k * m["capacity_factor"]) // e, 1)
    capacity = -(-capacity // rep) * rep
    square = m["n_layers"] * 4 * m["head_dim"] * m["num_heads"] * b * s * s
    ours = counts.step_flops(m, family, b, s) - m["n_layers"] * counts.attention_flops(m, b, s)
    padding = m["n_layers"] * 6 * m["d_model"] * m["d_ff"] * (e * capacity - t * k)
    assert padding > 0
    assert _counted_flops(cfg, weights, tokens) == ours + square + padding


@pytest.mark.parametrize("seq,window", [(1, None), (7, None), (64, None), (64, 16), (64, 64),
                                        (64, 100), (33, 1)])
def test_visible_pairs_match_a_mask(seq, window):
    q = torch.arange(seq)[:, None]
    k = torch.arange(seq)[None, :]
    mask = k <= q
    if window is not None:
        mask &= q - k < window
    assert counts.visible_pairs(seq, window) == int(mask.sum())


def test_k7_bound_takes_the_larger_term():
    m = tiny_config("tiny_qwen3")["model"]
    peaks = {"bf16_flops_per_s": 1.0, "hbm_bytes_per_s": 1e30}
    assert counts.k7_bound_s(m, 2, 64, peaks) == counts.attention_flops(m, 2, 64)
    peaks = {"bf16_flops_per_s": 1e30, "hbm_bytes_per_s": 1.0}
    assert counts.k7_bound_s(m, 2, 64, peaks) == counts.k7_bytes(m, 2, 64)
    assert counts.peaks_for("NVIDIA H100 80GB HBM3")["bf16_flops_per_s"] == 989e12
    assert counts.peaks_for("cpu") is None


def test_e4m3_rounding_holds_four_significant_bits():
    x = torch.randn(64, 256, generator=torch.Generator().manual_seed(0)) * 37.0
    q = _plain.to_e4m3(x, -1)
    scale = torch.exp2(torch.ceil(torch.log2(x.abs().amax(-1, keepdim=True) / _plain.E4M3_MAX)))
    assert (q / scale).abs().max() <= _plain.E4M3_MAX
    assert torch.equal((q / scale).to(torch.float8_e4m3fn).float(), q / scale)
    normal = (q / scale).abs() >= 2.0 ** -6
    rel = ((q - x).abs() / x.abs())[normal]
    assert rel.max() <= 2.0 ** -4
    w = torch.randn(256, 32, generator=torch.Generator().manual_seed(1))
    exact = _plain.to_e4m3(x, -1).double() @ _plain.to_e4m3(w, 0).double()
    assert torch.allclose(_plain.fp8_mm(x, w).double(), exact, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("window", [None, 16, 80])
def test_last_query_attention_is_the_last_row_of_causal_attention(window):
    g = torch.Generator().manual_seed(4)
    q, k, v = (torch.randn(1, h, 80, 32, generator=g) for h in (4, 2, 2))
    want = _plain.causal_attention(q, k, v, window)[0, :, -1]
    got = _plain.last_query_attention(q[:, :, -1], k[0], v[0], k[:, :, -1], v[:, :, -1], window)
    torch.testing.assert_close(got[0], want, rtol=1e-5, atol=1e-6)


def test_departures_match_each_set_by_hand():
    import itertools

    family = harness.load_module(REFERENCE / "mixtral.py")
    logits = torch.randn(5, 8, generator=torch.Generator().manual_seed(2), dtype=torch.float64)
    sets = list(itertools.combinations(range(8), 2))
    got = family.departures(logits, sets)
    for n, row in enumerate(logits):
        top = set(row.topk(2).indices.tolist())
        for c, chosen in enumerate(sets):
            others = [j for j in range(8) if j not in chosen]
            want = max(0.0, float(row[others].max() - row[list(chosen)].min()))
            assert float(got[n, c]) == pytest.approx(want)
            assert (want == 0.0) == (set(chosen) == top)


def test_last_token_paths_at_margin_nought_are_the_reference():
    doc, _, family, weights, tokens = _setup("tiny_mixtral")
    want = family.last_logits(doc["model"], weights, tokens)
    info = {}
    got = family.last_logit_candidates(doc["model"], weights, tokens, 0.0, info)
    assert info["paths"] == [1, 1, 1] and info["capped"] == 0
    torch.testing.assert_close(torch.cat(got), want, rtol=1e-5, atol=1e-5)


def _flip_last_token(blocks, seq: int, layer: int):
    """The port's top-k with the last token's k-th expert swapped for its
    (k+1)-th in MoE call ``layer``."""
    inner, calls = blocks._top_k, []

    def top_k(probs, k):
        vals, idx = inner(probs, k + 1)
        if len(calls) == layer:
            last = torch.arange(seq - 1, probs.shape[0], seq)
            vals[last, k - 1], idx[last, k - 1] = vals[last, k], idx[last, k]
        calls.append(layer)
        return vals[:, :k].contiguous(), idx[:, :k].contiguous()

    return top_k


@pytest.mark.parametrize("layer", [0, 1])
def test_a_rerouted_last_token_is_one_of_the_reference_paths(monkeypatch, layer):
    """The port with each prompt's last token sent to its 1st and 3rd
    experts in one layer matches a path of the reference's candidates,
    and not the reference's own routing."""
    from repro_torch.models import blocks
    from repro_torch.models.model import forward

    doc, cfg, family, weights, tokens = _setup("tiny_mixtral")
    monkeypatch.setattr(blocks, "_top_k", _flip_last_token(blocks, tokens.shape[1], layer))
    got = forward(cfg, harness.load_program(cfg, weights), tokens, last_only=True,
                  attention="torch")[0]
    info = {}
    paths = family.last_logit_candidates(doc["model"], weights, tokens, float("inf"), info)
    assert info["paths"] == [36, 36, 36]  # 6 expert pairs in each of 2 layers
    for row, cand in zip(got, paths):
        err = (cand - row).norm(dim=-1) / cand.norm(dim=-1)
        assert err.min() < 1e-5 and err[0] > 1e-3, err


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(REFERENCE.glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_only_torch(path):
    assert _imports(path) <= {"__future__", "contextlib", "itertools", "torch", "portbench"}
    assert not any(n.startswith("portbench.") and n != "portbench.reference._plain"
                   for n in _module_refs(path))


def _module_refs(path: Path) -> set:
    refs = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.level == 0:
            refs |= {f"{node.module}.{a.name}" for a in node.names}
    return refs
