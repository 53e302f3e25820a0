"""The port's spans and counters (``repro_torch.obs``) on the CPU: off,
the forward enters no ``record_function`` and counts nothing; on, a
profiler's trace holds the model stack's span tree, the logits are the
same bit for bit, and the MoE's and the Mamba scan's counters equal a
hand count."""

import dataclasses
import json
from collections import Counter

import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import obs
from repro_torch.configs.registry import get_arch
from repro_torch.models import blocks, ssm
from repro_torch.models.model import Model, forward

LAYERS = 2
ARCHS = ("qwen3_8b", "mixtral_8x7b")


def _cfg(arch: str, **replace):
    return dataclasses.replace(get_arch(arch).reduced(), n_layers=LAYERS, **replace)


def _run(cfg, seed: int = 0, batch: int = 2, seq: int = 16):
    model = Model(cfg, torch.Generator().manual_seed(seed))
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq),
                           generator=torch.Generator().manual_seed(seed + 1))
    return forward(cfg, model, tokens, last_only=True)[0]


@pytest.fixture
def fresh_counters():
    with obs.tracing():
        pass
    assert obs.counters() == {} and not obs.on()


@pytest.mark.parametrize("arch", ARCHS)
def test_tracing_off_enters_no_record_function(arch, monkeypatch, fresh_counters):
    entered = []
    real = torch.profiler.record_function

    def counting(name, *args):
        entered.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    _run(_cfg(arch))
    assert entered == [] and obs.counters() == {}
    with obs.tracing():
        _run(_cfg(arch))
    assert entered.count("model.forward") == 1  # the same patch sees the spans when on


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func.overloadpacket))
        return func(*args, **(kwargs or {}))


IDX = torch.randint(0, 4, (24, 2), generator=torch.Generator().manual_seed(4))


def _dispatch_ops(traced: bool) -> list:
    x = torch.randn(24, 8, generator=torch.Generator().manual_seed(3))
    with obs.tracing() if traced else torch.no_grad(), _Ops() as mode:
        blocks._dispatch_local(x, IDX, 4, 2, 10, 4)
    return mode.ops


def test_the_counters_off_path_launches_nothing(fresh_counters):
    off, on = _dispatch_ops(False), _dispatch_ops(True)
    assert Counter(on) - Counter(off) == Counter({
        "aten.bitwise_not": 1, "aten.sum": 1,  # the drop count
        "profiler._record_function_enter_new": 1, "profiler._record_function_exit": 1})
    assert "aten.sum" not in off and not any(op.startswith("profiler.") for op in off)
    assert not {"aten._local_scalar_dense", "aten.item"} & set(on)  # no sync while counting
    dropped = int((torch.bincount(IDX.reshape(-1), minlength=4) - 10).clamp(min=0).sum())
    assert dropped > 0 and obs.counters() == {"moe.slots_dropped": dropped}


def _spans(cfg, tmp_path) -> list:
    with obs.tracing(), profile(activities=[ProfilerActivity.CPU]) as prof:
        _run(cfg)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return sorted((float(e["ts"]), -float(e["dur"]), e["name"]) for e in events
                  if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                  and str(e.get("name", "")).startswith("model."))


def _parents(spans: list) -> Counter:
    """(span, innermost enclosing span) pairs: host spans nest on one thread."""
    pairs, open_ = Counter(), []
    for ts, neg_dur, name in spans:
        while open_ and open_[-1][1] <= ts:
            open_.pop()
        pairs[(name, open_[-1][0] if open_ else None)] += 1
        open_.append((name, ts - neg_dur))
    return pairs


def test_qwen3_span_tree(tmp_path):
    pairs = _parents(_spans(_cfg("qwen3_8b"), tmp_path))
    n = LAYERS
    assert pairs == Counter({
        ("model.forward", None): 1, ("model.embed", "model.forward"): 1,
        ("model.attn", "model.forward"): n, ("model.mlp", "model.forward"): n,
        ("model.norm", "model.forward"): 2 * n + 1,  # ln1, ln2, the final norm
        ("model.norm", "model.attn"): 2 * n,  # the q and k norms
        ("model.rope", "model.attn"): n, ("model.head", "model.forward"): 1})


def test_mixtral_span_tree(tmp_path):
    pairs = _parents(_spans(_cfg("mixtral_8x7b"), tmp_path))
    n = LAYERS
    assert pairs == Counter({
        ("model.forward", None): 1, ("model.embed", "model.forward"): 1,
        ("model.attn", "model.forward"): n, ("model.moe", "model.forward"): n,
        ("model.moe.route", "model.moe"): n, ("model.moe.dispatch", "model.moe"): n,
        ("model.moe.experts", "model.moe"): n, ("model.moe.combine", "model.moe"): n,
        ("model.norm", "model.forward"): 2 * n + 1, ("model.rope", "model.attn"): n,
        ("model.head", "model.forward"): 1})


@pytest.mark.parametrize("arch", ARCHS)
def test_logits_are_bitwise_equal_with_tracing_on_and_off(arch):
    off = _run(_cfg(arch))
    with obs.tracing(), profile(activities=[ProfilerActivity.CPU]):
        on = _run(_cfg(arch))
    assert torch.equal(off, on)


@pytest.mark.parametrize("capacity_factor", [1.25, 4.0])
def test_moe_counters_equal_a_hand_count(capacity_factor, monkeypatch):
    cfg = _cfg("mixtral_8x7b", capacity_factor=capacity_factor)
    e, k, batch, seq = cfg.num_experts, cfg.top_k, 2, 64
    calls = []
    real = blocks._dispatch_local

    def recording(x, idx, e_, k_, capacity, shards):
        buf, dest = real(x, idx, e_, k_, capacity, shards)
        calls.append((idx, capacity, dest))
        return buf, dest

    monkeypatch.setattr(blocks, "_dispatch_local", recording)
    with obs.tracing():
        _run(cfg, seed=2, batch=batch, seq=seq)  # drops 5 slots at 1.25
        got = obs.counters()
    assert len(calls) == LAYERS
    capacity = int(batch * seq * k * capacity_factor) // e
    by_load = sum(int((torch.bincount(idx.reshape(-1), minlength=e) - cap).clamp(min=0).sum())
                  for idx, cap, _ in calls)
    by_dest = sum(int((dest == e * cap).sum()) for _, cap, dest in calls)  # its own valid
    assert all(cap == capacity for _, cap, _ in calls)
    assert got == {"moe.slots": LAYERS * batch * seq * k,
                   "moe.slots_dropped": by_load,
                   "moe.expert_rows": LAYERS * e * capacity}
    assert by_dest == by_load
    if capacity_factor == 4.0:  # dropless: a quarter of the buffers' rows carry a slot
        assert by_load == 0
        assert 100 * got["moe.slots"] / got["moe.expert_rows"] == 100 * k / (e * k)
    else:
        assert by_load > 0


def test_tracing_restores_the_state_and_counts_ints_with_tensors(fresh_counters):
    with obs.tracing():
        obs.add("a", 2)
        obs.add("a", torch.tensor(3))
        obs.add("b", torch.tensor(True).sum())
        with obs.tracing():  # nested: zeroes, and leaves tracing on at its exit
            obs.add("c", 1)
        assert obs.on()
        obs.add("a", 4)
    assert not obs.on()
    obs.add("a", 100)  # off: not counted
    assert obs.counters() == {"a": 4, "c": 1}
    assert obs.span("x") is obs.span("y")  # one shared no-op while off


def _jamba_cfg():
    """Jamba reduced, one 8-layer period: Mamba in 7 layers, attention at 4,
    the MoE at the odd layers; the inner norms on, no RoPE."""
    return dataclasses.replace(get_arch("jamba_v01_52b").reduced(), mamba_inner_norms=True,
                               rope_kind="none")


def test_jamba_span_tree(tmp_path):
    pairs = _parents(_spans(_jamba_cfg(), tmp_path))
    assert pairs == Counter({
        ("model.forward", None): 1, ("model.embed", "model.forward"): 1,
        ("model.mamba", "model.forward"): 7, ("model.mamba.scan", "model.mamba"): 7,
        ("model.norm", "model.mamba"): 3 * 7,  # dt, B and C
        ("model.attn", "model.forward"): 1, ("model.mlp", "model.forward"): 4,
        ("model.moe", "model.forward"): 4, ("model.moe.route", "model.moe"): 4,
        ("model.moe.dispatch", "model.moe"): 4, ("model.moe.experts", "model.moe"): 4,
        ("model.moe.combine", "model.moe"): 4,
        ("model.norm", "model.forward"): 2 * 8 + 1, ("model.head", "model.forward"): 1})


def test_mamba_kernel_layers_count_the_fused_calls(monkeypatch):
    """One count a Mamba layer whose scan takes the fused route (forced
    here: on a CPU tensor L3's wrapper runs its plain version), none on
    the chunked route; the logits agree to float32 rounding."""
    cfg = _jamba_cfg()
    with obs.tracing():
        chunked = _run(cfg)
        assert "mamba.kernel_layers" not in obs.counters()
    monkeypatch.setattr(ssm, "scan_route", lambda *operands: "kernel")
    with obs.tracing():
        fused = _run(cfg)
        assert obs.counters()["mamba.kernel_layers"] == 7
    torch.testing.assert_close(fused, chunked, rtol=1e-5, atol=1e-5)
