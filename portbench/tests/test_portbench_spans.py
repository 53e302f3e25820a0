"""``portbench/spans.py`` on synthetic Chrome traces: device records
joined to their launches by correlation id and charged to the program
spans that enclose the launch, idle gaps under ``portbench.forward`` cut
at the program spans' edges; the block metrics; ``trace.parse`` blind to
the program's spans; and a CPU run of a tiny cell's span pass."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from portbench import spans, trace
from portbench.tests.conftest import SRC


def _x(cat, name, ts, dur, **args):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": 1}
    if args:
        e["args"] = args
    return e


def _doc(program: bool = True) -> dict:
    """Three steps of 100 us (the first the profiler's warm-up); in each,
    the program's spans and four kernels: c1 launched under model.norm in
    model.attn, c2 under model.attn, c3 under model.forward alone, c4
    from the sync, outside every program span; and one record whose
    launch is missing."""
    events = []
    for i in range(3):
        t, c = 1000.0 + 100 * i, 10 * i
        events += [_x("user_annotation", "portbench.step", t, 100),
                   _x("user_annotation", "portbench.forward", t, 60),
                   _x("user_annotation", "portbench.sync", t + 60, 40)]
        if program:
            events += [_x("user_annotation", "model.forward", t + 2, 56),
                       _x("user_annotation", "model.attn", t + 4, 30),
                       _x("user_annotation", "model.norm", t + 5, 3)]
        for k, (launch, start, dur) in enumerate([(t + 6, t + 10, 8), (t + 20, t + 22, 10),
                                                  (t + 40, t + 41, 14), (t + 61, t + 70, 5)]):
            cat = "cuda_driver" if k == 1 else "cuda_runtime"
            events += [_x(cat, "cudaLaunchKernel", launch, 1, correlation=c + k),
                       _x("kernel", f"kernel{k}", start, dur, correlation=c + k)]
        events.append(_x("kernel", "orphan", t + 90, 2, correlation=999 + i))
    return {"traceEvents": events}


def test_records_are_charged_to_every_enclosing_span_once():
    got = spans.read(_doc())
    assert got.steps == 2 and got.unmatched == 2
    assert got.matched_share == pytest.approx(8 / 10)
    assert got.device_ms({"model.norm"}) == pytest.approx(8e-3)
    assert got.device_ms({"model.attn"}) == pytest.approx(18e-3)
    assert got.device_ms({"model.attn", "model.norm"}) == pytest.approx(18e-3)  # once
    assert got.device_ms({"model.forward"}) == pytest.approx(32e-3)
    assert got.device_ms({"model.attn"}, {"model.norm"}) == pytest.approx(10e-3)
    assert got.device_ms({"model.mlp"}) is None  # never entered
    assert got.opened == {"model.forward": 2, "model.attn": 2, "model.norm": 2}
    by = got.by_span()
    assert by["model.norm"][:2] == (pytest.approx(8e-3), 1)
    assert by["model.attn"][:2] == (pytest.approx(10e-3), 1)
    assert by["model.forward"][:2] == (pytest.approx(14e-3), 1)
    assert by[None][:2] == (pytest.approx(5e-3), 1)  # launched outside the program's spans
    assert got.coverage == pytest.approx(18 / 32)


def test_idle_under_forward_goes_to_the_innermost_program_span():
    got = spans.read(_doc())
    # busy [10, 18), [22, 32), [41, 55); forward [0, 60): idle [0, 2) under
    # forward alone, [2, 4) model.forward, [4, 5) attn, [5, 8) norm, [8, 10)
    # attn, [18, 22) attn, [32, 34) attn, [34, 41) model.forward, [55, 58)
    # model.forward, [58, 60) forward alone; each a step, two steps
    want = {"portbench.forward": 4, "model.forward": 12, "model.attn": 9, "model.norm": 3}
    assert got.idle == {k: pytest.approx(2 * v) for k, v in want.items()}
    # the pieces add up to what trace.parse charges to portbench.forward
    plain = trace.parse(_doc())
    assert sum(got.idle.values()) == pytest.approx(
        sum(s.gaps["portbench.forward"] for s in plain.full_steps))


def test_the_trace_reader_is_blind_to_the_program_spans():
    assert trace.parse(_doc(program=True)) == trace.parse(_doc(program=False))


def test_the_block_metrics():
    records = [(1000.0, ("model.forward", "model.moe", "model.moe.route")),
               (3000.0, ("model.forward", "model.moe", "model.moe.experts")),
               (500.0, ("model.forward", "model.moe", "model.moe.dispatch")),
               (700.0, ("model.forward", "model.attn")),
               (200.0, ("model.forward", "model.attn", "model.norm")),
               (100.0, ("model.forward", "model.attn", "model.rope")),
               (50.0, ("model.forward", "model.norm"))]
    opened = {n: 1 for _, names in records for n in names}
    got = {k: f(spans.Spans(2, records, 0, {}, opened)) for k, f in spans.METRICS.items()}
    assert got == {"attn_device_ms.prefill": pytest.approx(0.5),
                   "mlp_device_ms.prefill": pytest.approx(1.5),
                   "moe_route_device_ms.prefill": pytest.approx(0.75),
                   "norm_rope_device_ms.prefill": pytest.approx(0.175)}
    # a dense model: no MoE span entered, so no routing reading
    dense = [r for r in records if "model.moe" not in r[1]]
    opened = {n: 1 for _, names in dense for n in names}
    assert spans.METRICS["moe_route_device_ms.prefill"](spans.Spans(2, dense, 0, {}, opened)) is None


def test_expert_row_use_from_the_counters():
    # a Mixtral layer at capacity 4.0: 7,680 x 2 slots over 8 x 7,680 rows, 16 layers
    layers = 16
    counters = {"moe.slots": layers * 15360, "moe.slots_dropped": 0,
                "moe.expert_rows": layers * 61440}
    assert spans.expert_row_use_pct(counters) == 25.0
    counters["moe.slots_dropped"] = 1536
    assert spans.expert_row_use_pct(counters) == pytest.approx(100 * (16 * 15360 - 1536) / (16 * 61440))
    assert spans.expert_row_use_pct({}) is None


RUNNER = """
import json, sys, torch
from portbench import spans
args = json.loads(sys.argv[1])
out = spans.measure(args["workload"], args["seed"], torch.device("cpu"))
print(json.dumps(out))
"""


@pytest.mark.parametrize("workload", ["tiny_qwen3.tiny_chat", "tiny_mixtral.tiny_chat"])
def test_a_span_pass_on_the_cpu(checkout, workload):
    """Spans and counters come through; every device reading is None."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(checkout), str(SRC)]))
    proc = subprocess.run([sys.executable, "-c", RUNNER,
                           json.dumps({"workload": workload, "seed": 2**31 + 5})],
                          cwd=checkout, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["device"] == "cpu" and out["steps"] == 0 and out["coverage"] is None
    assert {k: v for k, v in out["metrics"].items() if k != "expert_row_use_pct.prefill"} == \
        dict.fromkeys(spans.METRICS)
    counters = out["counters"]
    if "mixtral" in workload:
        # 3 steps of 2 x 64 tokens, top-2, 2 layers; 4 experts at capacity 2.0
        assert counters["moe.slots"] == 3 * 2 * 128 * 2
        assert counters["moe.expert_rows"] == 3 * 2 * 4 * (128 * 2 * 2 // 4)
        assert out["metrics"]["expert_row_use_pct.prefill"] == spans.expert_row_use_pct(counters)
    else:
        assert counters == {} and out["metrics"]["expert_row_use_pct.prefill"] is None
    assert "on-cost" in proc.stderr and "off-cost" in proc.stderr
    assert out["off_cost_ns_per_span"] > 0
