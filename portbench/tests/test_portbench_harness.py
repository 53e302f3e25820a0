"""The harness on the CPU: discovery by name, the dry run's result line,
the import check, the faults that must make ``correct`` false, the
control against the cells' limits, and the trace reader; one card test
runs a cell through the command."""

from __future__ import annotations

import ast
import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from portbench import check, harness, trace
from portbench.reference import _plain
from portbench.tests.conftest import ROOT, SRC, run_in, tiny_config

RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _last_line(proc) -> dict:
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("workload", ["tiny_qwen3.tiny_chat", "tiny_mixtral.tiny_chat"])
def test_cpu_dry_run_prints_a_well_formed_line(checkout, workload, traced):
    result = _last_line(run_in(checkout, workload, seed=2**31 + 11, seconds=1, trace=traced))
    assert list(result)[:5] == RESULT_KEYS and list(result)[-1] == "checks"
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] > 0
    assert result["device"] == {"platform": "cpu", "kind": "cpu", "count": 1}
    assert result["metrics"] == {}  # no device metric from a CPU run
    assert "breakdown" not in result
    assert set(result["checks"]) == {"rel_l2_max", "served_gap_max"}


def _hashes(root: Path) -> dict:
    return {p: hashlib.sha256(p.read_bytes()).hexdigest() for p in root.rglob("*") if p.is_file()}


def test_new_files_are_found_by_name(checkout):
    """A configuration, a traffic mix, a metric reader, a reference family
    and limits added as new files, with entries added to BENCHMARK.json,
    run with no existing file of the benchmark edited."""
    pkg = checkout / "portbench"
    before = _hashes(pkg)
    config = tiny_config("tiny_qwen3")
    config.update(name="new_cfg", family="new_family")
    (pkg / "configs" / "new_cfg.json").write_text(json.dumps(config))
    shutil.copy(pkg / "reference" / "qwen3.py", pkg / "reference" / "new_family.py")
    (pkg / "traffic" / "new_mix.json").write_text(json.dumps(
        {"name": "new_mix", "loop": "closed", "in_flight": 1, "batch": 1, "prompt_len": 32,
         "warmup_steps": 1, "check_steps": 1, "trace_steps": 2, "why": "test"}))
    (pkg / "metrics" / "new_metric.test.py").write_text(
        "def read(run):\n    return float(len(run.steps))\n")
    (pkg / "limits" / "new_cfg.new_mix.json").write_text(json.dumps(
        {"compared": {"rel_l2_max": {"limit": 1e-4}}}))
    bench = json.loads((checkout / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "new_cfg.new_mix", "config": "new_cfg",
                               "traffic": "new_mix", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "new_metric.test", "unit": "steps", "better": "higher",
                               "source": "host_clock", "layer": "test",
                               "moves": "prefill_tokens_per_s"})
    (checkout / "BENCHMARK.json").write_text(json.dumps(bench))
    result = _last_line(run_in(checkout, "new_cfg.new_mix", trace=True))
    assert result["correct"] is True
    assert result["metrics"]["new_metric.test"]["value"] >= 1
    assert result["metrics"]["new_metric.test"]["unit"] == "steps"
    after = _hashes(pkg)
    assert {p: h for p, h in after.items() if p in before and "__pycache__" not in p.parts} == \
        {p: h for p, h in before.items() if "__pycache__" not in p.parts}


@pytest.mark.parametrize("fault", ["altered_token", "half_batch", "stale_answer"])
@pytest.mark.parametrize("workload", ["tiny_qwen3.tiny_chat", "tiny_mixtral.tiny_chat"])
def test_a_broken_timed_path_is_not_correct(checkout, workload, fault):
    result = _last_line(run_in(checkout, workload, fault=fault))
    assert result["correct"] is False, result["checks"]


def test_an_unbroken_run_of_the_moe_is_correct(checkout):
    assert _last_line(run_in(checkout, "tiny_mixtral.tiny_chat"))["correct"] is True


def test_a_cell_without_limits_is_not_correct(checkout):
    (checkout / "portbench" / "limits" / "tiny_qwen3.tiny_chat.json").unlink()
    result = _last_line(run_in(checkout, "tiny_qwen3.tiny_chat"))
    assert result["correct"] is False and result["checks"] == {}


RUN_IMPORTS = """
import json, sys, time, torch
from portbench import harness
harness.execute("tiny_mixtral.tiny_chat", 5, 0.3, True, device=torch.device("cpu"),
                t0=time.perf_counter(), out=open("/dev/null", "w"))
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def test_a_run_loads_neither_jax_nor_the_jax_package(checkout):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(checkout), str(SRC)]))
    proc = subprocess.run([sys.executable, "-c", RUN_IMPORTS], cwd=checkout, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    loaded = set(json.loads(proc.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in loaded and "portbench" in loaded
    assert not loaded & set(harness.FORBIDDEN_MODULES)


def test_the_check_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_extra", object())
    assert "repro" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.core", object())
    assert "repro" in harness.forbidden_modules()


@pytest.mark.parametrize("path", sorted((ROOT / "portbench").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_benchmark_file_imports_jax_or_the_jax_package(path):
    for node in ast.walk(ast.parse(path.read_text())):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        assert not {n.split(".")[0] for n in names} & set(harness.FORBIDDEN_MODULES), names


def test_the_command_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                           "qwen3_8b.prefill_long", "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "CUDA" in proc.stderr


def test_the_command_fails_with_only_the_benchmark(tmp_path):
    """A checkout that holds BENCHMARK.json and the benchmark's files but
    not the program prints no result."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                           "qwen3_8b.prefill_chat", "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout == ""


def _limits(workload: str) -> dict:
    return json.loads((ROOT / "portbench" / "limits" / f"{workload}.json").read_text())


CONTROL_SIZES = {"n_layers": 4, "d_model": 512, "num_heads": 8, "num_kv_heads": 2,
                 "head_dim": 64, "d_ff": 1536, "vocab_size": 8192}


# The MoE at 8 layers and the cell's 8 experts: at 4 layers of 4 experts
# the control's error is too small to stand for the cell's, and its
# re-routes fall within the reference's paths.
MOE_SIZES = {"n_layers": 8, "num_experts": 8}


@pytest.mark.parametrize("name,workload", [("tiny_qwen3", "qwen3_8b.prefill_long"),
                                           ("tiny_qwen3", "qwen3_8b.prefill_chat"),
                                           ("tiny_mixtral", "mixtral_8x7b.prefill_long")])
def test_the_control_fails_the_cells_limits(name, workload):
    """At a size a test can hold (4 layers, 512 wide; the MoE 8 layers of
    8 experts), the program in bf16 passes each cell's limits and the
    control (the reference with every weight product in float8 e4m3)
    fails them, on three seeds."""
    doc = tiny_config(name, "bfloat16")
    sizes = dict(CONTROL_SIZES, **(MOE_SIZES if name == "tiny_mixtral" else {}))
    doc["model"].update(sizes)
    doc["port"]["replace"].update(sizes)
    cfg = harness.port_config(doc)
    family = harness.load_module(harness.PKG / "reference" / f"{doc['family']}.py")
    limits = _limits(workload)
    for seed in (1, 2, 3):
        weights = harness.draw_weights(family.param_specs(doc["model"]), seed, "cpu", torch.bfloat16)
        tokens = torch.randint(0, CONTROL_SIZES["vocab_size"], (4, 256), dtype=torch.int32,
                               generator=torch.Generator().manual_seed(seed))
        program = harness.forward(cfg, harness.load_program(cfg, weights), tokens).float()
        if "route_margin" in limits:
            ref = family.last_logit_candidates(doc["model"], weights, tokens,
                                               limits["route_margin"]["value"])
        else:
            ref = family.last_logits(doc["model"], weights, tokens)
        control = family.last_logits(doc["model"], weights, tokens, mm=_plain.fp8_mm)
        assert check.judge(check.numbers(program, ref), limits)[0]
        assert not check.judge(check.numbers(control, ref), limits)[0]


def _event(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_the_trace_reader_leaves_out_the_warm_up_and_steps_that_lost_records():
    events = []
    for i in range(4):  # steps of 100 us, 10 us apart
        t = 1000.0 + 110 * i
        events += [_event("user_annotation", "portbench.step", t, 100),
                   _event("user_annotation", "portbench.forward", t + 5, 30),
                   _event("user_annotation", "portbench.sync", t + 35, 65),
                   _event("kernel", "gemm", t + 10, 40),
                   _event("kernel", "flash_attention_tc_kernel<128>", t + 50, 20)]
        if i != 2:  # step 2 lost a record
            events.append(_event("gpu_memcpy", "Memcpy DtoH", t + 80, 10))
    events.append(_event("gpu_memcpy", "Activity Buffer Request", 1500, 5))
    got = trace.parse({"traceEvents": events})
    assert len(got.steps) == 3 and got.full == [0, 2]  # steps 1 and 3 of 0-3
    assert got.busy_s == pytest.approx(2 * 70e-6)
    assert got.window_s == pytest.approx(110e-6 + 100e-6)
    ops = got.op_seconds()
    assert ops["flash_attention_tc_kernel<128>"] == (pytest.approx(40e-6), 2)
    gaps = dict(got.breakdown()["idle_gaps"])
    # cut at the spans' edges: a step's first 10 us idle are 5 under the
    # step and 5 under forward; the 10 us between steps are outside them
    assert gaps == {"portbench.step": pytest.approx(10e-6), "portbench.forward": pytest.approx(10e-6),
                    "portbench.sync": pytest.approx(40e-6), "portbench.loop": pytest.approx(10e-6)}
    assert sum(gaps.values()) == pytest.approx(got.window_s - got.busy_s)


def test_the_roofline_and_idle_readers_on_a_trace():
    from portbench import counts

    model = tiny_config("tiny_qwen3")["model"]
    events = []
    for i in range(3):
        t = 1000.0 + 200 * i
        events += [_event("user_annotation", "portbench.step", t, 200),
                   _event("user_annotation", "portbench.forward", t + 4, 100),
                   _event("kernel", "flash_attention_tc_kernel<128>", t + 10, 50),
                   _event("kernel", "gemm", t + 60, 90)]
    peaks = {"bf16_flops_per_s": 1e12, "hbm_bytes_per_s": 1e12}
    run = harness.Run(model, None, {"batch": 2, "prompt_len": 64}, True, peaks, 1.0, [], 1.0,
                      trace.parse({"traceEvents": events}))
    metrics = ROOT / "portbench" / "metrics"
    k7 = harness.load_module(metrics / "k7_roofline.prefill.py").read(run)
    assert k7 == pytest.approx(100 * counts.k7_bound_s(model, 2, 64, peaks) / 50e-6)
    idle = harness.load_module(metrics / "device_idle_pct.prefill.py").read(run)
    assert idle == pytest.approx(100 * 60 / 200)
    # idle under forward: 6 us before K7 starts; the 50 us after the gemm
    # are under the step's own span
    dispatch = harness.load_module(metrics / "dispatch_idle_ms.prefill.py").read(run)
    assert dispatch == pytest.approx(6e-3)


@pytest.mark.cuda
def test_a_cell_runs_correct_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    proc = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                           "qwen3_8b.prefill_chat", "--seed", "97", "--seconds", "3", "--trace", "1"],
                          cwd=ROOT, capture_output=True, text=True, timeout=600)
    result = _last_line(proc)
    assert result["correct"] is True, proc.stderr[-3000:]
    assert set(result["metrics"]) == {"dispatch_idle_ms.prefill", "step_mfu_pct.prefill",
                                      "k7_roofline.prefill", "device_idle_pct.prefill"}
    assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
