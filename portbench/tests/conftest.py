"""Small stand-ins of the cells for CPU tests: the same families and
traffic generator at widths a test can hold, in a temporary copy of the
benchmark whose files are found by name like the real ones."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
SRC = ROOT / "src"
if str(SRC) not in sys.path:
    sys.path.insert(0, str(SRC))  # the program under test

TINY_MODELS = {
    "tiny_qwen3": {
        "family": "qwen3", "arch": "qwen3_8b",
        "model": {"n_layers": 2, "d_model": 64, "num_heads": 4, "num_kv_heads": 2, "head_dim": 32,
                  "d_ff": 96, "vocab_size": 256, "qk_norm": True, "rope_theta": 1000000.0,
                  "window": None, "rms_eps": 1e-06},
    },
    "tiny_mixtral": {
        "family": "mixtral", "arch": "mixtral_8x7b",
        "model": {"n_layers": 2, "d_model": 64, "num_heads": 4, "num_kv_heads": 2, "head_dim": 32,
                  "d_ff": 96, "vocab_size": 256, "num_experts": 4, "top_k": 2,
                  "capacity_factor": 2.0, "rope_theta": 1000000.0, "window": None,
                  "rms_eps": 1e-06},
    },
}
PORT_KEYS = ("n_layers", "d_model", "num_heads", "num_kv_heads", "head_dim", "d_ff", "vocab_size",
             "qk_norm", "rope_theta", "window", "num_experts", "top_k", "capacity_factor")
TINY_TRAFFIC = {"name": "tiny_chat", "loop": "closed", "in_flight": 1, "batch": 2,
                "prompt_len": 64, "warmup_steps": 1, "check_steps": 2, "trace_steps": 2,
                "why": "test traffic"}


def tiny_config(name: str, dtype: str = "float32") -> dict:
    spec = TINY_MODELS[name]
    model = dict(spec["model"])
    return {"name": name, "source": "test", "family": spec["family"], "dtype": dtype,
            "port": {"arch": spec["arch"],
                     "replace": {k: v for k, v in model.items() if k in PORT_KEYS}},
            "model": model, "reduced": [], "assumed": {}, "deployment": "test"}


def spec_family(name: str) -> str:
    return TINY_MODELS[name]["family"]


def make_copy(tmp: Path, dtype: str = "float32", limit: float = 1e-4) -> Path:
    """A checkout holding BENCHMARK.json, the benchmark and the tiny cells
    ``tiny_qwen3.tiny_chat`` and ``tiny_mixtral.tiny_chat``."""
    root = tmp / "checkout"
    shutil.copytree(ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    pkg = root / "portbench"
    (pkg / "traffic" / "tiny_chat.json").write_text(json.dumps(TINY_TRAFFIC))
    for name in TINY_MODELS:
        (pkg / "configs" / f"{name}.json").write_text(json.dumps(tiny_config(name, dtype)))
        workload = f"{name}.tiny_chat"
        bench["workloads"].append({"name": workload, "config": name, "traffic": "tiny_chat",
                                   "chips": 1, "why": "test"})
        limits = {"compared": {"rel_l2_max": {"limit": limit}, "served_gap_max": {"limit": limit}}}
        if spec_family(name) == "mixtral":
            limits["route_margin"] = {"value": 1e-3}
        (pkg / "limits" / f"{workload}.json").write_text(json.dumps(limits))
    for group in ("end_to_end", "per_layer"):
        for metric in bench[group]:
            metric.pop("workloads", None)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root


RUNNER = """
import json, sys, time
import torch
from portbench import harness
args = json.loads(sys.argv[1])
program = harness.forward
if args.get("fault"):
    from portbench.tests import faults
    program = getattr(faults, args["fault"])
sys.exit(harness.execute(args["workload"], args["seed"], args["seconds"], args["trace"],
                         device=torch.device("cpu"), t0=time.perf_counter(), program=program))
"""


def run_in(root: Path, workload: str, seed: int = 7, seconds: float = 0.5, trace: bool = False,
           fault: str | None = None) -> subprocess.CompletedProcess:
    """One CPU run of ``workload`` in the checkout ``root`` (the look for
    a card skipped), in its own process."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(root), str(SRC)]))
    args = {"workload": workload, "seed": seed, "seconds": seconds, "trace": trace, "fault": fault}
    return subprocess.run([sys.executable, "-c", RUNNER, json.dumps(args)], cwd=root, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.fixture
def checkout(tmp_path):
    return make_copy(tmp_path)
