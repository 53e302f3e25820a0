"""Every reduced arch's train, prefill and decode step traces under DTensor.

``python -m repro_torch.launch.dryrun --reduced-matrix``
(``launch.dryrun.reduced_matrix``) runs each of the ten reduced archs
(bf16, ``ShapeSpec("t", kind, 64, 8)``) for every step kind through
``trace_cell``, on meta DTensors over a (4, 2) ("data", "model") mesh,
typed "cuda", of an 8-rank fake process group, as the dry run does at full
size: the step running to its end is the test, since every op must then
have a DTensor sharding.  The 30 cells trace in one subprocess (about a
minute on the CPU; no process group stays in the test process), and each
(arch, kind) is a case of one test.

A three-dimensional fake mesh is left out: one reduced train cell on
(2, 2, 2) takes minutes on the CPU.  ``chip_smoke.py`` traces the same
matrix on the card machine's torch (phase 8 (e)).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.configs.registry import ARCH_IDS

ROOT = Path(__file__).resolve().parents[1]
KINDS = ("train", "prefill", "decode")


@pytest.fixture(scope="module")
def matrix():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--reduced-matrix"],
                          capture_output=True, text=True, env=env, cwd=ROOT, timeout=900)
    assert proc.stdout.strip(), proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_reduced_cell_traces_on_the_fake_mesh(matrix, arch, kind):
    cell = matrix[f"{arch}/{kind}"]
    assert cell["status"] == "ok", cell.get("traceback")
    assert cell["flops"] > 0
