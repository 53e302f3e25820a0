"""The port's dry run (``launch.dryrun``) on the fake process group, in
subprocesses (no process group stays in the test process):

* ``run_cell`` on the reference test's mini cell (yi_6b reduced, bf16,
  ``ShapeSpec("t", "train", 64, 8)``, mesh (4, 2); ``MINI`` in
  ``tests/test_sharding_roofline.py``) runs to the end with the reference's
  record keys; its per-device argument bytes equal the reference's
  compiled ``argument_size_in_bytes`` for the same shardings, 371140 (the
  sum over the 40 input leaves of ``NamedSharding.shard_shape`` times the
  item size); it counts collectives.
* The depth extrapolation (sums over one and two stages, the peak over two
  and three) equals a full trace of a four-stage reduced arch, count for
  count, for each step kind.
* The CLI on a full-size cell (Qwen3-8B ``decode_32k`` on the 16x16 mesh of
  the default 512 fake ranks): status "ok", rank 0's placed argument bytes
  equal to the JAX package's (the sum of ``NamedSharding.shard_shape``
  times the item size over the cell's inputs, on an Auto-axis mesh of 512
  forced host devices in a subprocess), collectives counted, the record
  file written under the reference's name.
* The argument bytes ``chip_smoke.py`` holds its dry-run cells to
  (``DRYRUN_CELLS``) are the JAX package's.
"""

import importlib.util
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
REFERENCE_MINI_ARGUMENT_BYTES = 371140
# the record keys of the reference's run_cell on a compiled cell
REFERENCE_KEYS = {"arch", "shape", "mesh", "chips", "kind", "grad_compression", "remat", "tag",
                  "status", "compile_s", "memory", "cost", "cost_extrapolated", "collectives",
                  "roofline", "hlo_bytes"}
KINDS = ("train", "prefill", "decode")

SCRIPT = textwrap.dedent(
    """
    import dataclasses, json, sys
    import torch.distributed as dist
    from repro_torch.configs import registry
    from repro_torch.configs.registry import ShapeSpec, get_arch
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_mesh

    out_dir = sys.argv[1]
    out = {}
    # 1. the reference's mini cell through run_cell: its shape and mesh
    registry.SHAPES["t"] = ShapeSpec("t", "train", 64, 8)
    D.make_production_mesh = lambda multi_pod=False, device_type="cuda": make_mesh(
        (4, 2), ("data", "model"), device_type)
    reduced = get_arch("yi_6b").reduced()
    over = {f.name: getattr(reduced, f.name) for f in dataclasses.fields(reduced)
            if f.name not in ("name", "param_dtype", "compute_dtype")}
    out["mini"] = D.run_cell("yi_6b", "t", out_dir=out_dir, cfg_overrides=over)
    out["initialized_after_run_cell"] = dist.is_initialized()

    # 2. extrapolated against full depth, four stages
    cfg = dataclasses.replace(reduced.with_dtypes("bfloat16", "bfloat16"), n_layers=4)
    with D.fake_world(8):
        mesh = make_mesh((4, 2), ("data", "model"), device_type="cuda")
        for kind in ("train", "prefill", "decode"):
            shape = ShapeSpec("t", kind, 64, 8)
            counts, colls, traces = D.measure_cell(cfg, shape, mesh)
            full = D.trace_cell(cfg, shape, mesh)
            out[kind] = {"extrapolated": counts, "extrapolated_collectives": colls,
                         "traces": len(traces), "full": full.counts,
                         "full_collectives": full.collectives}
    print(json.dumps(out))
    """
)


# the per-device argument bytes of the JAX package's shardings for each
# (arch, shape, multi-pod) cell of argv[1]
JAX_ARGUMENT_BYTES = textwrap.dedent(
    """
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    import json, math, sys
    import numpy as np
    import jax
    from jax.sharding import Mesh
    from repro.configs.registry import SHAPES, get_arch
    from repro.launch import specs
    from repro.parallel import sharding as sh

    ORDER = {"train": ("state", "batch"), "prefill": ("params", "batch"),
             "decode": ("params", "cache", "batch")}

    def axes_at(tree, path):
        for p in path:
            tree = tree[p.key]
        return tree

    out = {}
    for arch, shape, pod in json.loads(sys.argv[1]):
        devices = np.asarray(jax.devices())
        mesh = (Mesh(devices.reshape(2, 16, 16), ("pod", "data", "model")) if pod
                else Mesh(devices[:256].reshape(16, 16), ("data", "model")))
        in_specs, in_axes = specs.input_specs(get_arch(arch).with_dtypes("bfloat16", "bfloat16"),
                                              SHAPES[shape])
        total = 0
        for k in ORDER[SHAPES[shape].kind]:
            for path, sds in jax.tree_util.tree_flatten_with_path(in_specs[k])[0]:
                ns = sh.sharding_for(axes_at(in_axes[k], path), sds.shape, mesh,
                                     sh.DEFAULT_PARAM_RULES)
                total += math.prod(ns.shard_shape(sds.shape)) * sds.dtype.itemsize
        out[f"{arch}/{shape}/{pod}"] = total
    print(json.dumps(out))
    """
)
CLI_CELL = ("qwen3_8b", "decode_32k", False)


def _chip_smoke_cells() -> dict:
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.DRYRUN_CELLS


@pytest.fixture(scope="module")
def jax_argument_bytes():
    cells = sorted(set(_chip_smoke_cells()) | {CLI_CELL})
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    ref = subprocess.run([sys.executable, "-c", JAX_ARGUMENT_BYTES, json.dumps(cells)],
                         capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert ref.returncode == 0, ref.stderr[-3000:]
    return json.loads(ref.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The script above and the CLI on a full-size cell, side by side."""
    tmp = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("REPRO_TORCH_DRYRUN_DEVICES", None)
    cli = subprocess.Popen([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "qwen3_8b",
                            "--shape", "decode_32k", "--out", str(tmp / "cli")],
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
                           cwd=ROOT)
    script = subprocess.run([sys.executable, "-c", SCRIPT, str(tmp / "mini")], capture_output=True,
                            text=True, env=dict(env, REPRO_TORCH_DRYRUN_DEVICES="8"), cwd=ROOT,
                            timeout=600)
    cli_out, cli_err = cli.communicate(timeout=600)
    assert script.returncode == 0, script.stderr[-3000:]
    assert cli.returncode == 0, cli_err[-3000:] + cli_out[-2000:]
    return json.loads(script.stdout.strip().splitlines()[-1]), tmp, cli_out


def test_mini_cell_runs_to_the_end_with_the_reference_keys(runs):
    rec = runs[0]["mini"]
    assert rec["status"] == "ok", rec.get("traceback")
    assert REFERENCE_KEYS <= set(rec)
    assert rec["chips"] == 8 and rec["kind"] == "train" and rec["grad_compression"] == "none"
    written = json.loads((runs[1] / "mini" / "yi_6b__t__16x16.json").read_text())
    assert written == rec


def test_mini_cell_argument_bytes_equal_the_reference_compile(runs):
    assert runs[0]["mini"]["memory"]["argument_size_in_bytes"] == REFERENCE_MINI_ARGUMENT_BYTES


def test_mini_cell_counts_collectives_and_memory(runs):
    rec = runs[0]["mini"]
    assert rec["collectives"]["total_count"] > 0
    mem = rec["memory"]
    # training donates the state, and AdamW writes parameters and moments in place
    assert 0 < mem["alias_size_in_bytes"] <= mem["argument_size_in_bytes"]
    assert mem["temp_size_in_bytes"] > 0 and mem["output_size_in_bytes"] > 0
    assert rec["roofline"]["flops_per_device"] > 0 and rec["roofline"]["chips"] == 8


def test_run_cell_leaves_no_process_group(runs):
    assert runs[0]["initialized_after_run_cell"] is False


@pytest.mark.parametrize("kind", KINDS)
def test_depth_extrapolation_equals_a_full_trace(runs, kind):
    got = runs[0][kind]
    assert got["traces"] == 3
    assert got["extrapolated"] == got["full"]
    full = got["full_collectives"]
    ext = got["extrapolated_collectives"]
    assert ext["count_by_op"] == full["count_by_op"]
    assert ext["bytes_by_op"] == full["bytes_by_op"]


def test_cli_traces_a_full_size_cell(runs, jax_argument_bytes):
    rec = json.loads((runs[1] / "cli" / "qwen3_8b__decode_32k__16x16.json").read_text())
    assert rec["status"] == "ok", rec.get("traceback")
    assert REFERENCE_KEYS <= set(rec) and rec["chips"] == 256
    # rank 0's placed blocks against the JAX package's shard shapes
    want = jax_argument_bytes["/".join(map(str, CLI_CELL))]
    assert rec["memory"]["argument_size_in_bytes"] == want
    assert rec["collectives"]["total_count"] > 0
    assert rec["traced_stages"] == [1, 2, 3]
    assert runs[2].startswith("OK   qwen3_8b")


def test_chip_smoke_dryrun_cells_hold_the_jax_argument_bytes(jax_argument_bytes):
    cells = _chip_smoke_cells()
    assert any(shape.startswith("train") for _, shape, _ in cells)
    for (arch, shape, pod), want in cells.items():
        assert want == jax_argument_bytes[f"{arch}/{shape}/{pod}"], (arch, shape, pod)
