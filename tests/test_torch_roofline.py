"""The port's roofline and collective accounting against the JAX package's
(``tests/test_sharding_roofline.py``'s cases): the three terms, dominance
and fraction given the reference's hardware numbers as ``hw``;
``model_flops_for`` for every dry-run cell; the HLO parser on the
reference's sample; and the port's own counter, ``TraceCounter``, on a
fake 8-rank mesh in a subprocess (no process group stays in the test
process)."""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
from test_sharding_roofline import HLO_SAMPLE

from repro.analysis import hlo as RH
from repro.analysis import roofline as RR
from repro.configs.registry import SHAPES as R_SHAPES
from repro.configs.registry import get_arch as r_get_arch
from repro_torch.analysis import hlo as TH
from repro_torch.analysis import roofline as TR
from repro_torch.configs.registry import SHAPES, all_cells, get_arch

ROOT = Path(__file__).resolve().parents[1]

# the reference's hardware numbers, passed in: the port has no TPU default
REFERENCE_HW = TR.HardwareModel(name=RR.V5E.name, peak_flops=RR.V5E.peak_flops,
                                hbm_bw=RR.V5E.hbm_bw, ici_bw=RR.V5E.ici_bw)

# (flops, bytes, collective bytes, chips, model flops) per device: the
# reference test's case (memory-bound) and one bound by each other term
CASES = [
    (197e12, 819e9 * 2, 50e9 * 0.5, 256, 197e12 * 256 * 0.5),
    (197e12 * 3, 819e9, 50e9, 512, 197e12 * 512),
    (1e12, 1e9, 50e9 * 4, 256, 1e12 * 128),
    (0.0, 0.0, 0.0, 256, 0.0),
]


@pytest.mark.parametrize("case", CASES)
def test_roofline_equals_reference_with_its_hardware(case):
    want = RR.roofline(*case)
    got = TR.roofline(*case, hw=REFERENCE_HW)
    assert got.as_dict() == pytest.approx(want.as_dict(), rel=1e-12)
    assert got.dominant == want.dominant


def test_roofline_default_is_one_h100():
    r = TR.roofline(989e12, 3.35e12 * 2, 50e9 * 0.5, 256, 989e12 * 256 * 0.5)
    assert (r.t_compute, r.t_memory, r.t_collective) == pytest.approx((1.0, 2.0, 0.5))
    assert r.dominant == "memory" and r.roofline_fraction == pytest.approx(0.25)
    assert TR.H100 == TR.HardwareModel() and TR.H100.name == "h100_sxm"


def test_roofline_fraction_takes_the_terms_own_peak():
    """The reference divides useful FLOPs by its TPU peak whatever ``hw``
    says; the port by the peak its terms were made with."""
    hw = TR.HardwareModel(peak_flops=1e12, hbm_bw=1e12, ici_bw=1e12)
    r = TR.roofline(1e12, 0.0, 0.0, 4, 2e12, hw=hw)
    assert r.roofline_fraction == pytest.approx(0.5)


@pytest.mark.parametrize("cell", all_cells(), ids="/".join)
def test_model_flops_equal_reference_for_every_cell(cell):
    arch, shape = cell
    assert TR.model_flops_for(get_arch(arch), SHAPES[shape]) == RR.model_flops_for(
        r_get_arch(arch), R_SHAPES[shape])


def test_every_cell_is_counted():
    assert len(all_cells()) == 33


def test_collective_stats_parses_the_reference_sample():
    got, want = TH.collective_stats(HLO_SAMPLE), RH.collective_stats(HLO_SAMPLE)
    assert got.as_dict() == want.as_dict()
    assert got.count_by_op == {op: 1 for op in TH.COLLECTIVE_OPS}
    assert TH.COLLECTIVE_OPS == RH.COLLECTIVE_OPS


def test_torch_collectives_map_onto_the_reference_names():
    assert set(TH.TORCH_COLLECTIVES.values()) == set(TH.COLLECTIVE_OPS)


# One of each collective DTensor makes, and a sharded matmul, on a fake
# (4, 2) mesh: the counter must see local result bytes and local FLOPs.
COUNTER = textwrap.dedent(
    """
    import json
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.analysis.hlo import TraceCounter
    from repro_torch.launch.dryrun import fake_world
    from repro_torch.launch.mesh import make_mesh

    out = {}
    with fake_world(8):
        mesh = make_mesh((4, 2), ("data", "model"), device_type="cuda")

        def dt(shape, placements):
            return DTensor.from_local(torch.empty(shape, device="meta"), mesh, placements,
                                      run_check=False)

        cases = {
            "all-gather": (dt((4, 6), [Shard(0), Replicate()]), [Replicate(), Replicate()]),
            "all-reduce": (dt((16, 6), [Partial(), Replicate()]), [Replicate(), Replicate()]),
            "reduce-scatter": (dt((16, 6), [Partial(), Replicate()]), [Shard(0), Replicate()]),
            "all-to-all": (dt((4, 24), [Shard(0), Replicate()]), [Shard(1), Replicate()]),
        }
        for name, (x, to) in cases.items():
            with TraceCounter() as c:
                y = x.redistribute(mesh, to)
            out[name] = {"stats": c.collectives.as_dict(),
                         "local": list(y.to_local().shape)}
        a = dt((8, 64), [Shard(0), Replicate()])  # (32, 64) rows over data
        b = dt((64, 16), [Replicate(), Shard(1)])  # (64, 32) columns over model
        with TraceCounter() as c, FlopCounterMode(display=False) as g:
            y = a @ b
        out["mm"] = {"local": c.flops, "global": g.get_total_flops(),
                     "collectives": c.collectives.total_count}
    out["initialized_after"] = dist.is_initialized()
    print(json.dumps(out))
    """
)


@pytest.fixture(scope="module")
def counted():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    run = subprocess.run([sys.executable, "-c", COUNTER], capture_output=True, text=True, env=env,
                         cwd=ROOT, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    return json.loads(run.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("op, local_shape", [
    ("all-gather", [16, 6]),  # the gathered result on each rank
    ("all-reduce", [16, 6]),
    ("reduce-scatter", [4, 6]),
    ("all-to-all", [16, 6]),
])
def test_trace_counter_counts_one_collective(counted, op, local_shape):
    got = counted[op]
    assert got["local"] == local_shape
    assert got["stats"]["count_by_op"] == {op: 1}
    # f32 result bytes of the local result
    assert got["stats"]["bytes_by_op"] == {op: local_shape[0] * local_shape[1] * 4}


def test_trace_counter_counts_local_flops(counted):
    """A matmul sharded 8 ways (rows over 'data', columns over 'model')
    counts 1/8 of its FLOPs on a rank; FlopCounterMode, above DTensor,
    counts the global op."""
    assert counted["mm"]["global"] == 2 * 32 * 64 * 32
    assert counted["mm"]["local"] == 2 * 32 * 64 * 32 // 8
    assert counted["mm"]["collectives"] == 0


def test_fake_world_is_torn_down(counted):
    assert counted["initialized_after"] is False
