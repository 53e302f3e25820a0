"""Parity copy of ``tests/test_profile_pipeline.py`` on the port's CPU path.

The port's batched pipeline runs with ``backend="torch"`` (the plain
PyTorch versions of kernels K2 and K3, on the CPU).  On the same numpy
operands it must give the integer counts of the JAX package's
``run_profile_batch`` (XLA rendering, and Pallas kernels in interpret mode)
and of the numpy oracle, and the same scheduler statistics.  Tolerance:
zero, everywhere.

It also holds the kernels' plain versions against the reference's Pallas
task and strip kernels element for element on stacked arrays built by the
port's own scheduler, and the full-width Table-I network against
``src/repro_torch/data/table1_reference.json``.  The CUDA kernels run only
on the card (``tests/test_torch_cuda.py`` and ``chip_smoke.py``).
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core.pipeline import ProfileJob as RefJob
from repro.core.pipeline import run_profile_batch as ref_run_profile_batch
from repro.runtime import faults as ref_faults
from repro.kernels.activity_profile.batch import _h_strips_xla
from repro.kernels.activity_profile.kernel import (
    activity_profile_pallas_tasks,
    stream_strips_toggles_pallas,
)
from repro_torch.core import pipeline
from repro_torch.core.pipeline import BatchStats, ProfileJob, run_profile_batch
from repro_torch.core.switching import (
    clear_profile_cache,
    profile_cache_info,
    profile_gemm,
    profile_gemms,
)
from repro_torch.core.workloads import (
    RESNET50_TABLE1,
    ConvLayer,
    conv_layer_job,
    profile_network,
)
from repro_torch.kernels.activity_profile import batch
from repro_torch.kernels.activity_profile import kernel as K
from repro_torch.kernels.activity_profile.ref import profile_gemm_toggles_ref
from repro_torch.runtime import faults
from repro_torch.runtime.resilience import ContractViolationError

STATS_FIELDS = ("jobs", "passes", "pass_reuse", "buckets", "tasks", "strips", "serial_fallbacks")


@pytest.fixture(autouse=True)
def _pin_faults():
    """These tests assert clean runs (no degrade, no skip, an empty failure
    report): shield them, and the reference runs beside them, from
    fault injection armed through the environment."""
    with faults.injected([]), ref_faults.injected([]):
        yield


@pytest.fixture(autouse=True)
def _few_threads():
    """The suite runs in several worker processes at once, and some tests of
    other files time their work against a deadline: keep the plain versions'
    full-size passes from taking every core."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _rand_gemm(m, k, n, lo=-32767, hi=32768, seed=0):
    rng = np.random.default_rng([m, k, n, seed])
    return rng.integers(lo, hi, size=(m, k)), rng.integers(lo, hi, size=(k, n))


def _counts(p):
    """Exact integer toggle totals back out of a profile (lossless: the
    activities are integer ratios held in float64 far below 2^53)."""
    return (
        round(p.a_h * p.h_transitions * p.b_h),
        round(p.a_v * p.v_transitions * p.b_v),
        p.h_transitions,
        p.v_transitions,
    )


def _stats(stats):
    return {key: getattr(stats, key) for key in STATS_FIELDS}


def _both(specs, ref_engine="xla", interpret=False):
    """The same jobs through the port (backend="torch") and the reference;
    returns ``(jobs, port profiles, port stats, reference profiles,
    reference stats)``."""
    jobs = [ProfileJob(**spec) for spec in specs]
    profiles, stats = run_profile_batch(jobs, backend="torch", use_cache=False)
    ref_profiles, ref_stats = ref_run_profile_batch(
        [RefJob(**spec) for spec in specs], use_cache=False, engine=ref_engine,
        interpret=interpret,
    )
    return jobs, profiles, stats, ref_profiles, ref_stats


# Ragged multi-job batch: mixed M/K/N, non-aligned shapes, several
# geometries and bus widths, negative operands — one pipeline call.
RAGGED = [
    # m, k, n, rows, cols, b_h, b_v
    (7, 5, 3, 16, 8, 16, 37),
    (33, 70, 10, 16, 8, 16, 37),
    (100, 37, 29, 16, 8, 8, 20),
    (64, 64, 48, 32, 32, 16, 37),
    (257, 40, 33, 16, 16, 37, 33),
    (300, 80, 70, 32, 32, 16, 64),
    (50, 24, 16, 8, 8, 8, 23),  # b_v <= 32: the reference's lo-plane fast path
]
REF_ENGINES = [("xla", False), ("pallas", True)]


def _ws_specs(cases, dataflow="WS"):
    return [
        dict(rows=r, cols=c, b_h=bh, b_v=bv, a=a, w=w, name=f"{m}x{k}x{n}", dataflow=dataflow)
        for (m, k, n, r, c, bh, bv) in cases
        for a, w in [_rand_gemm(m, k, n)]
    ]


@pytest.mark.parametrize("ref_engine,interpret", REF_ENGINES)
def test_batched_ragged_set_bit_exact(ref_engine, interpret):
    jobs, profiles, stats, ref_profiles, ref_stats = _both(
        _ws_specs(RAGGED), ref_engine, interpret
    )
    assert stats.jobs == len(jobs) and stats.serial_fallbacks == 0
    assert _stats(stats) == _stats(ref_stats)
    for job, p, r in zip(jobs, profiles, ref_profiles):
        oracle = profile_gemm_toggles_ref(job.a, job.w, job.rows, job.cols, job.b_h, job.b_v)
        assert _counts(p) == _counts(r) == oracle, job.name
        assert p.as_dict() == dataclasses.asdict(r), job.name
        s = profile_gemm(
            job.a, job.w, job.rows, job.cols, job.b_h, job.b_v,
            backend="torch", use_cache=False,
        )
        assert (p.a_h, p.a_v) == (s.a_h, s.a_v), job.name
        assert p.input_zero_fraction == s.input_zero_fraction
        assert p.input_elements == job.a.size


def test_batched_matches_serial_on_long_streams():
    """Multi-segment streams (m >> t_seg) exercise the seeded-window splits."""
    a, w = _rand_gemm(1025, 96, 64)
    (p,), _ = run_profile_batch(
        [ProfileJob(rows=32, cols=32, b_h=16, b_v=37, a=a, w=w)],
        backend="torch", use_cache=False,
    )
    s = profile_gemm(a, w, 32, 32, 16, 37, backend="torch", use_cache=False)
    assert _counts(p) == _counts(s) == profile_gemm_toggles_ref(a, w, 32, 32, 16, 37)


def test_geometry_sweep_shares_one_pass():
    """One GEMM profiled across several (rows, cols): the h-strip totals and
    the rows-dependent v pass are computed once and shared (cols only
    rescales ceil(N/cols)); profiles stay bit-exact vs per-GEMM calls."""
    a, w = _rand_gemm(50, 40, 20, lo=-500, hi=500)
    specs = [dict(rows=32, cols=c, b_h=16, b_v=37, a=a, w=w) for c in (32, 16, 8)]
    jobs, profiles, stats, ref_profiles, ref_stats = _both(specs)
    assert stats.passes == 1 and stats.pass_reuse == 2
    assert _stats(stats) == _stats(ref_stats)
    for c, p, r in zip((32, 16, 8), profiles, ref_profiles):
        s = profile_gemm(a, w, 32, c, 16, 37, backend="torch", use_cache=False)
        assert _counts(p) == _counts(s) == _counts(r)
    # different rows => new v pass required
    specs.append(dict(rows=16, cols=32, b_h=16, b_v=37, a=a, w=w))
    _, _, stats, _, ref_stats = _both(specs)
    assert stats.passes == 2 and stats.pass_reuse == 2
    assert _stats(stats) == _stats(ref_stats)


def test_shape_aliased_operands_do_not_share_a_pass():
    """Same bytes reshaped to different (M, K)/(K, N) are different streams:
    the pass key must include shapes, not just content digests."""
    rng = np.random.default_rng(3)
    buf_a = rng.integers(-50, 50, size=64)
    buf_w = rng.integers(-50, 50, size=64)
    specs = [
        dict(rows=8, cols=8, b_h=16, b_v=37, a=buf_a.reshape(8, 8), w=buf_w.reshape(8, 8)),
        dict(rows=8, cols=8, b_h=16, b_v=37, a=buf_a.reshape(4, 16), w=buf_w.reshape(16, 4)),
    ]
    jobs, profiles, stats, _, ref_stats = _both(specs)
    assert stats.passes == 2 and stats.pass_reuse == 0
    assert _stats(stats) == _stats(ref_stats)
    for job, p in zip(jobs, profiles):
        assert _counts(p) == profile_gemm_toggles_ref(job.a, job.w, 8, 8, 16, 37)


def test_intra_batch_dedup_and_cache_accounting():
    clear_profile_cache()
    a, w = _rand_gemm(32, 16, 8, lo=0, hi=100)
    jobs = [
        ProfileJob(rows=16, cols=8, b_h=16, b_v=37, a=a, w=w),
        # same content, different dtype/copy: must dedup to one device pass
        ProfileJob(rows=16, cols=8, b_h=16, b_v=37, a=a.astype(np.int32), w=w.copy()),
    ]
    profiles, stats = run_profile_batch(jobs, backend="torch")
    assert stats.passes == 1 and stats.pass_reuse == 1 and stats.cache_hits == 0
    assert _counts(profiles[0]) == _counts(profiles[1])
    # second batch: every job is a content-cache hit, nothing runs on device
    profiles2, stats2 = run_profile_batch(jobs, backend="torch")
    assert stats2.cache_hits == 2 and stats2.passes == 0 and stats2.buckets == 0
    assert profiles2[0] == profiles[0]
    # the cache is shared with the serial API: the batch stored its profile
    # under the engine it ran ("torch"), which profile_gemm(backend="torch")
    # looks up
    hits_before = profile_cache_info()["hits"]
    profile_gemm(a, w, 16, 8, 16, 37, backend="torch")
    assert profile_cache_info()["hits"] == hits_before + 1
    clear_profile_cache()


def test_serial_fallbacks_and_degenerate_shapes():
    """Jobs the batched engine cannot take go to the serial path, as on the
    reference.  Wide operands under ``backend="auto"`` resolve to the numpy
    oracle (with a warning) before any card is needed, so that part runs on
    the CPU too; the rest runs with ``backend="torch"``, where wide operands
    break the explicit engine's contract instead, as an explicit
    ``backend="pallas"`` does on the reference."""
    rng = np.random.default_rng(5)
    wide_a = rng.integers(-(2**30), 2**30, size=(16, 8))
    wide_w = rng.integers(-(2**30), 2**30, size=(8, 4))
    tiny_a, tiny_w = _rand_gemm(1, 4, 4)  # m < 2: zero transitions
    a, w = _rand_gemm(20, 8, 4, lo=0, hi=50)
    specs = [
        dict(rows=8, cols=8, b_h=16, b_v=37, a=wide_a, w=wide_w),
        dict(rows=8, cols=8, b_h=16, b_v=37, a=tiny_a, w=tiny_w),
        dict(rows=8, cols=4, b_h=16, b_v=37, a=a, w=w),
    ]
    with pytest.warns(RuntimeWarning):
        (p_wide,), stats_wide = run_profile_batch(
            [ProfileJob(**specs[0])], backend="auto", use_cache=False
        )
    (p_tiny, p_ok), stats = run_profile_batch(
        [ProfileJob(**spec) for spec in specs[1:]], backend="torch", use_cache=False
    )
    with pytest.warns(RuntimeWarning):
        ref_profiles, ref_stats = ref_run_profile_batch(
            [RefJob(**spec) for spec in specs], use_cache=False, engine="xla"
        )
    assert stats_wide.serial_fallbacks == 1 and stats_wide.passes == 0
    assert stats.serial_fallbacks == 1 and stats.passes == 1
    assert stats_wide.serial_fallbacks + stats.serial_fallbacks == ref_stats.serial_fallbacks
    assert stats.passes == ref_stats.passes
    assert p_wide == profile_gemm(wide_a, wide_w, 8, 8, 16, 37, backend="numpy", use_cache=False)
    assert p_tiny.h_transitions == 0 and p_tiny.a_v == 0.0
    assert _counts(p_ok) == profile_gemm_toggles_ref(a, w, 8, 4, 16, 37)
    for p, r in zip((p_wide, p_tiny, p_ok), ref_profiles):
        assert p.as_dict() == dataclasses.asdict(r)
    for mode in ("raise", "degrade", "skip"):
        with pytest.raises(ContractViolationError, match="int16-range"):
            run_profile_batch(
                [ProfileJob(**specs[0])], backend="torch", use_cache=False, on_error=mode
            )


def test_backend_numpy_runs_serial_oracle():
    a, w = _rand_gemm(12, 6, 5, lo=0, hi=50)
    jobs = [ProfileJob(rows=8, cols=8, b_h=16, b_v=37, a=a, w=w)]
    profiles, stats = run_profile_batch(jobs, backend="numpy", use_cache=False)
    assert stats.serial_fallbacks == 1 and stats.buckets == 0
    assert _counts(profiles[0]) == profile_gemm_toggles_ref(a, w, 8, 8, 16, 37)


@pytest.mark.parametrize("shape,geometry", [((300, 80, 70), (32, 32)), ((16, 128, 64), (8, 8))])
def test_device_sharding_bit_exact(monkeypatch, shape, geometry):
    """Simulated two-device host: task-axis shards stay bit-exact.  The
    second case has 128 tasks, so its bucket really is split in two."""
    calls = []
    real = batch.bucket_toggle_parts

    def spy(*args, **kw):
        calls.append((len(args[2]), kw["device"]))
        return real(*args, **kw)

    monkeypatch.setattr(pipeline, "_devices", lambda engine: [torch.device("cpu")] * 2)
    monkeypatch.setattr(batch, "bucket_toggle_parts", spy)
    a, w = _rand_gemm(*shape)
    rows, cols = geometry
    (p,), stats = run_profile_batch(
        [ProfileJob(rows=rows, cols=cols, b_h=16, b_v=37, a=a, w=w)],
        backend="torch", use_cache=False,
    )
    assert _counts(p) == profile_gemm_toggles_ref(a, w, rows, cols, 16, 37)
    assert len(calls) == (2 if stats.tasks >= 128 else 1)
    assert sum(n for n, _ in calls) >= stats.tasks


def test_lazy_jobs_and_shape_validation():
    a, w = _rand_gemm(10, 6, 4, lo=0, hi=50)
    job = ProfileJob(rows=8, cols=8, b_h=16, b_v=37, make=lambda: (a, w), shape=(10, 6, 4))
    (p,), _ = run_profile_batch([job], backend="torch", use_cache=False)
    assert _counts(p) == profile_gemm_toggles_ref(a, w, 8, 8, 16, 37)
    bad = ProfileJob(rows=8, cols=8, b_h=16, b_v=37, make=lambda: (a, w), shape=(11, 6, 4))
    with pytest.raises(ValueError, match="declared shape"):
        run_profile_batch([bad], backend="torch", use_cache=False)
    with pytest.raises(ValueError, match="needs shape"):
        ProfileJob(rows=8, cols=8, b_h=16, b_v=37, make=lambda: (a, w)).gemm_shape()


def test_profile_gemms_wrapper_and_order():
    jobs = []
    expect = []
    for m, k, n in [(9, 5, 4), (21, 17, 3), (6, 2, 2)]:
        a, w = _rand_gemm(m, k, n, lo=-200, hi=200)
        jobs.append(ProfileJob(rows=8, cols=8, b_h=16, b_v=37, a=a, w=w))
        expect.append(profile_gemm_toggles_ref(a, w, 8, 8, 16, 37))
    profiles = profile_gemms(jobs, backend="torch", use_cache=False)
    assert [_counts(p) for p in profiles] == expect


TINY_LAYERS = [
    ConvLayer("t1", k=1, h=5, w=5, c=40, m=9, input_density=0.5),
    ConvLayer("t2", k=3, h=3, w=3, c=7, m=17, input_density=0.4),
]


@pytest.mark.parametrize("dataflow", ["WS", "OS"])
def test_profile_network_matches_serial_layers(dataflow):
    import repro.core.workloads as ref_workloads

    clear_profile_cache()
    batched, stats = profile_network(
        TINY_LAYERS, rows=16, cols=8, bits=8, dataflow=dataflow, backend="torch",
        use_cache=False, return_stats=True,
    )
    ref_layers = [ref_workloads.ConvLayer(*dataclasses.astuple(layer)) for layer in TINY_LAYERS]
    ref_batched, ref_stats = ref_workloads.profile_network(
        ref_layers, rows=16, cols=8, bits=8, dataflow=dataflow, use_cache=False,
        return_stats=True,
    )
    assert isinstance(stats, BatchStats) and stats.jobs == 2
    assert _stats(stats) == _stats(ref_stats)
    assert [p.as_dict() for p in batched] == [dataclasses.asdict(r) for r in ref_batched]
    for i, layer in enumerate(TINY_LAYERS):
        job = conv_layer_job(layer, rows=16, cols=8, bits=8, seed=i, dataflow=dataflow)
        a, w = job.operands()
        if dataflow == "OS":
            assert job.b_v == 8  # OS default: operand width, not accumulator width
        assert _counts(batched[i]) == profile_gemm_toggles_ref(
            a, w, 16, 8, job.b_h, job.b_v, dataflow=dataflow
        )
    if dataflow == "WS":
        # subsampling falls back to the serial per-GEMM estimate
        sub, stats_sub = profile_network(
            TINY_LAYERS, rows=16, cols=8, bits=8, max_tiles=1, max_stream=8,
            backend="torch", use_cache=False, return_stats=True,
        )
        assert stats_sub.serial_fallbacks == 2
        assert all(0.0 <= p.a_v <= 1.0 for p in sub)


# ---------------------------------------------------------------------------
# Output-stationary jobs: stream buckets, geometry-free pass reuse
# ---------------------------------------------------------------------------

OS_RAGGED = [
    # m, k, n, rows, cols, b_h, b_v
    (7, 5, 3, 16, 8, 16, 16),
    (33, 70, 10, 16, 8, 16, 12),
    (100, 37, 29, 16, 8, 8, 8),
    (257, 40, 33, 16, 16, 37, 33),
    (12, 300, 16, 8, 8, 16, 16),  # long K: multi-segment stream windows
]


@pytest.mark.parametrize("ref_engine,interpret", REF_ENGINES)
def test_batched_os_ragged_set_bit_exact(ref_engine, interpret):
    jobs, profiles, stats, ref_profiles, ref_stats = _both(
        _ws_specs(OS_RAGGED, dataflow="OS"), ref_engine, interpret
    )
    assert stats.serial_fallbacks == 0 and stats.tasks == 0
    assert _stats(stats) == _stats(ref_stats)
    for job, p, r in zip(jobs, profiles, ref_profiles):
        oracle = profile_gemm_toggles_ref(
            job.a, job.w, job.rows, job.cols, job.b_h, job.b_v, dataflow="OS"
        )
        assert _counts(p) == _counts(r) == oracle, job.name
        assert p.as_dict() == dataclasses.asdict(r), job.name
        s = profile_gemm(
            job.a, job.w, job.rows, job.cols, job.b_h, job.b_v,
            dataflow="OS", backend="torch", use_cache=False,
        )
        assert (p.a_h, p.a_v) == (s.a_h, s.a_v), job.name


def test_mixed_ws_os_batch_bit_exact():
    a, w = _rand_gemm(50, 40, 20, lo=-500, hi=500)
    specs = [
        dict(rows=16, cols=8, b_h=16, b_v=37, a=a, w=w, dataflow="WS"),
        dict(rows=16, cols=8, b_h=16, b_v=16, a=a, w=w, dataflow="OS"),
    ]
    jobs, profiles, stats, ref_profiles, ref_stats = _both(specs)
    assert stats.serial_fallbacks == 0
    assert _stats(stats) == _stats(ref_stats)
    for job, p, r in zip(jobs, profiles, ref_profiles):
        assert _counts(p) == _counts(r) == profile_gemm_toggles_ref(
            a, w, job.rows, job.cols, job.b_h, job.b_v, dataflow=job.dataflow
        ), job.dataflow


def test_os_geometry_sweep_shares_stream_passes():
    """OS stream passes carry no geometry: one A pass + one W pass serve
    every (rows, cols) combination, bit-exact against per-GEMM calls."""
    a, w = _rand_gemm(50, 40, 20, lo=-500, hi=500)
    geoms = [(32, 32), (16, 8), (8, 4)]
    specs = [dict(rows=r, cols=c, b_h=16, b_v=16, a=a, w=w, dataflow="OS") for (r, c) in geoms]
    jobs, profiles, stats, _, ref_stats = _both(specs)
    assert stats.passes == 2 and stats.pass_reuse == 2 * (len(geoms) - 1)
    assert _stats(stats) == _stats(ref_stats)
    for (r, c), p in zip(geoms, profiles):
        assert _counts(p) == profile_gemm_toggles_ref(a, w, r, c, 16, 16, dataflow="OS")
    # different bus width => the affected stream re-profiles, the other reuses
    specs.append(dict(rows=32, cols=32, b_h=16, b_v=12, a=a, w=w, dataflow="OS"))
    _, _, stats2, _, ref_stats2 = _both(specs)
    assert stats2.passes == 3  # A@16 + W@16 + W@12
    assert _stats(stats2) == _stats(ref_stats2)


def test_os_degenerate_and_serial_fallbacks():
    rng = np.random.default_rng(6)
    tiny_a, tiny_w = _rand_gemm(4, 1, 4)  # K < 2: zero transitions
    wide_a = rng.integers(-(2**30), 2**30, size=(6, 8))
    wide_w = rng.integers(-(2**30), 2**30, size=(8, 4))
    a, w = _rand_gemm(10, 12, 6, lo=0, hi=50)
    with pytest.warns(RuntimeWarning):
        (p_wide,), stats_wide = run_profile_batch(
            [ProfileJob(rows=4, cols=4, b_h=16, b_v=16, a=wide_a, w=wide_w, dataflow="OS")],
            backend="auto", use_cache=False,
        )
    (p_tiny, p_ok), stats = run_profile_batch(
        [
            ProfileJob(rows=4, cols=4, b_h=16, b_v=16, a=tiny_a, w=tiny_w, dataflow="OS"),
            ProfileJob(rows=4, cols=4, b_h=16, b_v=16, a=a, w=w, dataflow="OS"),
        ],
        backend="torch", use_cache=False,
    )
    assert stats_wide.serial_fallbacks + stats.serial_fallbacks == 2
    assert p_tiny.h_transitions == 0 and p_tiny.a_v == 0.0
    assert _counts(p_wide) == profile_gemm_toggles_ref(wide_a, wide_w, 4, 4, 16, 16, dataflow="OS")
    assert _counts(p_ok) == profile_gemm_toggles_ref(a, w, 4, 4, 16, 16, dataflow="OS")


def test_os_cache_roundtrip_and_dataflow_isolation():
    clear_profile_cache()
    a, w = _rand_gemm(16, 12, 8, lo=0, hi=100)
    ws_job = ProfileJob(rows=8, cols=8, b_h=16, b_v=37, a=a, w=w)
    os_job = ProfileJob(rows=8, cols=8, b_h=16, b_v=37, a=a, w=w, dataflow="OS")
    profiles, stats = run_profile_batch([ws_job, os_job], backend="torch")
    assert stats.cache_hits == 0
    # same operands+geometry, different dataflow: distinct cache entries
    profiles2, stats2 = run_profile_batch([ws_job, os_job], backend="torch")
    assert stats2.cache_hits == 2 and stats2.passes == 0
    assert profiles2[0] == profiles[0] and profiles2[1] == profiles[1]
    assert profiles[0].a_v != profiles[1].a_v
    # the cache is shared with the serial API (same keys)
    hits = profile_cache_info()["hits"]
    profile_gemm(a, w, 8, 8, 16, 37, dataflow="OS", backend="torch")
    assert profile_cache_info()["hits"] == hits + 1
    clear_profile_cache()


# ---------------------------------------------------------------------------
# The kernels' plain versions against the reference's Pallas kernels
# ---------------------------------------------------------------------------


def _ws_bucket(cases, rows, cols, b_h, b_v):
    """Stacked (strips, w_tiles, strip_ids, w_ids, valid_r) of the bucket the
    port's scheduler builds for ``cases`` (all in one shape class), with one
    dummy task (valid_r = 0) appended."""
    bucket_map, buckets, pass_map, stats = {}, [], {}, BatchStats()
    for m, k, n in cases:
        a, w = _rand_gemm(m, k, n)
        job = ProfileJob(rows=rows, cols=cols, b_h=b_h, b_v=b_v, a=a, w=w)
        pipeline._schedule_job(job, a, w, 128, bucket_map, buckets, pass_map, stats)
    (b,) = buckets
    return (
        np.stack(b.strips),
        np.stack(b.w_tiles),
        np.asarray(b.strip_ids + [0], np.int32),
        np.asarray(b.w_ids + [0], np.int32),
        np.asarray(b.valid_r + [0], np.int32),
    )


# (rows, cols, b_h, b_v): b_v <= 32 is the reference's lo-plane fast path;
# K = 70 and 37 leave K-padding rows in the last k strip.
TASK_CASES = [(16, 8, 16, 20), (16, 8, 37, 37), (8, 16, 16, 64)]


@pytest.mark.parametrize("rows,cols,b_h,b_v", TASK_CASES)
def test_task_and_strip_plain_versions_match_reference_kernels(rows, cols, b_h, b_v):
    strips, w_tiles, ids, wids, vr = _ws_bucket(
        [(100, 70, 20), (80, 37, 9), (120, 16, 13)], rows, cols, b_h, b_v
    )
    assert vr[-1] == 0 and (vr[:-1] < rows).any()
    h, v, num_tasks = batch.bucket_toggle_parts(
        strips, w_tiles, ids, wids, vr, rows=rows, cols=cols, b_h=b_h, b_v=b_v, engine="torch"
    )
    assert h.device.type == "cpu" and h.dtype == torch.int64 and num_tasks == len(ids)
    want_v = np.asarray(
        activity_profile_pallas_tasks(
            strips, w_tiles, ids, wids, vr, rows=rows, cols=cols, b_v=b_v, interpret=True
        )
    ).astype(np.int64)
    want_h = np.asarray(
        stream_strips_toggles_pallas(strips, bits=b_h, interpret=True)
    ).astype(np.int64)
    assert v.tolist() == want_v.tolist()
    assert v[-1] == 0  # the dummy task counts nothing
    assert h.tolist() == want_h.tolist() == np.asarray(_h_strips_xla(strips, b_h=b_h)).tolist()
    # the plain version's chunking does not change the counts
    t = [torch.from_numpy(x) for x in (strips, w_tiles, ids, wids, vr)]
    assert K.ws_task_toggles_plain(*t, b_v, task_chunk=3).tolist() == want_v.tolist()


@pytest.mark.parametrize("bits", [8, 16, 37, 64])
def test_stream_strip_plain_version_matches_reference_kernel(bits):
    """OS stream strips (lane chunks of 64, seeded windows along K)."""
    a, _ = _rand_gemm(40, 300, 1)
    strips = np.stack(
        batch.segment_strips(np.ascontiguousarray(a.T), pipeline.OS_LANE_CHUNK, 64)
    )
    got = batch.stream_bucket_parts(strips, bits=bits, engine="torch")
    want = np.asarray(stream_strips_toggles_pallas(strips, bits=bits, interpret=True))
    assert got.tolist() == want.astype(np.int64).tolist()
    w = np.zeros((300, 1), np.int64)
    assert int(got.sum()) == profile_gemm_toggles_ref(a, w, 64, 64, bits, 16, dataflow="OS")[0]


def test_plain_versions_flag_bad_task_ids():
    strips, w_tiles, ids, wids, vr = (
        torch.from_numpy(x) for x in _ws_bucket([(20, 16, 8)], 8, 8, 16, 37)
    )
    bad = ids.clone()
    bad[0] = strips.shape[0]
    got = K.ws_task_toggles(strips, w_tiles, bad, wids, vr, 37)
    good = K.ws_task_toggles(strips, w_tiles, ids, wids, vr, 37)
    assert got[0] == -1 and got[1:].tolist() == good[1:].tolist()
    with pytest.raises(ContractViolationError, match="out of range"):
        batch.bucket_toggle_parts(
            *(x.numpy() for x in (strips, w_tiles, bad, wids, vr)),
            rows=8, cols=8, b_h=16, b_v=37, engine="torch",
        )


# ---------------------------------------------------------------------------
# The slice at full width
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dataflow", ["WS", "OS"])
def test_table1_network_matches_reference_file(dataflow):
    """The batched main path at full size on the CPU rung: every profile
    equals the JAX package's, field for field, and the scheduler did what
    the reference's did."""
    import json

    from _torch_reference import REFERENCE_PATH

    ref = json.loads(REFERENCE_PATH.read_text())
    profiles, stats = profile_network(
        RESNET50_TABLE1, dataflow=dataflow, backend="torch", use_cache=False, return_stats=True
    )
    assert [p.as_dict() for p in profiles] == [layer[dataflow]["profile"] for layer in ref["layers"]]
    assert _stats(stats) == ref["batch_stats"][dataflow]
    assert stats.degraded == stats.skipped == 0 and not stats.failure_report


# ---------------------------------------------------------------------------
# Engines and contracts
# ---------------------------------------------------------------------------


def test_engine_and_backend_contracts(monkeypatch):
    a, w = _rand_gemm(20, 8, 4, lo=0, hi=50)
    job = ProfileJob(rows=8, cols=8, b_h=16, b_v=37, a=a, w=w)
    with pytest.raises(ContractViolationError, match="unknown backend"):
        run_profile_batch([job], backend="pallas", use_cache=False)
    strips = np.zeros((1, 9, 8), np.int32)
    w_tiles = np.zeros((1, 8, 8), np.int32)
    ids = np.zeros(1, np.int32)
    with pytest.raises(ContractViolationError, match="runs on cuda tensors"):
        batch.bucket_toggle_parts(
            strips, w_tiles, ids, ids, ids, rows=8, cols=8, b_h=16, b_v=37,
            engine="cuda", device=torch.device("cpu"),
        )
    with pytest.raises(ContractViolationError, match="runs on cpu tensors"):
        batch.stream_bucket_parts(strips, bits=16, engine="torch", device=torch.device("meta"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        batch.stream_bucket_parts(strips, bits=16)  # "auto" is the card
    with pytest.raises(RuntimeError, match="CUDA device"):
        run_profile_batch([job], backend="auto", use_cache=False)
    # the backend picks the engine; the profile is cached under the engine
    # that computed it
    clear_profile_cache()
    (p,), _ = run_profile_batch([job], backend="torch")
    assert _counts(p) == profile_gemm_toggles_ref(a, w, 8, 8, 16, 37)
    assert profile_gemm(a, w, 8, 8, 16, 37, backend="torch") is p
    clear_profile_cache()
