"""The CUDA kernels on the card: each against its plain PyTorch version and
the numpy oracle, and ``backend="auto"`` resolving to them, per GEMM (K1,
K4, whose wrapper launches K5's kernel) and through the batched pipeline
(K2, K3); and the kernel library's entry points (K5 stream toggles, K6
GEMM, K7 attention) against their plain versions.

Marked ``cuda``: every test skips, with its reason, where no CUDA device is
available.  On a machine with one:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core import pipeline
from repro_torch.core.pipeline import BatchStats, ProfileJob, run_profile_batch
from repro_torch.core.switching import profile_gemm
from repro_torch.kernels.activity_profile import kernel as K
from repro_torch.kernels.activity_profile.ops import profile_gemm_toggles
from repro_torch.kernels.activity_profile.ref import profile_gemm_toggles_ref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention import kernel as FA
from repro_torch.kernels.rms_norm import kernel as L4
from repro_torch.kernels.toggle_count import (
    stream_activity,
    stream_toggle_count,
    stream_toggle_count_i64,
)
from repro_torch.kernels.toggle_count import kernel as TC
from repro_torch.kernels.ws_matmul import kernel as WM
from repro_torch.kernels.ws_matmul import ws_matmul
from repro_torch.kernels.ws_matmul.ref import wrap_int32
from repro_torch.runtime import faults

pytestmark = pytest.mark.cuda

F32_MAX = float(torch.finfo(torch.float32).max)

CASES = [
    (7, 5, 3, 32, 32, 16, 37),
    (100, 37, 29, 16, 8, 8, 20),
    (33, 70, 10, 32, 32, 16, 64),
    (2, 1, 1, 8, 8, 16, 37),
    (257, 40, 33, 16, 16, 37, 33),
    (1025, 96, 64, 32, 32, 16, 37),
]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


def _operands(case):
    rng = np.random.default_rng(list(case))
    m, k, n = case[:3]
    return rng.integers(-32767, 32768, size=(m, k)), rng.integers(-32767, 32768, size=(k, n))


@pytest.mark.parametrize("case", CASES)
def test_ws_kernel_matches_plain_and_oracle(card, case):
    a, w = _operands(case)
    a_t = torch.from_numpy(a.astype(np.int32)).to(card)
    w_t = torch.from_numpy(w.astype(np.int32)).to(card)
    before = K.ws_activity_toggles.launches
    got = K.ws_activity_toggles(a_t, w_t, *case[3:])
    torch.cuda.synchronize()
    assert K.ws_activity_toggles.launches == before + (case[0] > 1)
    assert got.tolist() == K.ws_activity_toggles_plain(a_t, w_t, *case[3:]).tolist()
    assert tuple(got.tolist()) == profile_gemm_toggles_ref(a, w, *case[3:])[:2]


# K1 at its edges: M around one run of K.WS_KERNEL_STEPS (15) transitions;
# K below rows and not a multiple of it, and rows past one staged chunk of
# 32; N off the 32-column groups; b_v on every high-word packing (none, 6,
# 4, 2 and 1 fields to a popcount).
K1_EDGE_CASES = [
    (2, 40, 33, 32, 32, 16, 37),
    (14, 40, 33, 32, 32, 16, 37),
    (15, 40, 33, 32, 32, 16, 37),
    (16, 40, 33, 32, 32, 16, 37),
    (1025, 40, 33, 32, 32, 16, 37),
    (40, 20, 65, 32, 32, 16, 37),
    (40, 70, 100, 32, 16, 16, 37),
    (40, 100, 29, 48, 8, 16, 37),
    (40, 64, 64, 32, 32, 16, 20),
    (40, 64, 64, 32, 32, 16, 32),
    (40, 64, 64, 32, 32, 33, 33),
    (40, 64, 64, 32, 32, 16, 40),
    (40, 64, 64, 32, 32, 16, 45),
    (40, 64, 64, 32, 32, 64, 64),
]


@pytest.mark.parametrize("case", K1_EDGE_CASES)
def test_ws_kernel_edges_at_the_int16_extremes(card, case):
    """Half the operands at -32768, -32767 or 32767, so that 32-deep partial
    sums use all 37 bits; twice, so the uninitialised output is zeroed."""
    rng = np.random.default_rng(list(case))
    m, k, n = case[:3]
    extremes = np.array([-32768, -32767, 32767])

    def operand(shape):
        return np.where(rng.random(shape) < 0.5, rng.choice(extremes, shape),
                        rng.integers(-32768, 32768, size=shape))

    a, w = operand((m, k)), operand((k, n))
    a_t = torch.from_numpy(a.astype(np.int32)).to(card)
    w_t = torch.from_numpy(w.astype(np.int32)).to(card)
    want = list(profile_gemm_toggles_ref(a, w, *case[3:])[:2])
    for _ in range(2):
        got = K.ws_activity_toggles(a_t, w_t, *case[3:])
        torch.cuda.synchronize()
        assert got.tolist() == want
    assert K.ws_activity_toggles_plain(a_t, w_t, *case[3:]).tolist() == want


@pytest.mark.parametrize("case", CASES)
def test_os_kernel_matches_oracle(card, case):
    a, w = _operands(case)
    got = profile_gemm_toggles(a, w, *case[3:], dataflow="OS", engine="cuda")
    want = profile_gemm_toggles_ref(a, w, *case[3:], dataflow="OS")
    assert (got.h_toggles, got.v_toggles, got.h_transitions, got.v_transitions) == want


def test_auto_backend_runs_the_kernels(card):
    a, w = _operands((64, 64, 48))
    before = K.ws_activity_toggles.launches
    p = profile_gemm(a, w, 32, 32, 16, 37, backend="auto", use_cache=False)
    assert K.ws_activity_toggles.launches == before + 1
    # the same exact counts as the oracle; the same floats as the plain
    # versions (the oracle's float sum over tiles may differ in the last bit)
    assert p == profile_gemm(a, w, 32, 32, 16, 37, backend="torch", use_cache=False)
    n = profile_gemm(a, w, 32, 32, 16, 37, backend="numpy", use_cache=False)
    assert (p.h_transitions, p.v_transitions) == (n.h_transitions, n.v_transitions)
    assert round(p.a_v * p.v_transitions * 37) == round(n.a_v * n.v_transitions * 37)
    assert round(p.a_h * p.h_transitions * 16) == round(n.a_h * n.h_transitions * 16)


def _ws_bucket(cases, rows, cols, b_h, b_v):
    """Stacked arrays of the one bucket the port's scheduler builds for
    ``cases``, plus a dummy task (valid_r = 0) and a task with an
    out-of-range strip id."""
    bucket_map, buckets, pass_map, stats = {}, [], {}, BatchStats()
    for case in cases:
        a, w = _operands(case)
        job = ProfileJob(rows=rows, cols=cols, b_h=b_h, b_v=b_v, a=a, w=w)
        pipeline._schedule_job(job, a, w, 128, bucket_map, buckets, pass_map, stats)
    (b,) = buckets
    ids = b.strip_ids + [0, len(b.strips)]
    return (
        np.stack(b.strips),
        np.stack(b.w_tiles),
        np.asarray(ids, np.int32),
        np.asarray(b.w_ids + [0, 0], np.int32),
        np.asarray(b.valid_r + [0, rows], np.int32),
    )


@pytest.mark.parametrize("rows,cols,b_h,b_v", [(16, 8, 16, 20), (16, 8, 37, 37), (32, 40, 16, 64)])
def test_task_and_strip_kernels_match_plain(card, rows, cols, b_h, b_v):
    arrays = _ws_bucket([(100, 70, 20), (80, 37, 45), (120, 16, 13)], rows, cols, b_h, b_v)
    strips, w_tiles, ids, wids, vr = (torch.from_numpy(x).to(card) for x in arrays)
    before = (K.ws_task_toggles.launches, K.strip_toggles.launches)
    v = K.ws_task_toggles(strips, w_tiles, ids, wids, vr, b_v)
    h = K.strip_toggles(strips, b_h)
    torch.cuda.synchronize()
    assert (K.ws_task_toggles.launches, K.strip_toggles.launches) == (before[0] + 1, before[1] + 1)
    plain_v = K.ws_task_toggles_plain(strips, w_tiles, ids, wids, vr, b_v)
    assert v.tolist() == plain_v.tolist()
    assert v[-2] == 0 and v[-1] == -1  # dummy task, bad strip id
    assert h.tolist() == K.strip_toggles_plain(strips, b_h).tolist()


# K3 at the edges of K5's column walk: lanes 1, 3 and 5 (scalar lanes; not
# multiples of 4), 4, 8 and 32 (16-byte groups), t1 = 2, one strip and
# many, strips of several time chunks; then the same at a base offset of
# one element, where 16-byte rows start with scalar head lanes.
K3_EDGES = [(1, 2, 1), (1, 2, 3), (3, 2, 5), (1, 9, 3), (4, 17, 5), (2, 40, 4), (7, 129, 8),
            (1, 300, 5), (720, 129, 32), (33, 1000, 7)]


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("shape", K3_EDGES)
def test_strip_kernel_at_its_walk_edges(card, shape, offset):
    rng = np.random.default_rng(list(shape) + [offset])
    flat = rng.integers(-32768, 32768, size=int(np.prod(shape)) + offset).astype(np.int32)
    strips = torch.from_numpy(flat).to(card)[offset:].view(shape)
    assert strips.is_contiguous() and (strips.data_ptr() % 16 != 0) == (offset > 0)
    for bits in (1, 16, 33, 64):
        before = K.strip_toggles.launches
        got = [K.strip_toggles(strips, bits).tolist() for _ in range(2)]  # into torch.empty
        torch.cuda.synchronize()
        assert K.strip_toggles.launches == before + 2
        assert got[0] == got[1] == K.strip_toggles_plain(strips, bits).tolist()


# K2 at its edges: every run layout of the kernel (runs of 16 at t_seg 16,
# 32, 64 and 128; runs of 8 at t_seg 8 and 24; partial last runs at t_seg
# 1, 5 and 37), rows past one staged chunk of 32, cols off the 32-column
# groups, b_v on every high-word packing (none, 6, 2 and 1 fields to a
# popcount; 40 bits pack as 48 do).
K2_T_SEGS = [1, 5, 8, 16, 24, 32, 37, 64, 128]
K2_GEOMETRIES = [(rows, cols) for rows in (16, 32, 48) for cols in (8, 32, 40, 64)]
K2_BUS_WIDTHS = [20, 32, 33, 37, 40, 48, 64]


def _k2_edge_bucket(card, t_seg, rows, cols, tasks=40):
    """A bucket of ``tasks`` tasks over 7 strips and 5 tiles, operands half
    at the int16 extremes: task 0 has valid_r 0, task 1 the full rows, task
    2 half of them, the rest any; tasks 3 and 4 a bad strip and a bad tile
    id."""
    rng = np.random.default_rng([t_seg, rows, cols, tasks])
    extremes = np.array([-32768, -32767, 32767])

    def operand(shape):
        return np.where(rng.random(shape) < 0.5, rng.choice(extremes, shape),
                        rng.integers(-32768, 32768, size=shape))

    ids, wids = rng.integers(0, 7, tasks), rng.integers(0, 5, tasks)
    vr = rng.integers(0, rows + 1, tasks)
    vr[:3] = 0, rows, rows // 2
    ids[3], wids[4] = 7, -1
    arrays = (operand((7, t_seg + 1, rows)), operand((5, rows, cols)), ids, wids, vr)
    return tuple(torch.from_numpy(x.astype(np.int32)).to(card) for x in arrays)


def _check_k2(arrays, b_v):
    """K2 twice (its output is uninitialised: the C entry zeroes it) against
    its plain version: 0 for valid_r 0, -1 for exactly the bad ids."""
    before = K.ws_task_toggles.launches
    got = [K.ws_task_toggles(*arrays, b_v).tolist() for _ in range(2)]
    torch.cuda.synchronize()
    assert K.ws_task_toggles.launches == before + 2
    want = K.ws_task_toggles_plain(*arrays, b_v).tolist()
    assert got[0] == got[1] == want
    assert want[0] == 0 and want[3] == want[4] == -1
    assert min(want[:3] + want[5:]) >= 0 and want[1] > 0


@pytest.mark.parametrize("t_seg", K2_T_SEGS)
def test_task_kernel_time_runs(card, t_seg):
    _check_k2(_k2_edge_bucket(card, t_seg, 32, 32), 37)


@pytest.mark.parametrize("rows,cols", K2_GEOMETRIES)
def test_task_kernel_geometries(card, rows, cols):
    for t_seg in (8, 128):
        _check_k2(_k2_edge_bucket(card, t_seg, rows, cols), 37)


@pytest.mark.parametrize("b_v", K2_BUS_WIDTHS)
def test_task_kernel_bus_widths(card, b_v):
    for t_seg in (8, 24, 128):
        _check_k2(_k2_edge_bucket(card, t_seg, 32, 40), b_v)


def test_task_kernel_spans_many_blocks(card):
    """3000 tasks at t_seg 128 on 40 columns: 16 items (4 blocks) a task,
    their totals added with atomics."""
    _check_k2(_k2_edge_bucket(card, 128, 32, 40, tasks=3000), 37)


@pytest.mark.parametrize("lanes", [1, 3, 4097])
@pytest.mark.parametrize("bits", [1, 16, 33, 64])
def test_os_stream_kernel_runs_on_stream_toggles(card, lanes, bits):
    """K4 launches K5's kernel and counts on its own wrapper: at T = 2, and
    at T = 37 on a view whose base is not 16-byte aligned."""
    rng = np.random.default_rng([lanes, bits])
    for t, offset in ((2, 0), (37, 1)):
        flat = rng.integers(-(2**31), 2**31, size=t * lanes + offset).astype(np.int32)
        x = torch.from_numpy(flat).to(card)[offset:].view(t, lanes)
        assert x.is_contiguous() and (x.data_ptr() % 16 != 0) == (offset > 0)
        before = (K.operand_stream_toggles.launches, TC.stream_toggles.launches)
        got = K.operand_stream_toggles(x, bits)
        torch.cuda.synchronize()
        assert (K.operand_stream_toggles.launches, TC.stream_toggles.launches) == (
            before[0] + 1, before[1])
        assert got.tolist() == K.operand_stream_toggles_plain(x, bits).tolist()
        assert got.tolist() == TC.stream_toggles_plain(x, bits).tolist()


def test_batched_pipeline_on_the_card_matches_the_oracle():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    jobs = [
        ProfileJob(rows=r, cols=c, b_h=bh, b_v=bv, a=a, w=w, dataflow=df)
        for df in ("WS", "OS")
        for (m, k, n, r, c, bh, bv) in CASES
        for a, w in [_operands((m, k, n, r, c, bh, bv))]
    ]
    before = (K.ws_task_toggles.launches, K.strip_toggles.launches)
    profiles, stats = run_profile_batch(jobs, backend="auto", use_cache=False)
    assert K.ws_task_toggles.launches > before[0] and K.strip_toggles.launches > before[1]
    assert stats.degraded == stats.skipped == 0 and not stats.failure_report
    for job, p in zip(jobs, profiles):
        want = profile_gemm_toggles_ref(
            job.a, job.w, job.rows, job.cols, job.b_h, job.b_v, dataflow=job.dataflow
        )
        got = (
            round(p.a_h * p.h_transitions * p.b_h),
            round(p.a_v * p.v_transitions * p.b_v),
            p.h_transitions,
            p.v_transitions,
        )
        assert got == want, (job.dataflow, job.gemm_shape())


def test_degrade_recovers_on_the_card():
    """A failed batched pass degrades each job to the per-GEMM kernels on
    the card (K1 for WS, K4 for OS), bit-exact; nothing runs on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    jobs = [
        ProfileJob(rows=r, cols=c, b_h=bh, b_v=bv, a=a, w=w, dataflow=df)
        for df in ("WS", "OS")
        for (m, k, n, r, c, bh, bv) in CASES[:2]
        for a, w in [_operands((m, k, n, r, c, bh, bv))]
    ]
    before = (K.ws_activity_toggles.launches, K.operand_stream_toggles.launches)
    with faults.injected(
        [faults.FaultSpec("backend", match="bucket-dispatch"),
         faults.FaultSpec("backend", match="stream-dispatch")]
    ):
        profiles, stats = run_profile_batch(
            jobs, backend="auto", use_cache=False, on_error="degrade"
        )
    assert K.ws_activity_toggles.launches > before[0]
    assert K.operand_stream_toggles.launches > before[1]
    assert stats.degraded == len(jobs) and stats.skipped == 0
    assert stats.failure_report.actions() == {"degraded:cuda": len(jobs)}
    for job, p in zip(jobs, profiles):
        want = profile_gemm_toggles_ref(
            job.a, job.w, job.rows, job.cols, job.b_h, job.b_v, dataflow=job.dataflow
        )
        got = (
            round(p.a_h * p.h_transitions * p.b_h),
            round(p.a_v * p.v_transitions * p.b_v),
            p.h_transitions,
            p.v_transitions,
        )
        assert got == want, (job.dataflow, job.gemm_shape())


# ---------------------------------------------------------------------------
# the kernel library: K5 stream toggles, K6 GEMM, K7 attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(2, 1), (17, 3), (257, 129), (1000, 7), (300, 4097)])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_stream_toggles_match_plain(card, shape, dtype):
    rng = np.random.default_rng(list(shape))
    hi = 2**31 if dtype == torch.int32 else 2**62
    x = torch.from_numpy(rng.integers(-hi, hi, size=shape)).to(dtype).to(card)
    before = TC.stream_toggles.launches
    for bits in (8, 16, 32, 37, 48, 64):
        got = TC.stream_toggles(x, bits)
        torch.cuda.synchronize()
        assert got.tolist() == TC.stream_toggles_plain(x, bits).tolist(), bits
    assert TC.stream_toggles.launches == before + 6


def _stream(card, shape, dtype, seed, offset=0):
    """A seeded (T, L) stream on the card whose storage begins ``offset``
    elements into its allocation (a contiguous view, misaligned for
    ``offset`` > 0)."""
    rng = np.random.default_rng(seed)
    hi = 2**31 if dtype == torch.int32 else 2**62
    flat = torch.from_numpy(rng.integers(-hi, hi, size=shape[0] * shape[1] + offset))
    return flat.to(dtype).to(card)[offset:].view(shape)


def _check_stream(x, bits_list):
    before = TC.stream_toggles.launches
    for bits in bits_list:
        got = TC.stream_toggles(x, bits)
        torch.cuda.synchronize()
        assert got.tolist() == TC.stream_toggles_plain(x, bits).tolist(), (tuple(x.shape), bits)
    assert TC.stream_toggles.launches == before + len(bits_list)


@pytest.mark.parametrize("lanes", [1, 3, 5, 4096, 4097])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_stream_toggles_on_a_misaligned_base(card, lanes, dtype):
    """One element into its allocation: lanes 1, 3, 5 and 4097 take the
    scalar path, 4096 the scalar head, the 16-byte groups and the tail."""
    x = _stream(card, (37, lanes), dtype, [lanes, 1], offset=1)
    assert x.data_ptr() % 16 != 0
    _check_stream(x, (16, 37, 64))


@pytest.mark.parametrize("t_len", [2, 3])
@pytest.mark.parametrize("lanes", [1, 7, 1000, 4096])
def test_stream_toggles_two_and_three_steps(card, t_len, lanes):
    for dtype in (torch.int32, torch.int64):
        _check_stream(_stream(card, (t_len, lanes), dtype, [t_len, lanes]), (8, 37, 64))


@pytest.mark.parametrize("lanes", [128, 129])
def test_stream_toggles_int32_on_every_wide_bus(card, lanes):
    """An int32 stream on buses of 33-64 bits counts its sign copies."""
    _check_stream(_stream(card, (300, lanes), torch.int32, [lanes]), range(33, 65))


def test_stream_toggles_lanes_beyond_the_old_grid_stride(card):
    """600,000 int64 lanes, more than the 540,672 elements the earlier
    grid-stride design spanned at once."""
    _check_stream(_stream(card, (4, 600_000), torch.int64, 600), (37, 64))


def test_stream_toggles_output_is_zeroed_by_the_kernel(card):
    """The wrapper allocates its output uninitialised: a freed block that
    held junk, handed back by the caching allocator, must not add in."""
    x = _stream(card, (50, 300), torch.int64, 7)
    want = TC.stream_toggles_plain(x, 37).tolist()
    for _ in range(3):
        junk = torch.full((1,), -12345, dtype=torch.int64, device=card)
        del junk
        got = TC.stream_toggles(x, 37)
        torch.cuda.synchronize()
        assert got.tolist() == want


def test_toggle_count_entry_points_on_the_card(card):
    rng = np.random.default_rng(5)
    vals = rng.integers(-(2**40), 2**40, size=(64, 9))
    x = torch.from_numpy(vals).to(card)
    assert stream_toggle_count_i64(x) == stream_toggle_count_i64(vals, engine="torch")
    assert stream_toggle_count(vals) == stream_toggle_count(vals, engine="torch")
    assert stream_toggle_count(vals[:, 0]) == stream_toggle_count(vals[:, 0], engine="torch")
    for bits in (16, 37, 64):
        assert stream_activity(x, bits) == stream_activity(vals, bits, engine="torch")
    assert stream_toggle_count(vals[:1]) == 0


COUNTERS = {"tc": "tc_launches", "tf32": "tf32_launches"}


def _counts(fn, names=("launches", "tc_launches", "tf32_launches", "prep_launches")):
    return {name: getattr(fn, name) for name in names if hasattr(fn, name)}


@pytest.mark.parametrize(
    "m,k,n", [(1, 1, 1), (127, 129, 255), (200, 300, 170), (128, 128, 128), (3136, 256, 64)]
)
@pytest.mark.parametrize("dtype", [torch.int8, torch.int16])
def test_ws_gemm_int_matches_plain(card, m, k, n, dtype):
    rng = np.random.default_rng([m, k, n])
    info = torch.iinfo(dtype)
    a = torch.from_numpy(rng.integers(info.min, info.max + 1, size=(m, k))).to(dtype).to(card)
    w = torch.from_numpy(rng.integers(info.min, info.max + 1, size=(k, n))).to(dtype).to(card)
    before = _counts(WM.ws_gemm)
    got = WM.ws_gemm(a, w)
    torch.cuda.synchronize()
    after = _counts(WM.ws_gemm)
    assert after["launches"] == before["launches"] + 1
    assert after["tc_launches"] == before["tc_launches"] + 1  # integers take the tensor cores
    assert after["prep_launches"] == before["prep_launches"] + 1
    assert got.dtype == torch.int32
    assert torch.equal(got, WM.ws_gemm_plain(a, w))


def _bits(x):
    """The bits of a tensor, so that planes holding NaN compare too."""
    return x.view(torch.int32) if x.dtype == torch.float32 else x


@pytest.mark.parametrize("m,k,n", [(37, 70, 45), (1, 1, 1), (0, 70, 45), (5, 33, 0)])
@pytest.mark.parametrize("dtype", [torch.int8, torch.int16, torch.bfloat16, torch.float32])
def test_operand_planes_match_plain(card, dtype, m, k, n):
    rng = np.random.default_rng(7)
    if dtype.is_floating_point:  # with inf, NaN and values near f32's largest
        a, w = (torch.from_numpy(rng.normal(size=shape) * 2.0 ** rng.integers(-40, 40, size=shape))
                .float() for shape in ((m, k), (k, n)))
        if m and k:
            a[0, 0], a[-1, -1] = np.inf, np.nan
            a[m // 2, k // 2] = -F32_MAX
        a, w = a.to(dtype).to(card), w.to(dtype).to(card)
    else:
        info = torch.iinfo(dtype)
        a = torch.from_numpy(rng.integers(info.min, info.max + 1, size=(m, k))).to(dtype).to(card)
        w = torch.from_numpy(rng.integers(info.min, info.max + 1, size=(k, n))).to(dtype).to(card)
    got = WM.gemm_operand_planes(a, w)
    for g, p in zip(got, WM.gemm_operand_planes_plain(a, w)):
        assert g.dtype == p.dtype and torch.equal(_bits(g), _bits(p))


def test_ws_gemm_wraps_mod_2_32(card):
    a = torch.full((130, 260), 32767, dtype=torch.int16)
    a[::3] = -32767
    w = torch.full((260, 129), 32767, dtype=torch.int16)
    w[:, ::2] = -32767
    exact = a.long() @ w.long()
    assert exact.abs().max() > 2**31
    before = WM.ws_gemm.tc_launches
    got = WM.ws_gemm(a.to(card), w.to(card)).cpu()
    assert WM.ws_gemm.tc_launches == before + 1
    assert torch.equal(got, wrap_int32(exact))


@pytest.mark.parametrize(
    "route,dtype,m,k,n",
    [
        ("tf32", torch.float32, 130, 260, 140),
        ("tf32", torch.float32, 64, 512, 64),
        ("tf32", torch.float32, 1, 3, 300),
        # ragged f32: K in {1, 7, 33}, N in {1, 129}, M in {1, 130}
        ("tf32", torch.float32, 1, 1, 1),
        ("tf32", torch.float32, 130, 7, 129),
        ("tf32", torch.float32, 130, 33, 1),
        ("tf32", torch.float32, 1, 33, 129),
        ("tf32", torch.float32, 130, 1, 129),
        ("tf32", torch.float32, 300, 4100, 520),  # several K slices and N tiles
        ("tf32", torch.bfloat16, 130, 260, 140),  # K, N not multiples of 8: TF32 planes
        ("tf32", torch.bfloat16, 64, 500, 64),  # K % 8 != 0
        ("tf32", torch.bfloat16, 1, 3, 300),
        ("tf32", torch.bfloat16, 130, 7, 129),
        ("tc", torch.bfloat16, 64, 512, 64),
        ("tc", torch.bfloat16, 130, 264, 136),  # ragged M, N not a tile multiple
        ("tc", torch.bfloat16, 256, 512, 384),
        ("tc", torch.bfloat16, 1, 8, 8),
    ],
)
def test_ws_gemm_float_matches_plain(card, route, dtype, m, k, n):
    gen = torch.Generator().manual_seed(m * k + n)
    a = torch.randn(m, k, generator=gen).to(dtype).to(card)
    w = torch.randn(k, n, generator=gen).to(dtype).to(card)
    assert WM.gemm_route(dtype, m, k, n) == route
    before = getattr(WM.ws_gemm, COUNTERS[route])
    got = WM.ws_gemm(a, w)
    torch.cuda.synchronize()
    assert getattr(WM.ws_gemm, COUNTERS[route]) == before + 1
    plain = WM.ws_gemm_plain(a, w)
    scale = a.float().abs() @ w.float().abs()
    assert got.dtype == torch.float32
    assert ((got - plain).abs() <= 1e-5 * scale).all()


@pytest.mark.parametrize(
    "dtype,k,n,route",
    [
        (torch.int8, 129, 7, "tc"),
        (torch.int16, 64, 64, "tc"),
        (torch.bfloat16, 64, 64, "tc"),
        (torch.bfloat16, 60, 64, "tf32"),
        (torch.bfloat16, 64, 60, "tf32"),
        (torch.float32, 64, 64, "tf32"),
    ],
)
def test_ws_matmul_takes_the_route_of_its_type_and_shape(card, dtype, k, n, route):
    a = torch.ones((33, k), dtype=dtype, device=card)
    w = torch.ones((k, n), dtype=dtype, device=card)
    assert WM.gemm_route(dtype, 33, k, n) == route
    before = _counts(WM.ws_gemm)
    got = ws_matmul(a, w)
    torch.cuda.synchronize()
    after = _counts(WM.ws_gemm)
    assert after[COUNTERS[route]] == before[COUNTERS[route]] + 1
    assert after["launches"] == before["launches"] + 1
    assert bool((got == k).all())


def _gemm_on_its_route(a, w):
    """ws_gemm on the route of its type and shape, its counter checked, and
    its plain version."""
    route = WM.gemm_route(a.dtype, *a.shape, w.shape[1])
    before = _counts(WM.ws_gemm)
    got = WM.ws_gemm(a, w)
    torch.cuda.synchronize()
    after = _counts(WM.ws_gemm)
    assert after[COUNTERS[route]] == before[COUNTERS[route]] + 1
    assert after["launches"] == before["launches"] + 1
    return got, WM.ws_gemm_plain(a, w)


@pytest.mark.parametrize("dtype,m,k,n", [(torch.float32, 130, 33, 129), (torch.float32, 64, 64, 64),
                                         (torch.bfloat16, 64, 64, 64), (torch.bfloat16, 33, 70, 9)])
def test_ws_gemm_on_offset_views(card, dtype, m, k, n):
    """Operands that are views at an offset of one element, so their
    data_ptr is not 16-byte aligned."""
    gen = torch.Generator().manual_seed(m + k + n)
    flat_a = torch.randn(m * k + 1, generator=gen).to(dtype).to(card)
    flat_w = torch.randn(k * n + 1, generator=gen).to(dtype).to(card)
    a, w = flat_a[1:].view(m, k), flat_w[1:].view(k, n)
    assert a.data_ptr() % 16 and w.data_ptr() % 16
    got, plain = _gemm_on_its_route(a, w)
    assert ((got - plain).abs() <= 1e-5 * (a.float().abs() @ w.float().abs())).all()


def test_ws_gemm_f32_near_the_largest_value(card):
    """Operands near f32's largest value, whose TF32 big must not round to
    inf, against small ones: finite products within the tolerance."""
    rng = np.random.default_rng(3)
    a = torch.from_numpy(F32_MAX * rng.uniform(0.5, 1.0, size=(130, 40))).float()
    a[:, 0] = F32_MAX
    a[::2] *= -1
    w = torch.from_numpy(rng.normal(size=(40, 129)) * 2.0**-20).float()
    a, w = a.to(card), w.to(card)
    got, plain = _gemm_on_its_route(a, w)
    assert torch.isfinite(plain).all() and torch.isfinite(got).all()
    assert ((got - plain).abs() <= 1e-5 * (a.abs() @ w.abs())).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ws_gemm_non_finite_entries(card, dtype):
    """inf and NaN give what the f32 product gives: +-inf, NaN for inf * 0
    and inf - inf, NaN from NaN; the finite outputs within the tolerance."""
    rng = np.random.default_rng(4)
    a = torch.from_numpy(rng.normal(size=(70, 33))).float()
    w = torch.from_numpy(rng.normal(size=(33, 40))).float()
    w[:, :4] = torch.round(w[:, :4])  # values that TF32 holds exactly, and zeros
    a[3, 5], a[7, 0], a[9, 9] = np.inf, -np.inf, np.nan
    w[11, 6], w[2, 7] = np.inf, -np.inf
    a, w = a.to(dtype).to(card), w.to(dtype).to(card)
    got, plain = _gemm_on_its_route(a, w)
    assert torch.equal(got.isnan(), plain.isnan()) and plain.isnan().any()
    inf = plain.isinf()
    assert inf.any() and torch.equal(got.isinf(), inf) and torch.equal(got[inf], plain[inf])
    finite = torch.isfinite(plain)
    scale = (a.float().abs() @ w.float().abs())[finite]
    assert ((got[finite] - plain[finite]).abs() <= 1e-5 * scale).all()


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize(
    "b,h,kv,s,causal,window",
    [
        (1, 1, 1, 128, True, None),
        (2, 4, 2, 200, True, None),  # S not a multiple of the 64-row query tile
        (1, 2, 2, 300, True, 70),
        (1, 4, 1, 256, False, None),
        (1, 2, 2, 256, False, 64),
        (1, 2, 1, 96, True, 0),  # every row sees no key
    ],
)
def test_flash_attention_f32_matches_plain(card, d, b, h, kv, s, causal, window):
    gen = torch.Generator().manual_seed(s * d + h)
    q = torch.randn(b, h, s, d, generator=gen).to(card)
    k = torch.randn(b, kv, s, d, generator=gen).to(card)
    v = torch.randn(b, kv, s, d, generator=gen).to(card)
    before = _counts(FA.flash_attention_fwd)
    got = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    after = _counts(FA.flash_attention_fwd)
    assert after["launches"] == before["launches"] + 1
    assert after["tf32_launches"] == before["tf32_launches"] + 1
    assert after["prep_launches"] == before["prep_launches"] + 1
    plain = FA.flash_attention_fwd_plain(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(got, plain, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("b,kv,s,d", [(1, 1, 1, 32), (2, 3, 70, 64), (1, 2, 200, 128), (1, 1, 33, 32)])
def test_attention_operand_planes_match_plain(card, b, kv, s, d):
    """The prep kernel writes the plain version's planes bit for bit
    (compared as int32, so that NaN compares too), with inf, NaN, values
    near f32's largest and exponents across 2^-40..2^40."""
    rng = np.random.default_rng([b, kv, s, d])
    k, v = (torch.from_numpy(rng.normal(size=(b, kv, s, d)) * 2.0 ** rng.integers(-40, 40, size=(b, kv, s, d)))
            .float() for _ in range(2))
    for x in (k, v):
        x[0, 0, 0, 0], x[-1, -1, -1, -1] = np.inf, np.nan
        x[0, -1, s // 2, d // 2] = -F32_MAX
    k, v = k.to(card), v.to(card)
    before = FA.flash_attention_fwd.prep_launches
    got = FA.attention_operand_planes(k, v)
    torch.cuda.synchronize()
    assert FA.flash_attention_fwd.prep_launches == before + 1
    for g, p in zip(got, FA.attention_operand_planes_plain(k, v)):
        assert g.shape == p.shape and torch.equal(g.view(torch.int32), p.view(torch.int32))


def _one_hot_attention(card, d, v):
    """Queries that each see one key alone: S = D keys k_j = e_j, query i
    of head h 4000 e_j(i) with j(i) = (5 i + 3 + h) % S, so P is one-hot (the
    other logits lie 4000 / sqrt(D) below and exp2 gives 0) and O's row i is
    V's row j(i). Returns (kernel output, V's rows as the one-hot P picks
    them); non-causal, H = 4 over KV = 2."""
    s = d
    k = torch.eye(s, d).expand(1, 2, s, d).contiguous()
    picks = torch.tensor([[(5 * i + 3 + h) % s for i in range(s)] for h in range(4)])
    q = 4000.0 * torch.nn.functional.one_hot(picks, d).float()[None]
    before = FA.flash_attention_fwd.tf32_launches
    got = FA.flash_attention_fwd(q.to(card), k.to(card), v.to(card), causal=False)
    torch.cuda.synchronize()
    assert FA.flash_attention_fwd.tf32_launches == before + 1
    want = torch.stack([v[0, h // 2, picks[h]] for h in range(4)])[None]
    return got.cpu(), want


@pytest.mark.parametrize("d", [32, 64, 128])
def test_flash_attention_f32_one_hot_p_pins_the_fragment_layout(card, d):
    """P's A fragment comes from the S accumulator's registers with V^T's
    keys in KEY_ORDER; a wrong layout or order would pick another key's V."""
    v = torch.randn(1, 2, d, d, generator=torch.Generator().manual_seed(d))
    got, want = _one_hot_attention(card, d, v)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_flash_attention_f32_logits_in_the_tens(card):
    """q scaled up 10x (logits of standard deviation 10): the kernel's error
    against a float64 rendering is at most 4x the plain f32 version's."""
    gen = torch.Generator().manual_seed(10)
    q = 10.0 * torch.randn(1, 8, 300, 128, generator=gen)
    k, v = (torch.randn(1, 2, 300, 128, generator=gen) for _ in range(2))
    q, k, v = q.to(card), k.to(card), v.to(card)
    for window in (None, 100):
        got = FA.flash_attention_fwd(q, k, v, window=window)
        plain = FA.flash_attention_fwd_plain(q, k, v, window=window)
        exact = FA.flash_attention_fwd_plain(q.double(), k.double(), v.double(), window=window)
        kernel_err = (got.double() - exact).abs().max().item()
        plain_err = (plain.double() - exact).abs().max().item()
        assert 0 < kernel_err <= 4 * plain_err, (kernel_err, plain_err)


def test_flash_attention_f32_values_below_2_to_the_minus_120(card):
    """The planes' known limit, K6's too: V values within 2^2 of f32's
    smallest normal have a subnormal small plane, which keeps fewer bits
    (or none, where the tensor cores flush it), so the output misses the
    f32 tolerance relative to the values but stays within big's rounding,
    2^-11 of them."""
    rng = np.random.default_rng(12)
    v = torch.from_numpy(1.2e-38 * rng.uniform(1.0, 4.0, size=(1, 2, 64, 64))).float()
    got, want = _one_hot_attention(card, 64, v)
    rel = ((got.double() - want.double()).abs() / want.double())
    assert (rel > 1e-5).any() and (rel <= 2.0**-11).all()


@pytest.mark.parametrize("d", [32, 128])
def test_flash_attention_f32_on_offset_views(card, d):
    """Inputs that are views at an offset of one element, whose data_ptr is
    not 16-byte aligned (TMA and the prep's 16-byte loads need it)."""
    gen = torch.Generator().manual_seed(d + 1)
    q, k, v = (torch.randn(1 * h * 150 * d + 1, generator=gen).to(card)[1:].view(1, h, 150, d)
               for h in (4, 2, 2))
    assert q.data_ptr() % 16 and k.data_ptr() % 16 and v.data_ptr() % 16
    got = FA.flash_attention_fwd(q, k, v, window=60)
    torch.testing.assert_close(got, FA.flash_attention_fwd_plain(q, k, v, window=60),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize(
    "d,s,causal,window",
    [
        (64, 1000, True, None),
        (64, 1000, True, 300),
        (128, 1000, True, None),
        (128, 1000, True, 300),
        (32, 1000, True, None),
        (32, 200, True, 70),
        (128, 200, True, 0),  # every row sees no key
        (64, 256, False, None),
        (128, 256, False, 64),
    ],
)
def test_flash_attention_bf16_matches_plain(card, d, s, causal, window):
    gen = torch.Generator().manual_seed(d + s)
    q, k, v = (
        torch.randn(1, heads, s, d, generator=gen).to(torch.bfloat16).to(card)
        for heads in (8, 2, 2)
    )
    before = FA.flash_attention_fwd.tc_launches
    got = FA.flash_attention_fwd(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert FA.flash_attention_fwd.tc_launches == before + 1
    plain = FA.flash_attention_fwd_plain(q, k, v, causal=causal, window=window)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), plain.float(), rtol=1.6e-2, atol=1e-3)
    if window == 0:
        assert not got.any()


def test_flash_attention_bf16_takes_the_tensor_cores(card):
    q, k, v = (torch.ones(1, heads, 64, 64, dtype=torch.bfloat16, device=card) for heads in (4, 2, 2))
    before = _counts(FA.flash_attention_fwd)
    flash_attention(q, k, v)
    after = _counts(FA.flash_attention_fwd)
    assert after["tc_launches"] == before["tc_launches"] + 1
    assert after["tf32_launches"] == before["tf32_launches"]


# --- the design-space path: lane passes and float64 evaluators on the card -----

# The lane passes at their edges (as tests/test_torch_lanes.py EDGES): T = 2,
# K below rows, N off the column groups, b_v of 33-64, b_h past 32, at the
# int16 extremes; one case of several lane blocks (L1's first k strip).
LANE_EDGES = [
    (2, 5, 3, 8, 8, 16, 37, "WS"),
    (19, 5, 7, 8, 4, 16, 33, "WS"),
    (33, 70, 10, 16, 8, 16, 64, "WS"),
    (40, 17, 33, 16, 32, 40, 48, "WS"),
    (3136, 32, 64, 32, 32, 16, 37, "WS"),
    (2, 3, 4, 8, 8, 16, 16, "OS"),
    (30, 25, 40, 8, 16, 33, 50, "OS"),
]


@pytest.mark.parametrize("case", LANE_EDGES, ids=lambda c: "-".join(map(str, c)))
def test_lane_passes_match_the_cpu_pass(card, case):
    from repro_torch.kernels.activity_profile.ops import profile_gemm_lane_toggles

    m, k, n, rows, cols, b_h, b_v, dataflow = case
    rng = np.random.default_rng(list(case[:7]))
    a = rng.choice([-32767, 32767, -1, 0, 1, 12345], size=(m, k))
    w = rng.choice([-32767, 32767, -1, 0, 1, -23456], size=(k, n))
    kw = dict(dataflow=dataflow)
    got = profile_gemm_lane_toggles(a, w, rows, cols, b_h, b_v, engine="cuda", **kw)
    assert got == profile_gemm_lane_toggles(a, w, rows, cols, b_h, b_v, engine="torch", **kw)
    assert got.totals() == profile_gemm_toggles(a, w, rows, cols, b_h, b_v, engine="cuda", **kw)


# L1 and L2 against their plain versions at their edges (chip_smoke.py's
# LANE_EDGE_CASES): L1 (M, K, N, rows, b_v) on every bus width class, M = 2
# and 3, K off rows and past a staged chunk, N = 1 and past one block's 128
# columns; L2 (T, L) past one block of 256 lanes, over many 15-step chunks
# and, at 10 M values, 30-step ones, on buses of 8, 16 and 33 bits.
L1_CASES = [(40, 70, 33, 32, 1), (40, 70, 33, 32, 16), (40, 70, 33, 32, 32),
            (40, 70, 33, 32, 33), (40, 70, 33, 32, 37), (40, 70, 33, 32, 64),
            (2, 40, 65, 32, 37), (3, 40, 65, 32, 37), (16, 45, 1, 32, 37),
            (17, 100, 130, 48, 37), (46, 20, 300, 16, 33), (3136, 256, 64, 32, 37)]
L2_CASES = [((2, 1), 8), ((3, 7), 16), ((37, 300), 33), ((482, 33), 16), ((1000, 257), 8),
            ((3136, 256), 16), ((2000, 5000), 33)]


@pytest.mark.parametrize("case", L1_CASES, ids=lambda c: "-".join(map(str, c)))
def test_ws_lane_kernel_matches_plain(card, case):
    m, k, n, rows, b_v = case
    rng = np.random.default_rng(list(case))
    a = torch.from_numpy(rng.choice([-32767, 32767, -1, 0, 1, 12345], size=(m, k)).astype(np.int32))
    w = torch.from_numpy(rng.choice([-32767, 32767, -1, 0, 1, -23456], size=(k, n)).astype(np.int32))
    a, w = a.to(card), w.to(card)
    before = K.ws_lane_toggles.launches
    got = K.ws_lane_toggles(a, w, rows, b_v)
    torch.cuda.synchronize()
    assert K.ws_lane_toggles.launches == before + 1
    assert got.tolist() == K.ws_lane_toggles_plain(a, w, rows, b_v).tolist()
    assert sum(got.tolist()) == K.ws_activity_toggles(a, w, rows, rows, 16, b_v).tolist()[1]


@pytest.mark.parametrize("case", L2_CASES, ids=lambda c: f"{c[0][0]}x{c[0][1]}-{c[1]}")
def test_stream_lane_kernel_matches_plain(card, case):
    shape, bits = case
    rng = np.random.default_rng(list(shape) + [bits])
    x = torch.from_numpy(rng.integers(-32767, 32768, size=shape).astype(np.int32)).to(card)
    before = K.stream_lane_toggles.launches
    got = K.stream_lane_toggles(x, bits)
    torch.cuda.synchronize()
    assert K.stream_lane_toggles.launches == before + 1
    assert got.tolist() == K.stream_lane_toggles_plain(x, bits).tolist()
    assert sum(got.tolist()[:min(bits, 32)]) + (bits - 32) * got.tolist()[-1] * (bits > 32) == int(
        K.operand_stream_toggles(x, bits).item())


def _assert_engines_agree(got, want, fields):
    for name in fields:
        g, w = np.asarray(getattr(got, name), float), np.asarray(getattr(want, name), float)
        ok = np.isfinite(w)
        assert (np.isfinite(g) == ok).all(), name
        rtol = 1e-7 if name == "aspect_opt_gss" else 1e-10  # see test_torch_design_space.py
        np.testing.assert_allclose(g[ok], w[ok], rtol=rtol, atol=0, err_msg=name)


def test_design_space_evaluator_cuda_matches_numpy(card):
    import dataclasses

    from repro_torch.core.design_space import DesignSpace, evaluate_design_space, sweep_bus_power

    grid = DesignSpace(rows=(8, 32), cols=(8, 16, 128), input_bits=(8, 16), dataflows=("WS", "OS"),
                       bus_invert=(False, True)).expand()
    rng = np.random.default_rng(3)
    a_h = rng.uniform(0.0, 0.5, (3, grid.n_points))
    a_v = rng.uniform(0.0, 0.7, (3, grid.n_points))
    got = evaluate_design_space(grid, a_h, a_v, engine="cuda")
    want = evaluate_design_space(grid, a_h, a_v, engine="numpy")
    fields = [f.name for f in dataclasses.fields(got) if f.name not in ("grid", "sweep_report")]
    _assert_engines_agree(got, want, fields)
    assert np.array_equal(got.pareto(), want.pareto())
    aspects = np.geomspace(1 / 16, 16, 7)
    np.testing.assert_allclose(
        sweep_bus_power(grid, a_h[0], a_v[0], aspects, engine="cuda"),
        sweep_bus_power(grid, a_h[0], a_v[0], aspects, engine="numpy"), rtol=1e-10, atol=0,
    )


@pytest.mark.parametrize("variant", ["lanes", "bus_invert", "objective"])
def test_layout_evaluator_cuda_matches_numpy(card, variant):
    from repro_torch.core.design_space import DesignSpace
    from repro_torch.core.workloads import Gemm
    from repro_torch.layout import (
        LayoutPowerConfig,
        ObjectiveSpec,
        evaluate_layout_space,
        lower_partition_coeffs,
        pod_layouts,
    )

    grid = DesignSpace(rows=(8, 16, 32), cols=(16, 32, 64), input_bits=(8, 16), dataflows=("WS", "OS"),
                       bus_invert=(False, True) if variant == "bus_invert" else (False,)).expand()
    layouts = ("uniform", "serpentine2", "serpentine4") + pod_layouts((1, 2, 4))
    rng = np.random.default_rng(5)
    a_h = rng.uniform(0.05, 0.5, (2, grid.n_points))
    a_v = rng.uniform(0.05, 0.7, (2, grid.n_points))
    kw = dict(layouts=layouts, cfg=LayoutPowerConfig(max_envelope_aspect=6.0, preload_duty=0.1))
    if variant == "lanes":
        kw["h_lanes"] = rng.uniform(0.0, 0.5, (2, grid.n_points, 64))
        kw["v_lanes"] = rng.uniform(0.0, 0.8, (2, grid.n_points, 64))
    fields = ["aspect_opt", "bus_power_opt", "aspect_robust", "bus_power_robust", "overhead_w",
              "wirelength_um"]
    if variant == "objective":
        gemms = [Gemm("a", 64, 128, 64), Gemm("b", 50, 20, 30)]
        kw["objective"] = ObjectiveSpec(lower_partition_coeffs(grid, layouts, gemms),
                                        rng.uniform(1e-3, 5e-3, (2, grid.n_points)))
        fields += ["j_per_mac", "j_per_mac_robust"]
    got = evaluate_layout_space(grid, a_h, a_v, engine="cuda", **kw)
    want = evaluate_layout_space(grid, a_h, a_v, engine="numpy", **kw)
    _assert_engines_agree(got, want, fields)
    assert np.array_equal(got.best_layout, want.best_layout)


def _same_bits(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("kind", ["design", "layout", "objective"])
def test_sweep_on_the_card(card, kind, tmp_path):
    """The checkpointed sweep on the card: every chunk on the "cuda" rung;
    chunked equals unchunked bit for bit (the sums over the workload and
    class axes are folds, the same at every point); max_chunks interrupts
    and resume equals an uninterrupted run bit for bit; and a poisoned
    chunk walks to "numpy", is recorded, and agrees with numpy within
    1e-10."""
    from repro_torch.core.design_space import DesignSpace, evaluate_design_space
    from repro_torch.core.objective import evaluate_fleet_objective
    from repro_torch.core.sweep import SweepConfig, SweepInterrupted
    from repro_torch.core.workloads import Gemm
    from repro_torch.layout import evaluate_layout_space

    grid = DesignSpace(rows=(8, 16), cols=(8, 16, 32), input_bits=(8,), dataflows=("WS", "OS"),
                       bus_invert=(False, True) if kind != "layout" else (False,)).expand()
    rng = np.random.default_rng(0)
    a_h = rng.uniform(0.1, 0.4, (3, grid.n_points))
    a_v = rng.uniform(0.2, 0.6, (3, grid.n_points))
    layouts = ("uniform", "serpentine2", "pods2x2")
    if kind == "design":
        run = lambda **kw: evaluate_design_space(grid, a_h, a_v, **kw)
        fields = ("a_v_eff", "aspect_opt", "bus_power_opt", "bus_power_robust", "total_saving")
    elif kind == "layout":
        run = lambda **kw: evaluate_layout_space(grid, a_h, a_v, layouts=layouts, **kw)
        fields = ("aspect_opt", "bus_power_opt", "bus_power_robust", "overhead_w", "wirelength_um")
    else:
        gemms = [Gemm("a", 64, 128, 64), Gemm("b", 100, 20, 30), Gemm("c", 512, 512, 64)]
        run = lambda **kw: evaluate_fleet_objective(grid, a_h, a_v, gemms, layouts=layouts, **kw)
        fields = ("bus_power_robust", "overhead_w", "j_per_mac", "j_per_mac_robust")
    plain = run(engine="cuda")
    swept = run(engine="cuda", sweep=SweepConfig(chunk_size=7))
    chunks = -(-grid.n_points // 7)
    assert swept.sweep_report.rung_counts() == {"cuda": chunks}
    for f in fields:
        assert _same_bits(getattr(plain, f), getattr(swept, f)), f
    store = tmp_path / "chunks"
    with pytest.raises(SweepInterrupted):
        run(engine="cuda", sweep=SweepConfig(chunk_size=7, store=store, max_chunks=1))
    resumed = run(engine="cuda", sweep=SweepConfig(chunk_size=7, store=store))
    assert resumed.sweep_report.chunks_resumed == 1
    for f in fields:
        assert _same_bits(getattr(swept, f), getattr(resumed, f)), f
    with faults.injected([faults.FaultSpec("nan", match=f"cuda:{fields[-1]}|chunk1",
                                           max_fires=1)]):
        poisoned = run(engine="cuda", sweep=SweepConfig(chunk_size=7))
    rep = poisoned.sweep_report
    assert rep.rung_counts() == {"cuda": chunks - 1, "numpy": 1}
    assert rep.failures.actions() == {"degraded:numpy": 1}
    _assert_engines_agree(poisoned, run(engine="numpy"), fields)


def test_codesign_on_the_card(card):
    """Mixtral-8x7B under decode_heavy on the card (K2 and K3, then the
    objective in float64) against the JAX package's reference file."""
    import json
    from pathlib import Path

    from repro_torch.serving import codesign

    path = Path(__file__).resolve().parents[1] / "src/repro_torch/data/serving_reference.json"
    ref = json.loads(path.read_text())
    before = (K.ws_task_toggles.launches, K.strip_toggles.launches)
    res = codesign(ref["arch"], ref["traffic"], backend="auto", use_cache=False)
    assert K.ws_task_toggles.launches > before[0] and K.strip_toggles.launches > before[1]
    assert [[g.name, g.m, g.k, g.n] for g in res.jobset.gemms] == ref["jobset"]["gemms"]
    for f in ("j_per_mac", "j_per_mac_robust", "j_per_token_robust"):
        g, w = np.asarray(getattr(res.eval, f)), np.asarray(ref[f], float)
        ok = np.isfinite(w)
        assert (np.isfinite(g) == ok).all(), f
        np.testing.assert_allclose(g[ok], w[ok], rtol=1e-10, atol=0, err_msg=f)
    assert list(res.best_cell) == ref["best_cell"]
    assert {r: list(res.regime_cell(r)) for r in ("decode", "prefill")} == ref["regime_cells"]


# ---------------------------------------------------------------------------
# The model stack on the card
# ---------------------------------------------------------------------------

_MODEL_ARCHS = ("musicgen_medium", "jamba_v01_52b", "qwen2_vl_7b", "xlstm_1p3b", "granite_20b",
                "yi_6b", "qwen15_4b", "qwen3_8b", "llama4_maverick_400b", "mixtral_8x7b")
# Card against the reference file: the reference's decode-against-forward
# tolerance (tests/test_decode_consistency.py); K7 route against the torch
# route in float32 (TF32 three-product attention against f32 softmax).
_FILE_TOL = 2e-3
_ROUTE_TOL = 1e-4


def _models_case(arch, card):
    import json

    from _torch_reference import MODELS, MODELS_REFERENCE_PATH, models_case

    from repro_torch.configs.registry import get_arch
    from repro_torch.models import model as TM

    doc = json.loads(MODELS_REFERENCE_PATH.read_text())["archs"][arch]
    case = models_case(arch, get_arch(arch).reduced())
    assert case["tokens"].tolist() == doc["tokens"]
    params = TM.from_reference_params(case["cfg"], TM.seeded_numpy_params(case["cfg"], MODELS["seed"]),
                                      device=card)
    return case, doc, params


@pytest.mark.parametrize("arch", _MODEL_ARCHS)
def test_reduced_model_on_the_card_matches_reference_file(card, arch):
    """Forward (K7 f32 on the attention archs, one launch per attention
    layer) and stepwise decode at S = 12, and forward at S = 128, against
    the JAX package's logits in models_reference.json."""
    from _torch_reference import decode_f32

    from repro_torch.models import model as TM

    case, doc, params = _models_case(arch, card)
    cfg = case["cfg"]
    attn_layers = cfg.n_stages * sum(m == "attn" for m, _ in cfg.stage_pattern)
    toks = torch.from_numpy(case["tokens"]).to(card)
    before = FA.flash_attention_fwd.tf32_launches
    fwd, _ = TM.forward(cfg, params, toks, last_only=True)
    assert FA.flash_attention_fwd.tf32_launches == before + attn_layers
    np.testing.assert_allclose(fwd.cpu().numpy(), decode_f32(doc["forward"]), rtol=_FILE_TOL,
                               atol=_FILE_TOL)
    long_fwd, _ = TM.forward(cfg, params, torch.from_numpy(case["long_tokens"]).to(card),
                             last_only=True)
    np.testing.assert_allclose(long_fwd.cpu().numpy(), decode_f32(doc["long_forward"]),
                               rtol=_FILE_TOL, atol=_FILE_TOL)
    cache, _ = TM.init_cache(cfg, toks.shape[0], toks.shape[1], device=card)
    for t in range(toks.shape[1]):
        dec, cache = TM.decode_step(cfg, params, cache, toks[:, t:t + 1], t)
    np.testing.assert_allclose(dec.cpu().numpy(), decode_f32(doc["decode"]), rtol=_FILE_TOL,
                               atol=_FILE_TOL)


@pytest.mark.parametrize("arch", [a for a in _MODEL_ARCHS if a != "xlstm_1p3b"])
def test_model_kernel_route_matches_torch_route_on_the_card(card, arch):
    from _torch_reference import MODELS

    from repro_torch.models import model as TM

    case, _, params = _models_case(arch, card)
    cfg = case["cfg"]
    toks = torch.from_numpy(case["long_tokens"]).to(card)
    kernel, _ = TM.forward(cfg, params, toks, attention="kernel")
    before = FA.flash_attention_fwd.launches
    plain, _ = TM.forward(cfg, params, toks, attention="torch")
    assert FA.flash_attention_fwd.launches == before
    np.testing.assert_allclose(kernel.cpu().numpy(), plain.cpu().numpy(), rtol=_ROUTE_TOL,
                               atol=_ROUTE_TOL)
    assert MODELS["long_seq"] > cfg.attn_chunk  # the torch route ran blockwise


def test_bf16_model_takes_the_tensor_core_attention(card):
    """Qwen3-8B reduced in bf16: K7's "tc" kernel once per layer, within 3e-2
    relative L2 of the torch route (three times the bf16 rendering's own
    distance from float32 at depth 36, measured on the CPU)."""
    import dataclasses

    from repro_torch.configs.registry import get_arch
    from repro_torch.models import model as TM

    cfg = dataclasses.replace(get_arch("qwen3_8b").reduced(), n_layers=4).with_dtypes(
        "bfloat16", "bfloat16")
    gen = torch.Generator(device=card).manual_seed(0)
    params, _ = TM.init_params(cfg, gen)
    toks = torch.randint(0, cfg.vocab_size, (2, 256), generator=gen, device=card)
    before = FA.flash_attention_fwd.tc_launches
    kernel, _ = TM.forward(cfg, params, toks, last_only=True)
    assert FA.flash_attention_fwd.tc_launches == before + 4
    plain, _ = TM.forward(cfg, params, toks, last_only=True, attention="torch")
    rel = ((kernel.float() - plain.float()).norm() / plain.float().norm()).item()
    assert kernel.dtype == torch.bfloat16 and rel <= 3e-2, rel


def test_generate_on_the_card_matches_the_cpu(card):
    """Greedy tokens of a reduced arch on the card equal the CPU's."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.serve import generate
    from repro_torch.models import model as TM

    cfg = get_arch("yi_6b").reduced()
    tree = TM.seeded_numpy_params(cfg, 5)
    prompt = torch.from_numpy(np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 9)))
    on_cpu = generate(cfg, TM.from_reference_params(cfg, tree), prompt, 5)
    on_card = generate(cfg, TM.from_reference_params(cfg, tree, device=card), prompt.to(card), 5)
    assert torch.equal(on_card.cpu(), on_cpu)


# ---------------------------------------------------------------------------
# The training path on the card
# ---------------------------------------------------------------------------




@pytest.mark.parametrize("arch", ["jamba_v01_52b", "xlstm_1p3b", "qwen3_8b", "mixtral_8x7b"])
def test_reduced_training_on_the_card_matches_reference_file(card, arch):
    """Three AdamW steps at S = 32 in float32 on the file's token streams:
    each step's metrics against the JAX package's in train_reference.json
    (relative, _FILE_TOL), and no kernel of the port launched (the loss
    takes the torch route)."""
    import dataclasses
    import json

    from _torch_reference import TRAIN_METRICS, TRAIN_REFERENCE_PATH, stream_batch

    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import model as TM
    from repro_torch.optim import adamw

    ref = json.loads(TRAIN_REFERENCE_PATH.read_text())
    doc = ref["archs"][arch]
    cfg = dataclasses.replace(get_arch(arch).reduced(), capacity_factor=doc["capacity_factor"])
    params = TM.from_reference_params(cfg, TM.seeded_numpy_params(cfg, ref["seed"]),
                                      device=card).stage(None)
    state = {"params": params, "opt_state": adamw.init_state(adamw.AdamWConfig(), params)}
    step_fn = make_train_step(cfg, adamw.AdamWConfig())
    before = FA.flash_attention_fwd.launches
    for want, stream in zip(doc["steps"], doc["streams"]):
        batch = {k: torch.from_numpy(v).to(card) for k, v in stream_batch(stream).items()}
        state, metrics = step_fn(state, batch)
        for key in TRAIN_METRICS:
            assert metrics[key].item() == pytest.approx(want[key], rel=_FILE_TOL, abs=1e-9), key
    assert FA.flash_attention_fwd.launches == before


def test_training_resumes_bit_identically_on_the_card(card, tmp_path, monkeypatch):
    """launch.train.build on the card (its default device): a crash after
    step 5 and a restart end in the straight run's state, bit for bit,
    under deterministic algorithms."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.launch.train import build
    from repro_torch.optim.adamw import tree_leaves

    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    try:
        def run(sub, fail_at=None):
            coord = build("yi_6b", reduced=True, batch=2, seq=16, steps=8,
                          ckpt_dir=str(tmp_path / sub))
            assert coord.device.type == "cuda"
            try:
                coord.run(steps=8, fail_at_step=fail_at)
            except RuntimeError:
                assert fail_at is not None
            return coord

        straight = run("a")
        run("b", fail_at=5)
        run("b")
    finally:
        torch.use_deterministic_algorithms(False)
    like = straight.init_state_fn(device="meta")
    s1, st1, _ = CheckpointManager(tmp_path / "a").restore_latest(like)
    s2, st2, _ = CheckpointManager(tmp_path / "b").restore_latest(like)
    assert s1 == s2 == 8
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(st1), tree_leaves(st2)))


def test_loss_on_the_card_takes_the_torch_route(card):
    """CUDA tokens: the loss trains through the torch route whatever the
    device, and the kernel route raises with gradients."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import model as TM

    cfg = get_arch("qwen3_8b").reduced()
    params = TM.init_params(cfg, torch.Generator(device=card).manual_seed(0))[0].stage(None)
    toks = torch.randint(0, cfg.vocab_size, (2, 128), device=card)
    batch = {"tokens": toks, "labels": toks}
    before = FA.flash_attention_fwd.launches
    loss, _ = TM.loss_fn(cfg, params, batch)
    torch.autograd.grad(loss, params["head"])
    assert FA.flash_attention_fwd.launches == before
    with pytest.raises(ValueError, match="no backward"):
        TM.loss_fn(cfg, params, batch, attention="kernel")


# ---------------------------------------------------------------------------
# The mesh path: a one-rank NCCL DeviceMesh on the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["qwen3_8b", "mixtral_8x7b"])
def test_one_rank_mesh_forward_equals_unsharded_on_the_card(card, tmp_path, monkeypatch, arch):
    """A reduced arch's f32 forward on a 1x1 NCCL mesh (parameters placed by
    the rules, activations under activation_sharding) equals the unsharded
    forward bit for bit, with K7 launched through local_map once per
    attention layer; mixtral's MoE takes the sharded dispatch, against the
    unsharded capacity branch.  Both under
    deterministic algorithms (the MoE's scatter-add accumulates), and both
    on the torch route of the norms and RoPE, which the mesh takes (L4 sums
    its squares in another order)."""
    import torch.distributed as dist

    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as TM
    from repro_torch.parallel import sharding as sh

    from repro_torch.models import blocks, layers

    monkeypatch.setattr(layers, "norm_route", lambda *tensors, rotate=False: "torch")
    # the unsharded MoE on its capacity branch, which the sharded branch
    # reproduces; at 2 x 128 tokens it would take the compact path, which
    # packs other row blocks (held to this branch by the compact MoE tests)
    monkeypatch.setattr(blocks, "COMPACT_MIN_ROWS", 2**62)
    cfg = get_arch(arch).reduced()
    params, axes = TM.init_params(cfg, torch.Generator(device=card).manual_seed(0))
    tree = params.stage(None)
    toks = torch.randint(0, cfg.vocab_size, (2, 128), device=card, dtype=torch.int32,
                         generator=torch.Generator(device=card).manual_seed(1))
    attn_layers = cfg.n_stages * sum(m == "attn" for m, _ in cfg.stage_pattern)
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
                            world_size=1, device_id=card)
    try:
        want, _ = TM.forward(cfg, tree, toks, last_only=True)
        mesh = make_mesh((1, 1), ("data", "model"))
        placed = sh.place(tree, sh.tree_shardings(axes, tree, mesh))
        placed_toks = sh.place(toks, sh.sharding_for(("batch", "seq"), tuple(toks.shape), mesh))
        before = FA.flash_attention_fwd.tf32_launches
        with sh.activation_sharding(mesh):
            got, _ = TM.forward(cfg, placed, placed_toks, last_only=True)
        launched = FA.flash_attention_fwd.tf32_launches - before
        got = got.full_tensor()
    finally:
        dist.destroy_process_group()
        torch.use_deterministic_algorithms(False)
    assert launched == attn_layers
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# The MoE's compact path at Mixtral-8x7B's width
# ---------------------------------------------------------------------------

COMPACT_BF16_REL = 1e-3


@pytest.mark.parametrize("capacity_factor,idle", [(4.0, None), (1.25, 3)],
                         ids=["dropless", "drops-idle-expert"])
def test_compact_moe_matches_capacity_moe_on_the_card(card, monkeypatch, capacity_factor, idle):
    """One Mixtral-8x7B MoE layer (D 4096, F 14336, E 8, top-2, T 7680,
    bf16) on the compact path and on the capacity path: the same slots
    kept, the products on the kept rows alone, outputs within
    COMPACT_BF16_REL relative L2 (both bf16 products with float32 sums;
    the row blocks differ, so cuBLAS may sum in another order and round
    another bf16 h; an H100 read 0.0 and 3.0e-5.  The limit is a quarter
    of bf16's unit roundoff; a row on the wrong expert reads O(1)).  The
    second case drops slots (capacity factor 1.25) and routes no row to
    expert ``idle`` (its router logit is -10 times a row's sum, on
    positive inputs)."""
    import dataclasses

    from repro_torch import obs
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import blocks

    cfg = dataclasses.replace(get_arch("mixtral_8x7b"), capacity_factor=capacity_factor,
                              expert_shards=0)
    d, f, e, t = cfg.d_model, cfg.moe_d_ff or cfg.d_ff, cfg.num_experts, 7680
    assert (d, f, e, cfg.top_k) == (4096, 14336, 8, 2)
    gen = torch.Generator(device=card).manual_seed(7)

    def draw(*shape, scale):
        return (torch.randn(shape, generator=gen, device=card) * scale).to(torch.bfloat16)

    p = {"router": draw(d, e, scale=d ** -0.5), "w_gate": draw(e, d, f, scale=d ** -0.5),
         "w_up": draw(e, d, f, scale=d ** -0.5), "w_down": draw(e, f, d, scale=f ** -0.5)}
    x = draw(1, t, d, scale=1.0)
    if idle is not None:
        p["router"][:, idle] = -10.0
        x = x.abs()
        top = torch.topk((x.reshape(t, d) @ p["router"]).float(), cfg.top_k).indices
        assert not (top == idle).any()

    def run():
        with torch.inference_mode(), obs.tracing():
            out, aux = blocks.moe_apply(p, x, cfg)
            return out.float(), aux, obs.counters()

    got, aux, counters = run()
    monkeypatch.setattr(blocks, "COMPACT_MIN_ROWS", 2**62)
    want, want_aux, want_counters = run()
    kept = t * cfg.top_k - counters["moe.slots_dropped"]
    assert counters["moe.compact_layers"] == 1 and "moe.compact_layers" not in want_counters
    assert counters["moe.slots_dropped"] == want_counters["moe.slots_dropped"]
    assert counters["moe.expert_rows"] == kept
    if idle is None:
        assert kept == t * cfg.top_k
    else:
        assert 0 < kept < t * cfg.top_k
    assert aux.item() == want_aux.item()
    rel = ((got - want).norm() / want.norm()).item()
    print(f"compact against capacity, capacity factor {capacity_factor}: relative L2 {rel!r}")
    assert rel <= COMPACT_BF16_REL, rel



# ---------------------------------------------------------------------------
# L3: Mamba's selective scan, at Jamba-Mini's width
# ---------------------------------------------------------------------------

# Relative L2 over the whole (1, 7680, 8192) output.  float32: the roundings
# of up to S steps of the recurrence (exp2 within 2 ulp, the products'),
# about 1e-7 each, grow as sqrt(S) ~ 90 in the channels that keep their
# state; the chunked route sums the same terms in another order.  bf16
# against the float64 recurrence: one rounding of y to bf16 (at most 2^-9
# of each element) beside the float32 error.  bf16 against the chunked
# route: that route rounds three times more in bf16 (y before the gate,
# silu(z), their product).
SCAN_F32_REL = 2e-5
SCAN_BF16_REF_REL = 2.0 ** -9 + SCAN_F32_REL
SCAN_BF16_CHUNKED_REL = 4 * 2.0 ** -9


def _scan_operands(card, dtype, b=1, s=7680, di=8192, seed=11):
    """The reference's long-memory draws: log(delta |A|) spreads about 3.7
    around 0, so some (channel, state) pairs keep their state all along."""
    gen = torch.Generator(device=card).manual_seed(seed)

    def draw(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=card) * scale

    return (draw(b, s, di).to(dtype), draw(b, s, di).to(dtype), draw(b, s, di).to(dtype),
            draw(b, s, 16).to(dtype), draw(b, s, 16).to(dtype), -torch.exp(draw(di, 16, scale=2.0)),
            1 + 0.1 * draw(di), draw(di, scale=3.0))


def _rel_l2(got, want) -> float:
    return ((got.double() - want.double()).norm() / want.double().norm()).item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_selective_scan_at_jamba_width(card, dtype):
    """L3 at d_inner 8192, N 16, S 7680 against the float64 recurrence
    (``ref.py``), the chunked route of ``models/ssm.py`` and its plain
    version; one launch."""
    import dataclasses

    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels.selective_scan import kernel as SS
    from repro_torch.kernels.selective_scan.ref import selective_scan_ref
    from repro_torch.models import ssm

    ops = _scan_operands(card, dtype)
    before = SS.selective_scan_fwd.launches
    got = SS.selective_scan_fwd(*ops)
    assert SS.selective_scan_fwd.launches == before + 1
    assert got.dtype == dtype and got.shape == ops[0].shape
    want = selective_scan_ref(*ops)
    u, dt, z, b, c, a, d, bias = ops
    cfg = dataclasses.replace(get_arch("jamba_v01_52b"), mamba_inner_norms=True)
    chunked = ssm._chunked_scan({"A_log": torch.log(-a), "D": d, "dt_bias": bias}, u, z, dt, b, c,
                                cfg, cfg.scan_chunk)
    plain = SS.selective_scan_fwd_plain(*ops)
    assert SS.selective_scan_fwd.launches == before + 1
    rel_ref, rel_chunked, rel_plain = (_rel_l2(got, w) for w in (want, chunked, plain))
    print(f"L3 {dtype}: relative L2 against float64 {rel_ref:.3e}, the chunked route "
          f"{rel_chunked:.3e}, the plain version {rel_plain:.3e}")
    if dtype == torch.float32:
        assert max(rel_ref, rel_chunked, rel_plain) <= SCAN_F32_REL
    else:
        assert rel_ref <= SCAN_BF16_REF_REL and rel_plain <= SCAN_BF16_REF_REL
        assert rel_chunked <= SCAN_BF16_CHUNKED_REL


@pytest.mark.parametrize("b,s,di", [(1, 1, 32), (3, 70, 64), (2, 129, 96)])
def test_selective_scan_ragged_and_strided(card, b, s, di):
    """Lengths off the kernel's 64-token chunk, several sequences, and z,
    B and C as views into their products' outputs (row strides), equal to
    contiguous operands bit for bit and within the float32 tolerance of
    the float64 recurrence."""
    from repro_torch.kernels.selective_scan import kernel as SS
    from repro_torch.kernels.selective_scan.ref import selective_scan_ref

    u, dt, z, bm, cm, a, d, bias = _scan_operands(card, torch.float32, b, s, di, seed=s)
    xz = torch.cat([u, z], dim=-1)
    dbc = torch.cat([torch.zeros(b, s, 8, device=card), bm, cm], dim=-1)
    strided = SS.selective_scan_fwd(xz[..., :di], dt, xz[..., di:], dbc[..., 8:24], dbc[..., 24:],
                                    a, d, bias)
    got = SS.selective_scan_fwd(u, dt, z, bm, cm, a, d, bias)
    assert torch.equal(strided, got)
    assert _rel_l2(got, selective_scan_ref(u, dt, z, bm, cm, a, d, bias)) <= SCAN_F32_REL


def test_selective_scan_route_on_the_card(card):
    """``mamba_apply`` launches L3 for CUDA tensors without gradients, the
    chunked scan under gradients, for CPU tensors and for a state width
    outside L3's contract; the routes agree in float32."""
    import dataclasses

    from repro_torch import obs
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels.selective_scan import kernel as SS
    from repro_torch.models import ssm

    cfg = dataclasses.replace(get_arch("jamba_v01_52b").reduced(), mamba_inner_norms=True)
    gen = torch.Generator().manual_seed(2)
    p_cpu = ssm.Mamba(gen, cfg, None).stage(None)
    x_cpu = torch.randn(2, 100, cfg.d_model, generator=gen)
    p = {k: v.detach().to(card).requires_grad_() for k, v in p_cpu.items()}
    x = x_cpu.to(card)
    before = SS.selective_scan_fwd.launches
    with torch.inference_mode(), obs.tracing():
        fused = ssm.mamba_apply(p, x, cfg)
        # the scan on L3, the inner norms of dt, B and C on L4
        assert obs.counters() == {"mamba.kernel_layers": 1, "norm.kernel_calls": 3}
    assert SS.selective_scan_fwd.launches == before + 1
    with torch.enable_grad():
        chunked = ssm.mamba_apply(p, x, cfg)
        chunked.sum().backward()
    assert p["A_log"].grad is not None
    with torch.inference_mode():
        on_cpu = ssm.mamba_apply(p_cpu, x_cpu, cfg)
    assert SS.selective_scan_fwd.launches == before + 1
    assert _rel_l2(fused, chunked.detach()) <= 1e-5
    assert _rel_l2(fused.cpu(), on_cpu) <= 1e-5
    # a state width outside L3's contract takes the chunked scan on the card
    narrow = dataclasses.replace(cfg, mamba_d_state=8)
    p_narrow = ssm.Mamba(gen, narrow, None).stage(None)
    with torch.inference_mode():
        on_card = ssm.mamba_apply({k: v.to(card) for k, v in p_narrow.items()}, x, narrow)
        assert _rel_l2(on_card.cpu(), ssm.mamba_apply(p_narrow, x_cpu, narrow)) <= 1e-5
    assert SS.selective_scan_fwd.launches == before + 1


def test_jamba_width_two_layers_on_the_card(card):
    """Jamba-Mini's widths in bf16 over two layers, a Mamba mixer with the
    16-expert MoE and an attention layer with a dense MLP, through
    ``model.forward`` (L3 once, K7 once, the compact MoE once) at B 2,
    S 2048, against the benchmark's float32 reference, each prompt held to
    its nearest routing path within a 0.25 router margin.  Within 3e-2
    relative L2: bf16 activations rounded at every step of two layers
    (the benchmark's cells read 2-5% at 16-36 layers); a row on a wrong
    expert or a lost state reads O(1)."""
    import dataclasses
    import sys
    from pathlib import Path

    from repro_torch import obs
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels.selective_scan import kernel as SS

    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    from portbench import check, harness

    family = harness.load_module(harness.PKG / "reference" / "jamba.py")
    model = {"n_layers": 2, "d_model": 4096, "num_heads": 32, "num_kv_heads": 8, "head_dim": 128,
             "d_ff": 14336, "vocab_size": 65536, "num_experts": 16, "top_k": 2,
             "mamba_d_state": 16, "mamba_d_conv": 4, "mamba_expand": 2, "mamba_dt_rank": 256,
             "mamba_inner_norms": True, "attn_layer_offset": 1, "attn_layer_period": 2,
             "expert_layer_offset": 0, "expert_layer_period": 2, "rms_eps": 1e-6, "window": None}
    cfg = dataclasses.replace(get_arch("jamba_v01_52b"), n_layers=2,
                              stage_pattern=(("mamba", "moe"), ("attn", "dense")),
                              rope_kind="none", renormalize_topk=False, capacity_factor=8.0,
                              mamba_inner_norms=True).with_dtypes("bfloat16", "bfloat16")
    weights = harness.draw_weights(family.param_specs(model), 31, card, torch.bfloat16)
    program = harness.load_program(cfg, weights)
    tokens = torch.randint(0, 65536, (2, 2048), generator=torch.Generator(device=card).manual_seed(31),
                           device=card, dtype=torch.int32)
    scans, k7 = SS.selective_scan_fwd.launches, FA.flash_attention_fwd.tc_launches
    with obs.tracing():
        got = harness.forward(cfg, program, tokens).float().cpu()
        counters = obs.counters()
    assert SS.selective_scan_fwd.launches == scans + 1
    assert FA.flash_attention_fwd.tc_launches == k7 + 1
    assert counters["mamba.kernel_layers"] == 1 and counters["moe.compact_layers"] == 1
    ref = [c.cpu() for c in family.last_logit_candidates(model, weights, tokens, 0.25)]
    nums = check.numbers(got, ref)
    print(f"Jamba width, two layers: {nums}")
    assert nums["rel_l2_max"] <= 3e-2


# ---------------------------------------------------------------------------
# L4: the row norm and the q/k norm-and-rotate, at the cells' shapes
# ---------------------------------------------------------------------------

# L4 against its plain version.  Both round at the same places (each float32
# product and sum, the norm's rounding to x's type before the rotation, the
# last one); only the order of the sum of squares differs (a butterfly over
# lanes against PyTorch's reduction tree), a few float32 ulps of the scale,
# which now and then moves an output across a rounding boundary: bf16 at
# most one output ulp apart (the norm), relative L2 within NORM_BF16_REL;
# float32 within NORM_F32_REL.  With the rotation after the norm, a flipped
# bf16 input moves x1 c - x2 s by up to one ulp of that input: each output
# lies within ROPE_BF16_ULPS ulps of |x1| + |x2| (one of each input and one
# of the output).  RoPE alone rounds as the plain version does: bit for bit.
NORM_BF16_REL = 1e-3
NORM_F32_REL = 1e-6
ROPE_BF16_ULPS = 2.0 ** -6


def _bf16_ulps_apart(got, want) -> int:
    """The largest distance in bf16 steps between two bf16 tensors."""
    def ordered(t):
        bits = t.contiguous().view(torch.int16).int()
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)

    return int((ordered(got) - ordered(want)).abs().max().item())


def _norm_rows(card, shape, dtype, seed, layout="contiguous"):
    """Rows of (..., d) from a seeded draw: contiguous; for (B, H, S, hd)
    the einsum's (B, S, H, hd) product seen as (B, H, S, hd); or (B, S, d)
    sliced from Jamba's (B, S, 288) x_proj product at ``layout`` = the
    slice's offset."""
    gen = torch.Generator(device=card).manual_seed(seed)
    if layout == "permuted":
        b, h, s, d = shape
        base = torch.randn(b, s, h, d, generator=gen, device=card)
        return (3 * base).to(dtype).permute(0, 2, 1, 3)
    if isinstance(layout, int):
        base = (3 * torch.randn(*shape[:-1], 288, generator=gen, device=card)).to(dtype)
        return base[..., layout:layout + shape[-1]]
    return (3 * torch.randn(shape, generator=gen, device=card)).to(dtype)


def _norm_weight(card, d, dtype, seed=3):
    gen = torch.Generator(device=card).manual_seed(seed)
    return (1 + 0.3 * torch.randn(d, generator=gen, device=card)).to(dtype)


def _check_norm(got, want, dtype):
    assert got.dtype == want.dtype == dtype and got.shape == want.shape and got.is_contiguous()
    rel = _rel_l2(got, want)
    if dtype == torch.bfloat16:
        ulps = _bf16_ulps_apart(got, want)
        print(f"L4 {tuple(got.shape)} bf16: {ulps} ulp apart at most, relative L2 {rel:.3e}")
        assert ulps <= 1 and rel <= NORM_BF16_REL
    else:
        print(f"L4 {tuple(got.shape)} f32: relative L2 {rel:.3e}")
        assert rel <= NORM_F32_REL


@pytest.mark.parametrize("shape,layout", [
    ((7680, 4096), "contiguous"),  # a hidden norm of the long prompt
    ((8, 1024, 4096), "contiguous"),  # chat's eight prompts
    ((1, 7680, 256), 0),  # Jamba's dt norm: a slice of x_proj's product
    ((1, 7680, 16), 256),  # its B norm
    ((1, 7680, 16), 272),  # its C norm
    ((1, 32, 7680, 128), "permuted"),  # Qwen3's q norm, read in place
    ((1001, 16), "contiguous"),  # a ragged last block of narrow rows
    ((3, 16384), "contiguous"),  # 512 threads a row
    ((2, 32768), "contiguous"),  # the widest bf16 row: 8 vectors a thread
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_rms_norm_kernel_matches_plain(card, dtype, shape, layout):
    """L4's row norm against its plain version, one launch a call."""
    if dtype == torch.float32 and shape[-1] == 32768:
        pytest.skip("beyond float32's widest row (4096 vectors of 4)")
    x = _norm_rows(card, shape, dtype, seed=shape[-1], layout=layout)
    w = _norm_weight(card, shape[-1], dtype)
    before = L4.rms_norm_fwd.launches
    got = L4.rms_norm_fwd(x, w)
    assert L4.rms_norm_fwd.launches == before + 1
    _check_norm(got, L4.rms_norm_fwd_plain(x, w), dtype)


@pytest.mark.parametrize("rotate", [False, True], ids=["norm", "norm_rope"])
def test_l4_takes_a_float32_weight_for_bf16_rows(card, rotate):
    """A float32 weight on bf16 rows (a model whose parameters stay float32
    while it computes in bf16): read as float32, as ``weight.float()``."""
    from repro_torch.models import layers

    x = _norm_rows(card, (1, 8, 1024, 128), torch.bfloat16, seed=9, layout="permuted")
    w = _norm_weight(card, 128, torch.float32)
    if rotate:
        cos, sin = layers.rope_angles(torch.arange(1024, device=card).expand(1, 1024), 128, 1e6)
        got, want = L4.qk_rope_fwd(x, w, cos, sin), L4.qk_rope_fwd_plain(x, w, cos, sin)
        assert got.dtype == torch.bfloat16 and _rel_l2(got, want) <= NORM_BF16_REL
    else:
        _check_norm(L4.rms_norm_fwd(x, w), L4.rms_norm_fwd_plain(x, w), torch.bfloat16)


@pytest.mark.parametrize("heads", [32, 8], ids=["q", "k"])
@pytest.mark.parametrize("norm", [True, False], ids=["qwen3", "rope_only"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_qk_rope_kernel_matches_plain(card, dtype, norm, heads):
    """L4's q/k pass at the long cell's (1, H, 7680, 128), read in place
    from the einsum's permuted view, with Qwen3's per-head norm and
    without it (Mixtral's RoPE alone), against its plain version."""
    from repro_torch.models import layers

    x = _norm_rows(card, (1, heads, 7680, 128), dtype, seed=heads, layout="permuted")
    assert not x.is_contiguous()
    w = _norm_weight(card, 128, dtype) if norm else None
    cos, sin = layers.rope_angles(torch.arange(7680, device=card).expand(1, 7680), 128, 1e6)
    before = L4.qk_rope_fwd.launches
    got = L4.qk_rope_fwd(x, w, cos, sin)
    assert L4.qk_rope_fwd.launches == before + 1
    want = L4.qk_rope_fwd_plain(x, w, cos, sin)
    assert got.dtype == dtype and got.shape == want.shape and got.is_contiguous()
    rel = _rel_l2(got, want)
    print(f"L4 q/k {tuple(x.shape)} {dtype} norm={norm}: relative L2 {rel:.3e}, "
          f"{(got != want).float().mean().item():.2e} of the outputs differ")
    if not norm:
        assert torch.equal(got, want)
    elif dtype == torch.float32:
        assert rel <= NORM_F32_REL
    else:
        normed = L4.qk_rope_fwd_plain(x, w, None, None).float()
        mag = normed[..., :64].abs() + normed[..., 64:].abs()
        assert ((got.float() - want.float()).abs() <= ROPE_BF16_ULPS * mag.repeat(1, 1, 1, 2)).all()
        assert rel <= NORM_BF16_REL
        # the norm alone, through the same entry point
        _check_norm(L4.qk_rope_fwd(x, w, None, None), normed.to(dtype), dtype)


def test_qkv_at_qwen3_width_on_both_routes(card, monkeypatch):
    """``blocks._qkv`` at Qwen3-8B's width (bf16, B 1, S 1024): two L4
    launches for q and k on the kernel route, counted under the spans'
    counters; q and k within the q/k pass's limits of the torch route's
    ``rms_norm`` then ``apply_rope``, already contiguous for K7; v as
    before."""
    from repro_torch import obs
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import blocks, layers

    cfg = get_arch("qwen3_8b").with_dtypes("bfloat16", "bfloat16")
    gen = torch.Generator(device=card).manual_seed(5)
    p = blocks.Attention(gen, cfg, None, dtype=torch.bfloat16).stage(None)
    p = dict(p, q_norm=_norm_weight(card, 128, torch.bfloat16, 6),
             k_norm=_norm_weight(card, 128, torch.bfloat16, 7))
    x = torch.randn(1, 1024, cfg.d_model, generator=gen, device=card).bfloat16()
    cos, sin = blocks._rope_tables(cfg, torch.arange(1024, device=card).expand(1, 1024))
    before = (L4.qk_rope_fwd.launches, L4.rms_norm_fwd.launches)
    with torch.inference_mode(), obs.tracing():
        q, k, v = blocks._qkv(p, x, cfg, cos, sin)
        counters = obs.counters()
    assert (L4.qk_rope_fwd.launches, L4.rms_norm_fwd.launches) == (before[0] + 2, before[1])
    assert counters == {"norm.kernel_calls": 2, "rope.kernel_calls": 2}
    assert q.is_contiguous() and k.is_contiguous()
    monkeypatch.setattr(layers, "norm_route", lambda *tensors, rotate=False: "torch")
    with torch.inference_mode():
        q_t, k_t, v_t = blocks._qkv(p, x, cfg, cos, sin)
    assert L4.qk_rope_fwd.launches == before[0] + 2
    assert torch.equal(v, v_t)
    for got, want in ((q, q_t), (k, k_t)):
        assert _rel_l2(got, want) <= NORM_BF16_REL


@pytest.mark.parametrize("case", ["kernel", "under_grad", "odd_width", "misaligned_slice",
                                  "float16"])
def test_norm_route_on_the_card(card, case):
    """``layers.norm_route`` takes L4 for plain CUDA rows it reads in place
    with no gradient to take; the torch route under a gradient, at a width
    or alignment out of its contract and for other types."""
    from repro_torch.models import layers

    x, w = torch.randn(4, 64, device=card), torch.ones(64, device=card)
    if case == "under_grad":
        w.requires_grad_()
    elif case == "odd_width":
        x, w = torch.randn(4, 63, device=card), torch.ones(63, device=card)
    elif case == "misaligned_slice":
        x = torch.randn(4, 72, device=card)[:, 2:66]
    elif case == "float16":
        x = x.half()
    want = "kernel" if case == "kernel" else "torch"
    assert layers.norm_route(x, w) == want
    with torch.no_grad():  # no gradient to take: only the contract decides
        assert layers.norm_route(x, w) == ("kernel" if case in ("kernel", "under_grad") else "torch")


def test_norm_launches_counted_in_a_forward(card):
    """A reduced Qwen3 forward in bf16: one L4 row norm a hidden norm
    (2 a layer and the final one) and one q/k launch for q and one for k
    a layer, as the counters read them; none under gradients (training
    keeps the torch route)."""
    import dataclasses

    from repro_torch import obs
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import model as TM

    cfg = dataclasses.replace(get_arch("qwen3_8b").reduced(), n_layers=3).with_dtypes(
        "bfloat16", "bfloat16")
    params, _ = TM.init_params(cfg, torch.Generator(device=card).manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (2, 64), device=card,
                         generator=torch.Generator(device=card).manual_seed(1))
    before = (L4.rms_norm_fwd.launches, L4.qk_rope_fwd.launches)
    with obs.tracing():
        TM.forward(cfg, params, toks, last_only=True)
        counters = obs.counters()
    n = cfg.n_layers
    assert (L4.rms_norm_fwd.launches - before[0], L4.qk_rope_fwd.launches - before[1]) == (
        2 * n + 1, 2 * n)
    assert counters["norm.kernel_calls"] == 4 * n + 1 and counters["rope.kernel_calls"] == 2 * n
    loss, _ = TM.loss_fn(cfg, params, {"tokens": toks, "labels": toks})
    loss.backward()
    assert (L4.rms_norm_fwd.launches - before[0], L4.qk_rope_fwd.launches - before[1]) == (
        2 * n + 1, 2 * n)
