"""The CUDA kernels on the card: each against its plain PyTorch version and
the numpy oracle, and ``backend="auto"`` resolving to them, per GEMM (K1,
K4) and through the batched pipeline (K2, K3).

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
from repro_torch.runtime import faults

pytestmark = pytest.mark.cuda

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
