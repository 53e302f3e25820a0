"""Parity copy of ``tests/test_resilience.py`` on the port's CPU path.

Failure taxonomy, retry/degradation ladder, fault-injection harness, and
the pipeline's recovery paths: every injector class (backend, hang,
device_loss) drives its recovery end to end, recovered profiles stay
bit-exact vs the numpy oracle, and ``BatchStats.failure_report`` accounts
for every injected fault with a typed cause + action.

The port's ladder is ``("cuda", "torch", "numpy")`` where the reference has
``("pallas", "xla", "numpy")``.  The pure-Python pieces (retry schedule,
fault draws, bit flips) must behave exactly as the reference's; the
pipeline's recovery must report what the reference reports under the same
faults, rung for rung (``torch`` for ``xla``).  Device lists are
monkeypatched (two CPU devices) where a test needs several.
"""

import concurrent.futures

import numpy as np
import pytest
import torch

from repro.core.pipeline import ProfileJob as RefJob
from repro.core.pipeline import run_profile_batch as ref_run_profile_batch
from repro.kernels.activity_profile.ref import profile_gemm_toggles_ref as ref_oracle
from repro.runtime import faults as ref_faults
from repro.runtime import resilience as ref_resilience
from repro_torch.core import pipeline
from repro_torch.core.pipeline import ProfileJob, run_profile_batch
from repro_torch.core.switching import clear_profile_cache, profile_cache_info
from repro_torch.kernels import _build
from repro_torch.kernels.activity_profile.ref import profile_gemm_toggles_ref
from repro_torch.runtime import faults
from repro_torch.runtime.health import HealthMonitor
from repro_torch.runtime.resilience import (
    BackendCompileError,
    ContractViolationError,
    DeviceDispatchError,
    DeviceLossError,
    FailureReport,
    ProfileTimeoutError,
    RetryPolicy,
    call_with_retry,
    classify_exception,
    LADDER_RUNGS,
    degradation_ladder,
    evaluation_ladder,
)

# Reference rung -> port rung.
RUNG = {"pallas": "cuda", "xla": "torch", "numpy": "numpy"}


@pytest.fixture(autouse=True)
def _pin_faults():
    """Exact-report tests must see ONLY their own injected faults: shield
    them (and the reference runs beside them) from env-armed injection."""
    with faults.injected([]), ref_faults.injected([]):
        yield


def _rand_gemm(m, k, n, lo=-500, hi=500):
    rng = np.random.default_rng([m, k, n, 11])
    return rng.integers(lo, hi, size=(m, k)), rng.integers(lo, hi, size=(k, n))


def _counts(p):
    return (
        round(p.a_h * p.h_transitions * p.b_h),
        round(p.a_v * p.v_transitions * p.b_v),
        p.h_transitions,
        p.v_transitions,
    )


SHAPES = [(33, 20, 10), (16, 12, 8), (48, 24, 16)]


def _specs(n=3, dataflow="WS"):
    return [
        dict(rows=8, cols=8, b_h=16, b_v=37, a=a, w=w, name=f"j{i}", dataflow=dataflow)
        for i, (m, k, n_) in enumerate(SHAPES[:n])
        for a, w in [_rand_gemm(m, k, n_)]
    ]


def _jobs(n=3, dataflow="WS"):
    return [ProfileJob(**spec) for spec in _specs(n, dataflow)]


def _assert_bit_exact(jobs, profiles):
    for job, p in zip(jobs, profiles):
        args = (job.a, job.w, job.rows, job.cols, job.b_h, job.b_v)
        want = profile_gemm_toggles_ref(*args, dataflow=job.dataflow)
        assert _counts(p) == want == ref_oracle(*args, dataflow=job.dataflow), job.name


def _ref_report(specs, ref_fault_specs, **kw):
    """The reference's run of the same jobs under the same faults (its
    rungs named as the port's)."""
    with ref_faults.injected(ref_fault_specs):
        profiles, stats = ref_run_profile_batch(
            [RefJob(**spec) for spec in specs], use_cache=False, engine="xla", **kw
        )
    actions = {}
    for action, n in stats.failure_report.actions().items():
        kind, _, rung = action.partition(":")
        key = f"{kind}:{RUNG[rung]}" if kind == "degraded" else action
        actions[key] = n
    return profiles, stats, actions


# ---------------------------------------------------------------------------
# taxonomy
# ---------------------------------------------------------------------------


def test_classify_exception_taxonomy():
    assert isinstance(classify_exception(TimeoutError("t")), ProfileTimeoutError)
    assert isinstance(
        classify_exception(concurrent.futures.TimeoutError()), ProfileTimeoutError
    )
    assert isinstance(classify_exception(ValueError("v")), ContractViolationError)
    assert isinstance(classify_exception(ImportError("m")), BackendCompileError)
    assert isinstance(
        classify_exception(RuntimeError("kernel lowering failed")), BackendCompileError
    )
    assert isinstance(
        classify_exception(RuntimeError("transfer aborted")), DeviceDispatchError
    )
    # idempotent: typed errors pass through, annotating job/stage
    err = DeviceLossError("gone")
    assert classify_exception(err, job="j1", stage="dispatch") is err
    assert err.job == "j1" and err.stage == "dispatch"
    assert err.kind == "device-loss"
    assert isinstance(err, DeviceDispatchError)  # loss subclasses dispatch
    # pre-taxonomy ValueError handlers keep catching contract violations
    assert isinstance(ContractViolationError("bad"), ValueError)
    assert "device-loss" in err.describe()
    # same kinds as the reference for the exceptions both know
    for exc in (
        TimeoutError("t"), ValueError("v"), TypeError("t"), ImportError("m"),
        NotImplementedError("n"), RuntimeError("transfer aborted"),
        RuntimeError("compile failed"), KeyError("k"),
    ):
        assert classify_exception(exc).kind == ref_resilience.classify_exception(exc).kind


_DSA = (
    "\nCUDA kernel errors might be asynchronously reported at some other API "
    "call, so the stacktrace below might be incorrect.\nFor debugging consider "
    "passing CUDA_LAUNCH_BLOCKING=1\nCompile with `TORCH_USE_CUDA_DSA` to enable "
    "device-side assertions.\n"
)


@pytest.mark.parametrize(
    "exc,kind",
    [
        (torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB"),
         DeviceDispatchError),
        (RuntimeError("CUDA error: an illegal memory access was encountered" + _DSA),
         DeviceDispatchError),
        (RuntimeError("CUDA error: unspecified launch failure" + _DSA), DeviceDispatchError),
        (RuntimeError("ws_task_toggles: CUDA launch failed with error 1"), DeviceDispatchError),
        (RuntimeError("CUDA kernel build failed:\nactivity_batch: nvcc exited 1"),
         BackendCompileError),
        (RuntimeError("nvcc not found: the CUDA kernels cannot be built"), BackendCompileError),
        (RuntimeError("CUDA error: no kernel image is available for execution on the device"
                      + _DSA), BackendCompileError),
    ],
)
def test_classify_lifts_the_cards_errors(exc, kind):
    err = classify_exception(exc)
    assert type(err) is kind, err.describe()


def test_build_failure_classifies_as_compile(monkeypatch, tmp_path):
    """The port's own build: a compiler that fails raises a message that the
    taxonomy classes as a (non-retryable on the same rung) compile error."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_nvcc", lambda: "false")  # a compiler that always fails
    with pytest.raises(RuntimeError, match="CUDA kernel build failed") as ei:
        _build.build(["activity_batch"])
    assert isinstance(classify_exception(ei.value), BackendCompileError)


def test_degradation_ladder_rungs():
    # Unlike the reference's full ladder, work on the card stays on the card.
    assert degradation_ladder() == ("cuda",)
    assert degradation_ladder("auto") == ("cuda",)
    assert degradation_ladder("cuda") == ("cuda",)
    assert degradation_ladder("torch") == ("torch", "numpy")
    assert tuple(RUNG[r] for r in ref_resilience.degradation_ladder("xla")) == (
        degradation_ladder("torch")
    )
    assert tuple(RUNG[r] for r in ref_resilience.LADDER_RUNGS) == LADDER_RUNGS
    with pytest.raises(ContractViolationError, match="unknown engine"):
        degradation_ladder("xla")
    # The sweep ladder's rungs are named by engine: the reference's eager
    # rung is the port's numpy rung, its jit rung the evaluator's engine.
    eval_rung = {"jit": "torch", "eager": "numpy", "scalar": "scalar"}
    assert evaluation_ladder("numpy") == tuple(
        eval_rung[r] for r in ref_resilience.evaluation_ladder("eager"))
    assert evaluation_ladder("torch") == tuple(
        eval_rung[r] for r in ref_resilience.evaluation_ladder("jit"))
    assert evaluation_ladder() == evaluation_ladder("cuda") == ("cuda", "numpy", "scalar")
    with pytest.raises(ContractViolationError, match="unknown evaluation rung"):
        evaluation_ladder("jit")


def test_failure_report_accounting():
    rep = FailureReport()
    assert not rep and len(rep) == 0
    rep.add(BackendCompileError("x", job="a"), action="degraded:torch")
    rep.add(ProfileTimeoutError("y", job="b"), action="skipped")
    rep.add(BackendCompileError("z", job="b"), action="degraded:numpy")
    assert rep and len(rep) == 3
    assert rep.counts() == {"backend-compile": 2, "timeout": 1}
    assert rep.actions() == {"degraded:torch": 1, "skipped": 1, "degraded:numpy": 1}
    assert [r.action for r in rep.for_job("b")] == ["skipped", "degraded:numpy"]
    assert "3 failures" in rep.summary()
    d = rep.as_dict()
    assert len(d["records"]) == 3 and d["counts"]["backend-compile"] == 2


# ---------------------------------------------------------------------------
# retry policy
# ---------------------------------------------------------------------------


def test_retry_policy_deterministic_backoff():
    pol = RetryPolicy(base_delay_s=0.1, multiplier=2.0, jitter=0.5, seed=42)
    d0, d1 = pol.delay(0, "site"), pol.delay(1, "site")
    assert pol.delay(0, "site") == d0  # pure function of (seed, key, attempt)
    assert 0.1 <= d0 <= 0.15 and 0.2 <= d1 <= 0.3
    assert pol.delay(0, "other") != d0  # distinct sites decorrelate
    assert pol.delay(10, "site") <= pol.max_delay_s * (1 + pol.jitter)
    ref = ref_resilience.RetryPolicy(base_delay_s=0.1, multiplier=2.0, jitter=0.5, seed=42)
    assert [pol.delay(i, "site") for i in range(6)] == [ref.delay(i, "site") for i in range(6)]


def test_call_with_retry_recovers_transient_fault():
    sleeps = []
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise DeviceLossError("transient")
        return "ok"

    out, attempts, last = call_with_retry(
        flaky, policy=RetryPolicy(max_attempts=3), key="k", sleep=sleeps.append
    )
    assert out == "ok" and attempts == 3
    assert last is not None and last.kind == "device-loss"
    assert len(sleeps) == 2 and sleeps[1] > sleeps[0]


def test_call_with_retry_exhaustion_raises_typed():
    def dead():
        raise RuntimeError("device transfer aborted")

    with pytest.raises(DeviceDispatchError) as ei:
        call_with_retry(dead, policy=RetryPolicy(max_attempts=2), sleep=lambda s: None)
    assert ei.value.attempts == 2


def test_call_with_retry_never_retries_contract_violations():
    calls = {"n": 0}

    def bad():
        calls["n"] += 1
        raise ValueError("bad shapes")

    with pytest.raises(ContractViolationError):
        call_with_retry(bad, policy=RetryPolicy(max_attempts=5), sleep=lambda s: None)
    assert calls["n"] == 1


# ---------------------------------------------------------------------------
# fault injector
# ---------------------------------------------------------------------------


def _fire_sequence(module, seed):
    inj = module.FaultInjector([module.FaultSpec("backend", rate=0.5)], seed=seed)
    seq = []
    for i in range(20):
        try:
            inj.maybe_fail_backend("site", f"k{i}")
            seq.append(0)
        except Exception:
            seq.append(1)
    return seq


def test_fault_injector_deterministic_and_scoped():
    fires = [_fire_sequence(faults, 9) for _ in range(2)]  # identical schedule on replay
    assert fires[0] == fires[1]
    assert 0 < sum(fires[0]) < 20  # rate=0.5 actually splits
    assert fires[0] == _fire_sequence(ref_faults, 9)  # and the reference's schedule

    # match pins a fault to one site; max_fires caps it
    inj = faults.FaultInjector([faults.FaultSpec("device_loss", match="d1", max_fires=1)])
    inj.maybe_lose_device("shard", "d0")  # no match: silent
    with pytest.raises(DeviceLossError):
        inj.maybe_lose_device("shard", "d1")
    inj.maybe_lose_device("shard", "d1")  # capped: silent
    assert inj.fired_kinds() == {"device_loss"}
    assert [f.site for f in inj.fired] == ["shard"]


def test_fault_injector_bitflip_is_single_deterministic_bit():
    inj = faults.FaultInjector([faults.FaultSpec("bitflip")], seed=5)
    raw = b"hello profile store"
    out = inj.maybe_corrupt(raw, "store-read", "k")
    assert out != raw and len(out) == len(raw)
    diff = [i for i, (x, y) in enumerate(zip(raw, out)) if x != y]
    assert len(diff) == 1
    assert bin(raw[diff[0]] ^ out[diff[0]]).count("1") == 1
    inj2 = faults.FaultInjector([faults.FaultSpec("bitflip")], seed=5)
    assert inj2.maybe_corrupt(raw, "store-read", "k") == out
    ref = ref_faults.FaultInjector([ref_faults.FaultSpec("bitflip")], seed=5)
    assert ref.maybe_corrupt(raw, "store-read", "k") == out


def test_fault_env_activation(monkeypatch):
    faults.clear()
    monkeypatch.setenv("REPRO_TORCH_FAULTS", "backend=0.25,hang=1,seed=3,hang_s=0.01")
    inj = faults.active()
    assert inj is not None and inj.seed == 3 and inj.hang_s == 0.01
    assert {s.kind for s in inj.specs} == {"backend", "hang"}
    faults.clear()
    monkeypatch.setenv("REPRO_TORCH_FAULTS", "")
    assert faults.active() is None
    monkeypatch.setenv("REPRO_TORCH_FAULTS", "warp=1")
    faults.clear()
    with pytest.raises(ValueError, match="unknown fault kind"):
        faults.active()
    faults.clear()
    # the JAX package's chaos settings do not arm the port
    assert faults.from_env({"REPRO_FAULTS": "backend=1,seed=3"}) is None


# ---------------------------------------------------------------------------
# pipeline recovery paths (plain versions on the CPU)
# ---------------------------------------------------------------------------


def test_ladder_lands_on_numpy_bit_exact():
    """Batched dispatch AND the torch rung fail -> numpy, bit-exact."""
    specs = _specs()
    jobs = [ProfileJob(**s) for s in specs]
    fault_specs = [
        faults.FaultSpec("backend", match="bucket-dispatch"),
        faults.FaultSpec("backend", match="ladder:cuda"),
        faults.FaultSpec("backend", match="ladder:torch"),
    ]
    with faults.injected(fault_specs, seed=1) as inj:
        profiles, stats = run_profile_batch(
            jobs, backend="torch", use_cache=False, on_error="degrade"
        )
    assert all(p is not None for p in profiles)
    _assert_bit_exact(jobs, profiles)
    assert stats.degraded == len(jobs) and stats.skipped == 0
    rep = stats.failure_report
    assert rep.actions() == {"degraded:numpy": len(jobs)}
    assert set(rep.counts()) == {"backend-compile"}
    assert "backend" in inj.fired_kinds()
    # the torch engine's ladder never visits the cuda rung
    assert not any(f.site == "ladder:cuda" for f in inj.fired)
    ref_profiles, ref_stats, ref_actions = _ref_report(
        specs,
        [
            ref_faults.FaultSpec("backend", match="bucket-dispatch"),
            ref_faults.FaultSpec("backend", match="ladder:xla"),
        ],
        on_error="degrade",
    )
    assert ref_actions == rep.actions() and ref_stats.failure_report.counts() == rep.counts()
    assert [_counts(p) for p in profiles] == [_counts(r) for r in ref_profiles]


def test_ladder_first_rung_recovers_without_numpy():
    """Only the batched dispatch fails -> the first ladder rung lands."""
    specs = _specs(2)
    jobs = [ProfileJob(**s) for s in specs]
    with faults.injected([faults.FaultSpec("backend", match="bucket-dispatch")]):
        profiles, stats = run_profile_batch(
            jobs, backend="torch", use_cache=False, on_error="degrade"
        )
    _assert_bit_exact(jobs, profiles)
    assert stats.failure_report.actions() == {"degraded:torch": len(jobs)}
    _, _, ref_actions = _ref_report(
        specs, [ref_faults.FaultSpec("backend", match="bucket-dispatch")], on_error="degrade"
    )
    assert ref_actions == stats.failure_report.actions()


def test_transient_fault_retried_within_rung():
    """One injected device loss at the first rung -> retry succeeds there."""
    jobs = _jobs(1)
    fault_specs = [
        faults.FaultSpec("backend", match="bucket-dispatch"),
        faults.FaultSpec("device_loss", match="ladder:torch", max_fires=1),
    ]
    with faults.injected(fault_specs):
        profiles, stats = run_profile_batch(
            jobs, backend="torch", use_cache=False, on_error="degrade",
            retry=RetryPolicy(max_attempts=3, base_delay_s=0.001),
        )
    _assert_bit_exact(jobs, profiles)
    assert stats.retries == 1
    assert stats.failure_report.actions() == {"degraded:torch": 1}


def test_on_error_skip_keeps_successes():
    jobs = _jobs(3)
    with faults.injected(
        [
            faults.FaultSpec("backend", match="bucket-dispatch"),
            faults.FaultSpec("backend", match="ladder"),
        ]
    ):
        profiles, stats = run_profile_batch(
            jobs, backend="torch", use_cache=False, on_error="skip"
        )
    # all three share one bucket: the whole bucket failed, all skipped
    assert profiles == [None, None, None]
    assert stats.skipped == 3
    assert stats.failure_report.actions() == {"skipped": 3}
    # mixed outcome: only the serial-path job is poisoned, batch survives
    a1, w1 = _rand_gemm(1, 6, 4)
    degenerate = ProfileJob(  # M=1 stream: serial fallback path
        rows=8, cols=8, b_h=16, b_v=37, a=a1, w=w1, name="deg"
    )
    jobs2 = _jobs(2) + [degenerate]
    with faults.injected([faults.FaultSpec("backend", match="serial")]):
        profiles, stats = run_profile_batch(
            jobs2, backend="torch", use_cache=False, on_error="skip"
        )
    assert profiles[2] is None and stats.skipped == 1
    _assert_bit_exact(jobs2[:2], profiles[:2])
    assert stats.failure_report.for_job("deg")[0].action == "skipped"


def test_on_error_raise_is_typed_and_default():
    jobs = _jobs(1)
    with faults.injected([faults.FaultSpec("backend", match="bucket-dispatch")]):
        with pytest.raises(BackendCompileError):
            run_profile_batch(jobs, backend="torch", use_cache=False, on_error="raise")
    # the default is "raise", whatever the JAX package's environment says
    with faults.injected([faults.FaultSpec("backend", match="bucket-dispatch")]):
        with pytest.raises(BackendCompileError):
            run_profile_batch(jobs, backend="torch", use_cache=False)
    with pytest.raises(ContractViolationError, match="unknown on_error"):
        run_profile_batch(jobs, backend="torch", use_cache=False, on_error="panic")


def test_contract_violations_raise_in_every_mode():
    a, w = _rand_gemm(10, 6, 4)
    bad = ProfileJob(rows=8, cols=8, b_h=16, b_v=37, make=lambda: (a, w), shape=(11, 6, 4))
    for mode in ("raise", "degrade", "skip"):
        with pytest.raises(ValueError, match="declared shape"):
            run_profile_batch([bad], backend="torch", use_cache=False, on_error=mode)


@pytest.fixture
def two_devices(monkeypatch):
    monkeypatch.setattr(pipeline, "_devices", lambda engine: [torch.device("cpu")] * 2)


def test_timeout_evicts_device_and_resubmits(two_devices):
    """A hung shard on a 2-device host: evict, resubmit once, bit-exact.

    Not timing-fragile by construction: the healthy shard is 64 tiny tasks
    (milliseconds against a 1 s budget), and the hang lasts 3.5x the budget.
    """
    # 16 k_tiles x 8 n_tiles = 128 tasks -> 2 shards on 2 devices
    a, w = _rand_gemm(16, 128, 64)
    job = ProfileJob(rows=8, cols=8, b_h=16, b_v=37, a=a, w=w, name="big")
    health = HealthMonitor(range(2))
    with faults.injected(
        [faults.FaultSpec("hang", match="b0s1d1", max_fires=1)], hang_s=3.5
    ) as inj:
        (p,), stats = run_profile_batch(
            [job], backend="torch", use_cache=False, on_error="degrade",
            timeout_s=1.0, health=health,
        )
    assert inj.fired_kinds() == {"hang"}
    assert _counts(p) == profile_gemm_toggles_ref(a, w, 8, 8, 16, 37)
    assert stats.resubmits == 1 and stats.degraded == 0
    assert health.alive_hosts() == [0]  # device 1 was evicted
    rep = stats.failure_report
    assert rep.actions() == {"device-evicted:resubmitted": 1}
    assert rep.counts() == {"timeout": 1}


def test_device_loss_evicts_and_resubmits(two_devices):
    a, w = _rand_gemm(16, 128, 64)
    job = ProfileJob(rows=8, cols=8, b_h=16, b_v=37, a=a, w=w)
    health = HealthMonitor(range(2))
    with faults.injected([faults.FaultSpec("device_loss", match="d1", max_fires=1)]):
        (p,), stats = run_profile_batch(
            [job], backend="torch", use_cache=False, on_error="degrade", health=health,
        )
    assert _counts(p) == profile_gemm_toggles_ref(a, w, 8, 8, 16, 37)
    assert stats.resubmits == 1
    assert stats.failure_report.counts() == {"device-loss": 1}
    assert health.alive_hosts() == [0]


def test_os_stream_bucket_failure_degrades_bit_exact():
    specs = _specs(2, dataflow="OS")
    jobs = [ProfileJob(**s) for s in specs]
    with faults.injected([faults.FaultSpec("backend", match="stream-dispatch")]):
        profiles, stats = run_profile_batch(
            jobs, backend="torch", use_cache=False, on_error="degrade"
        )
    _assert_bit_exact(jobs, profiles)
    assert stats.degraded == len(jobs)
    assert stats.failure_report.actions() == {"degraded:torch": len(jobs)}
    _, _, ref_actions = _ref_report(
        specs, [ref_faults.FaultSpec("backend", match="stream-dispatch")], on_error="degrade"
    )
    assert ref_actions == stats.failure_report.actions()


def test_recovered_profile_lands_in_cache_under_original_key():
    """Ladder recovery stores under the batched-path key: the next batch
    (no faults) serves the SAME jobs from cache without device work."""
    clear_profile_cache()
    jobs = _jobs(2)
    with faults.injected([faults.FaultSpec("backend", match="bucket-dispatch")]):
        profiles, stats = run_profile_batch(jobs, backend="torch", on_error="degrade")
    assert stats.degraded == 2
    profiles2, stats2 = run_profile_batch(jobs, backend="torch")
    assert stats2.cache_hits == 2 and stats2.degraded == 0
    assert profiles2 == profiles
    assert profile_cache_info()["hits"] >= 2
    clear_profile_cache()


def test_numpy_backend_never_touches_device_paths():
    """backend="numpy" must not trip device/bucket fault sites at all."""
    jobs = _jobs(2)
    with faults.injected(
        [
            faults.FaultSpec("backend", match="bucket"),
            faults.FaultSpec("hang", match="bucket"),
            faults.FaultSpec("device_loss"),
        ]
    ) as inj:
        profiles, stats = run_profile_batch(jobs, backend="numpy", use_cache=False)
    _assert_bit_exact(jobs, profiles)
    assert inj.fired == [] and stats.serial_fallbacks == len(jobs)


def test_failure_report_in_stats_dict():
    jobs = _jobs(1)
    with faults.injected([faults.FaultSpec("backend", match="bucket-dispatch")]):
        _, stats = run_profile_batch(jobs, backend="torch", use_cache=False, on_error="degrade")
    d = stats.as_dict()
    assert d["degraded"] == 1
    assert d["failure_report"]["actions"] == {"degraded:torch": 1}
    assert d["failure_report"]["records"][0]["error"] == "backend-compile"


# ---------------------------------------------------------------------------
# no card: the card is never left silently
# ---------------------------------------------------------------------------


def test_no_card_raises_unless_told_to_degrade(monkeypatch):
    """``backend="cuda"`` on a host without a card: the default mode raises
    a typed dispatch error.  ``on_error="degrade"`` retries each job on the
    card and then skips it, recorded: it never moves work to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    jobs = _jobs(2)
    with pytest.raises(DeviceDispatchError, match="CUDA device"):
        run_profile_batch(jobs, backend="cuda", use_cache=False)
    profiles, stats = run_profile_batch(
        jobs, backend="cuda", use_cache=False, on_error="degrade",
        retry=RetryPolicy(max_attempts=2, base_delay_s=0.001),
    )
    assert profiles == [None, None]
    assert stats.degraded == 0 and stats.skipped == len(jobs)
    assert stats.retries == len(jobs)  # one retry each, on the cuda rung
    assert stats.failure_report.actions() == {"skipped": len(jobs)}
    assert stats.failure_report.counts() == {"device-dispatch": len(jobs)}
    profiles, stats = run_profile_batch(jobs, backend="cuda", use_cache=False, on_error="skip")
    assert profiles == [None, None] and stats.skipped == len(jobs)
