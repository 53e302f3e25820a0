"""The port's checkpointed sweep runner (``core.sweep``) against the JAX
package's, case by case from ``tests/test_sweep.py``.

The reference's rungs translate: its ``jit`` rung is the evaluator's
engine (here ``"torch"``, the float64 program on the CPU), its ``eager``
rung the port's ``"numpy"``.  Chunked output equals unchunked output bit
for bit, a killed-and-resumed sweep equals an uninterrupted one bit for
bit, every injected fault is caught by a guard or recovered down the
engine -> numpy -> scalar ladder, and the ``SweepReport`` accounts for it
in typed records.  The port's chunks are also held to the reference's
``use_jit=False`` sweep within 1e-12, with the same report counters.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch
from _hyp import given, settings, st

import repro.core.design_space as ref_ds
import repro.core.sweep as ref_sweep
import repro.layout.power as ref_power
from repro.runtime import faults as ref_faults
from repro_torch.core.design_space import DesignSpace, evaluate_design_space
from repro_torch.core.energy import EnergyModelConfig
from repro_torch.core.store import ContentStore
from repro_torch.core.sweep import (
    SWEEP_STORE_VERSION,
    SweepConfig,
    SweepInterrupted,
    _chunk_idx,
    _chunk_key,
    _decode_chunk,
    _encode_chunk,
    _guard_error,
    _spec_key,
)
from repro_torch.kernels._engine import CudaUnavailableError
from repro_torch.layout.power import evaluate_layout_space
from repro_torch.runtime import faults
from repro_torch.runtime.health import HealthMonitor
from repro_torch.runtime.resilience import (
    ContractViolationError,
    CrossEngineMismatchError,
    GuardViolationError,
)

RTOL = 1e-12
# The golden-section cross-check is the argmin of a smooth minimum, set
# only to about sqrt(eps): torch's exp moves it by up to ~1e-8 against
# numpy's (tests/test_torch_design_space.py).
GSS_ARGMIN_RTOL = 1e-7


@pytest.fixture(autouse=True)
def _pin_faults():
    """Exact-report tests must see ONLY their own injected faults: shield
    them from env-armed chaos injection in both packages."""
    with faults.injected([]), ref_faults.injected([]):
        yield


AXES = dict(
    rows=(8, 16),
    cols=(8, 16),
    input_bits=(8,),
    dataflows=("WS", "OS"),
    bus_invert=(False, True),
)
SPACE = DesignSpace(**AXES)
GRID = SPACE.expand()  # 16 points
REF_GRID = ref_ds.DesignSpace(**AXES).expand()
LAXES = dict(rows=(8, 16), cols=(8, 16), input_bits=(8,), dataflows=("WS", "OS"))
LGRID = DesignSpace(**LAXES).expand()  # BI-free: the layout engine prices physical buses
REF_LGRID = ref_ds.DesignSpace(**LAXES).expand()
LAYOUTS = ("uniform", "serpentine2", "pods2x2")

rng = np.random.default_rng(23)
W = 2
A_H = rng.uniform(0.1, 0.4, (W, GRID.n_points))
A_V = rng.uniform(0.2, 0.6, (W, GRID.n_points))

FIELDS = (
    "a_v_eff",
    "aspect_opt",
    "aspect_opt_gss",
    "bus_power_opt",
    "bus_power_sym",
    "aspect_robust",
    "max_regret",
    "bus_power_robust",
    "bus_power_square",
    "interconnect_saving",
    "total_saving",
    "area_um2",
    "bus_energy_per_mac_j",
    "neg_macs_per_cycle",
)
LFIELDS = (
    "feasible",
    "aspect_lo",
    "aspect_hi",
    "aspect_opt",
    "bus_power_opt",
    "aspect_robust",
    "bus_power_robust",
    "overhead_w",
    "wirelength_um",
)


def _assert_bit_identical(a, b, fields):
    for f in fields:
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype and x.shape == y.shape, f
        assert np.ascontiguousarray(x).tobytes() == np.ascontiguousarray(y).tobytes(), f


def _counters(rep) -> dict:
    d = rep.as_dict()
    keys = ("n_points", "chunk_size", "chunks_total", "chunks_evaluated", "chunks_resumed",
            "chunks_quarantined", "guard_checks", "guard_failures", "resubmits")
    return {**{k: d[k] for k in keys}, "actions": d["failures"]["actions"],
            "counts": d["failures"]["counts"]}


# ---------------------------------------------------------------------------
# Chunked == unchunked (the sweep runner changes execution, never the math)
# ---------------------------------------------------------------------------


def test_chunked_matches_unchunked_jit():
    plain = evaluate_design_space(GRID, A_H, A_V, engine="torch")
    # chunk_size=7 forces a ragged (clamp-padded) last chunk: 16 -> 7+7+2
    chunked = evaluate_design_space(
        GRID, A_H, A_V, engine="torch", sweep=SweepConfig(chunk_size=7)
    )
    _assert_bit_identical(plain, chunked, FIELDS)
    rep = chunked.sweep_report
    assert rep.kind == "design" and rep.chunks_total == 3
    assert rep.chunks_evaluated == 3 and rep.chunks_resumed == 0
    assert rep.guard_failures == 0 and rep.guard_checks == 3
    assert rep.rung_counts() == {"torch": 3}
    assert np.array_equal(plain.pareto(), chunked.pareto())


def test_chunked_matches_unchunked_eager():
    plain = evaluate_design_space(GRID, A_H, A_V, engine="numpy")
    chunked = evaluate_design_space(
        GRID, A_H, A_V, engine="numpy", sweep=SweepConfig(chunk_size=5)
    )
    _assert_bit_identical(plain, chunked, FIELDS)
    assert chunked.sweep_report.rung_counts() == {"numpy": 4}


@pytest.mark.parametrize("engine", ["torch", "numpy"])
def test_chunked_matches_unchunked_layout(tmp_path, engine):
    la_h, la_v = A_H[:, : LGRID.n_points], A_V[:, : LGRID.n_points]
    kw = dict(layouts=LAYOUTS, engine=engine)
    plain = evaluate_layout_space(LGRID, la_h, la_v, **kw)
    chunked = evaluate_layout_space(
        LGRID, la_h, la_v, **kw, sweep=SweepConfig(chunk_size=3, store=tmp_path / "s")
    )
    _assert_bit_identical(plain, chunked, LFIELDS)
    assert chunked.sweep_report.kind == "layout"
    assert chunked.sweep_report.chunks_evaluated == 3
    assert chunked.sweep_report.rung_counts() == {engine: 3}
    # resumed run serves every chunk from the store, bit-identically
    resumed = evaluate_layout_space(
        LGRID, la_h, la_v, **kw, sweep=SweepConfig(chunk_size=3, store=tmp_path / "s")
    )
    _assert_bit_identical(plain, resumed, LFIELDS)
    rep = resumed.sweep_report
    assert rep.chunks_resumed == 3 and rep.chunks_evaluated == 0
    assert np.array_equal(plain.best_layout, resumed.best_layout)


# ---------------------------------------------------------------------------
# Resume: store round-trip, interruption, kill -9, corruption
# ---------------------------------------------------------------------------


def test_resume_serves_all_chunks_bit_identically(tmp_path):
    sw = lambda: SweepConfig(chunk_size=7, store=tmp_path / "chunks")
    cold = evaluate_design_space(GRID, A_H, A_V, engine="torch", sweep=sw())
    warm = evaluate_design_space(GRID, A_H, A_V, engine="torch", sweep=sw())
    _assert_bit_identical(cold, warm, FIELDS)
    rep = warm.sweep_report
    assert rep.chunks_resumed == 3 and rep.chunks_evaluated == 0
    # resumed chunks still pass the guards
    assert rep.guard_checks == 3 and rep.guard_failures == 0
    assert all(r.status == "resumed" for r in rep.records)
    assert rep.rung_counts() == {"torch": 3}


def test_jit_and_eager_runs_never_share_chunks(tmp_path):
    """The starting rung is part of the spec key: chunks of the "cuda",
    "torch" and "numpy" rungs agree to tolerance, not bit for bit, so no
    run is served another's."""
    store = tmp_path / "chunks"
    evaluate_design_space(
        GRID, A_H, A_V, engine="torch", sweep=SweepConfig(chunk_size=7, store=store)
    )
    ev = evaluate_design_space(
        GRID, A_H, A_V, engine="numpy", sweep=SweepConfig(chunk_size=7, store=store)
    )
    assert ev.sweep_report.chunks_resumed == 0
    assert ev.sweep_report.chunks_evaluated == 3
    w = np.full(W, 1.0 / W)
    extra = lambda rung: [("cfg", repr(dataclasses.astuple(EnergyModelConfig()))),
                          ("gss_iters", 64), ("chunk_size", 7), ("start_rung", rung)]
    specs = {rung: _spec_key("design", GRID, A_H, A_V, w, extra(rung))
             for rung in ("cuda", "torch", "numpy")}
    assert len(set(specs.values())) == 3
    s = ContentStore(store, version=SWEEP_STORE_VERSION)
    assert s.get_payload(_chunk_key(specs["cuda"], 0)) is None
    assert s.get_payload(_chunk_key(specs["torch"], 0)) is not None


def test_store_version_is_the_ports_own(tmp_path):
    """A store directory the JAX package wrote never serves the port: the
    versions differ, so the chunks live in different directories."""
    assert SWEEP_STORE_VERSION != ref_sweep.SWEEP_STORE_VERSION
    store = tmp_path / "chunks"
    ref_ds.evaluate_design_space(
        REF_GRID, A_H, A_V, use_jit=False, sweep=ref_sweep.SweepConfig(chunk_size=7, store=store)
    )
    ev = evaluate_design_space(
        GRID, A_H, A_V, engine="numpy", sweep=SweepConfig(chunk_size=7, store=store)
    )
    assert ev.sweep_report.chunks_resumed == 0
    assert len(ContentStore(store, version=SWEEP_STORE_VERSION).entries()) == 3


def test_max_chunks_interrupts_then_resume_completes(tmp_path):
    store = tmp_path / "chunks"
    baseline = evaluate_design_space(GRID, A_H, A_V, engine="torch")
    with pytest.raises(SweepInterrupted) as ei:
        evaluate_design_space(
            GRID, A_H, A_V, engine="torch",
            sweep=SweepConfig(chunk_size=7, store=store, max_chunks=2),
        )
    assert ei.value.report.chunks_evaluated == 2  # committed before the stop
    done = evaluate_design_space(
        GRID, A_H, A_V, engine="torch", sweep=SweepConfig(chunk_size=7, store=store)
    )
    rep = done.sweep_report
    assert rep.chunks_resumed == 2 and rep.chunks_evaluated == 1
    _assert_bit_identical(baseline, done, FIELDS)
    assert np.array_equal(baseline.pareto(), done.pareto())


def test_injected_abort_then_resume_bit_identical(tmp_path):
    """kill -9 mid-sweep: the abort lands at a chunk commit boundary, so
    exactly the committed chunks survive; resume reproduces the
    uninterrupted run bit for bit."""
    store = tmp_path / "chunks"
    baseline = evaluate_design_space(GRID, A_H, A_V, engine="torch")
    with faults.injected([faults.FaultSpec("abort", match="chunk1")]) as inj:
        with pytest.raises(faults.InjectedAbortError):
            evaluate_design_space(
                GRID, A_H, A_V, engine="torch",
                sweep=SweepConfig(chunk_size=7, store=store),
            )
        assert inj.fired_kinds() == {"abort"}
    # chunks 0 and 1 committed before the abort tore the process down
    assert len(ContentStore(store, version=SWEEP_STORE_VERSION).entries()) == 2
    done = evaluate_design_space(
        GRID, A_H, A_V, engine="torch", sweep=SweepConfig(chunk_size=7, store=store)
    )
    rep = done.sweep_report
    assert rep.chunks_resumed == 2 and rep.chunks_evaluated == 1
    _assert_bit_identical(baseline, done, FIELDS)


def test_bitflip_quarantines_and_recomputes(tmp_path):
    store = tmp_path / "chunks"
    sw = lambda: SweepConfig(chunk_size=7, store=store)
    cold = evaluate_design_space(GRID, A_H, A_V, engine="torch", sweep=sw())
    with faults.injected([faults.FaultSpec("bitflip", max_fires=1)]) as inj:
        warm = evaluate_design_space(GRID, A_H, A_V, engine="torch", sweep=sw())
    assert inj.fired_kinds() == {"bitflip"}
    rep = warm.sweep_report
    assert rep.chunks_quarantined == 1
    assert rep.chunks_resumed == 2 and rep.chunks_evaluated == 1
    assert rep.failures.actions().get("quarantined:recomputed") == 1
    _assert_bit_identical(cold, warm, FIELDS)
    s = ContentStore(store, version=SWEEP_STORE_VERSION)
    assert len(s.quarantined()) == 1  # the torn entry is preserved forensics
    assert len(s.entries()) == 3  # ... and its slot was rewritten


# ---------------------------------------------------------------------------
# Guards + degradation ladder
# ---------------------------------------------------------------------------


def test_transient_poison_caught_and_degraded_to_eager():
    """A NaN poked into one engine result field is indistinguishable from a
    silent miscompute — the guard must catch it and the ladder recover."""
    with faults.injected(
        [faults.FaultSpec("nan", match="torch:bus_power_opt|chunk0", max_fires=1)]
    ) as inj:
        ev = evaluate_design_space(
            GRID, A_H, A_V, engine="torch", sweep=SweepConfig(chunk_size=7)
        )
    assert inj.fired_kinds() == {"nan"}
    rep = ev.sweep_report
    assert rep.guard_failures == 1
    assert rep.rung_counts() == {"torch": 2, "numpy": 1}
    assert rep.failures.actions().get("degraded:numpy") == 1
    for f in FIELDS:  # the poison never reached the assembled output
        assert np.isfinite(np.asarray(getattr(ev, f))).all(), f
    # the recovered chunk is the numpy evaluation of those points, bit for bit
    plain = evaluate_design_space(GRID, A_H, A_V, engine="numpy")
    idx = np.unique(_chunk_idx(0, 7, GRID.n_points))
    for f in ("bus_power_robust", "bus_power_opt"):
        got, want = np.asarray(getattr(ev, f))[..., idx], np.asarray(getattr(plain, f))[..., idx]
        assert got.tobytes() == want.tobytes(), f


def test_permanent_poison_exhausts_ladder_and_raises():
    with faults.injected(
        [faults.FaultSpec("nan", match="sweep-result")]  # every rung, forever
    ):
        with pytest.raises(GuardViolationError) as ei:
            evaluate_design_space(
                GRID, A_H, A_V, engine="torch", sweep=SweepConfig(chunk_size=7)
            )
    assert ei.value.violations  # machine-readable guard verdicts ride along
    assert any("non-finite" in s for s in ei.value.violations)


def test_on_violation_raise_surfaces_first_guard_failure():
    with faults.injected(
        [faults.FaultSpec("nan", match="torch:bus_power_opt|chunk0", max_fires=1)]
    ):
        with pytest.raises(GuardViolationError):
            evaluate_design_space(
                GRID, A_H, A_V, engine="torch",
                sweep=SweepConfig(chunk_size=7, on_violation="raise"),
            )


def test_cross_engine_mismatch_is_typed():
    """A tampered stored chunk whose fields are finite but wrong must fail
    the scalar-oracle cross-check with the typed mismatch error."""
    err = _guard_error(
        ["cross-engine:aspect_opt[0,3] vs scalar Eq. 6"], job="chunk0", stage="t"
    )
    assert isinstance(err, CrossEngineMismatchError)
    assert isinstance(err, GuardViolationError)
    err2 = _guard_error(["negative power in bus_power_opt"], job="chunk0", stage="t")
    assert isinstance(err2, GuardViolationError)
    assert not isinstance(err2, CrossEngineMismatchError)


def test_tampered_store_entry_fails_guard_and_recomputes(tmp_path):
    """Rewrite a stored chunk with finite-but-wrong physics (negative power)
    through the store's own put (valid sha) — only the guard can catch it."""
    store_dir = tmp_path / "chunks"
    sw = lambda: SweepConfig(chunk_size=7, store=store_dir)
    cold = evaluate_design_space(GRID, A_H, A_V, engine="torch", sweep=sw())
    # re-derive chunk 1's key exactly as the runner does
    w = np.full(W, 1.0 / W)
    spec = _spec_key(
        "design", GRID, A_H, A_V, w,
        extra=[
            ("cfg", repr(dataclasses.astuple(EnergyModelConfig()))),
            ("gss_iters", 64),
            ("chunk_size", 7),
            ("start_rung", "torch"),
        ],
    )
    store = ContentStore(
        store_dir, version=SWEEP_STORE_VERSION, corrupt_site="chunk-store-read"
    )
    key = _chunk_key(spec, 1)
    payload = store.get_payload(key)
    assert payload is not None, "spec key derivation drifted from the runner"
    out, _ = _decode_chunk(payload, "design", 1, FIELDS)
    out["bus_power_robust"] = -np.abs(out["bus_power_robust"])  # finite, wrong
    store.put_payload(key, _encode_chunk("design", 1, "torch", out))
    warm = evaluate_design_space(GRID, A_H, A_V, engine="torch", sweep=sw())
    rep = warm.sweep_report
    assert rep.chunks_quarantined == 1 and rep.guard_failures == 1
    assert rep.chunks_resumed == 2 and rep.chunks_evaluated == 1
    _assert_bit_identical(cold, warm, FIELDS)


def test_backend_fault_is_retried():
    with faults.injected(
        [faults.FaultSpec("backend", match="chunk1", max_fires=1)]
    ) as inj:
        ev = evaluate_design_space(
            GRID, A_H, A_V, engine="torch", sweep=SweepConfig(chunk_size=7)
        )
    assert inj.fired_kinds() == {"backend"}
    rep = ev.sweep_report
    assert rep.failures.actions().get("retried") == 1
    assert rep.rung_counts() == {"torch": 3}  # recovered on the same rung
    assert next(r for r in rep.records if r.index == 1).attempts == 2


def test_hang_evicts_device_and_resubmits():
    """A wedged simulated device: timeout -> evict -> resubmit the chunk
    once to a survivor.  The reference waits 0.5 s on healthy chunks
    (``tests/test_sweep.py``); here a healthy chunk gets 2.5 s, so a loaded
    host cannot trip the timeout on it, and the hang lasts 5 s."""
    devices = (torch.device("cpu"),) * 2  # a simulated 2-device fleet
    health = HealthMonitor(range(2))
    with faults.injected(
        [faults.FaultSpec("hang", match="sweep-chunk:d1", max_fires=1)], hang_s=5.0
    ) as inj:
        ev = evaluate_design_space(
            GRID, A_H, A_V, engine="torch",
            sweep=SweepConfig(
                chunk_size=7, timeout_s=2.5, devices=devices, health=health
            ),
        )
    assert inj.fired_kinds() == {"hang"}
    rep = ev.sweep_report
    assert rep.resubmits == 1
    assert rep.failures.actions().get("device-evicted:resubmitted") == 1
    assert health.alive_hosts() == [0]
    plain = evaluate_design_space(GRID, A_H, A_V, engine="torch")
    _assert_bit_identical(plain, ev, FIELDS)


def test_timeout_env_variable_is_the_ports_own(monkeypatch):
    """``$REPRO_TORCH_SWEEP_TIMEOUT_S`` bounds a chunk when ``timeout_s`` is
    unset; the reference's ``$REPRO_SWEEP_TIMEOUT_S`` does not reach it."""
    devices = (torch.device("cpu"),) * 2
    monkeypatch.setenv("REPRO_SWEEP_TIMEOUT_S", "1e-9")
    ev = evaluate_design_space(
        GRID, A_H, A_V, engine="torch", sweep=SweepConfig(chunk_size=7, devices=devices)
    )
    assert ev.sweep_report.resubmits == 0
    monkeypatch.setenv("REPRO_TORCH_SWEEP_TIMEOUT_S", "2.5")
    health = HealthMonitor(range(2))
    with faults.injected(
        [faults.FaultSpec("hang", match="sweep-chunk:d1", max_fires=1)], hang_s=5.0
    ):
        ev = evaluate_design_space(
            GRID, A_H, A_V, engine="torch",
            sweep=SweepConfig(chunk_size=7, devices=devices, health=health),
        )
    assert ev.sweep_report.resubmits == 1 and health.alive_hosts() == [0]


def test_cuda_engine_raises_before_any_chunk(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn, grid in ((evaluate_design_space, GRID), (evaluate_layout_space, LGRID)):
        with pytest.raises(CudaUnavailableError):
            fn(grid, A_H[:, : grid.n_points], A_V[:, : grid.n_points],
               sweep=SweepConfig(chunk_size=7, store=tmp_path / "s"))
    assert not (tmp_path / "s").exists()


# ---------------------------------------------------------------------------
# Codec + config validation
# ---------------------------------------------------------------------------


def test_chunk_codec_round_trips_every_bit_pattern():
    arr = np.asarray([np.nan, np.inf, -np.inf, -0.0, 1e-300, 7.25], np.float64)
    f32 = arr.astype(np.float32)
    out = {"a": arr.reshape(2, 3), "b": f32, "c": np.asarray([True, False])}
    enc = _encode_chunk("design", 4, "numpy", out)
    dec, rung = _decode_chunk(enc, "design", 4, ("a", "b", "c"))
    assert rung == "numpy"
    for k in out:
        assert dec[k].dtype == out[k].dtype and dec[k].shape == out[k].shape
        assert dec[k].tobytes() == out[k].tobytes()  # NaN payload bits too
    # the same payload as the reference's codec writes
    assert enc == ref_sweep._encode_chunk("design", 4, "numpy", out)
    with pytest.raises(ValueError, match="wanted"):
        _decode_chunk(enc, "design", 5, ("a", "b", "c"))
    with pytest.raises(ValueError, match="wanted"):
        _decode_chunk(enc, "layout", 4, ("a", "b", "c"))
    with pytest.raises(ValueError, match="field set"):
        _decode_chunk(enc, "design", 4, ("a", "b"))


def test_sweep_config_validation():
    with pytest.raises(ContractViolationError):
        SweepConfig(chunk_size=0)
    with pytest.raises(ContractViolationError):
        SweepConfig(on_violation="explode")
    with pytest.raises(ContractViolationError):
        SweepConfig(max_chunks=0)


# ---------------------------------------------------------------------------
# Guards have no false positives on valid inputs (property test)
# ---------------------------------------------------------------------------


@settings(deadline=None, max_examples=15)
@given(
    rows=st.sampled_from([4, 8, 16, 32]),
    cols=st.sampled_from([4, 8, 16]),
    bits=st.sampled_from([4, 8, 16]),
    seed=st.integers(0, 2**31 - 1),
    chunk=st.integers(1, 9),
)
def test_guards_no_false_positives_on_valid_grids(rows, cols, bits, seed, chunk):
    """Random valid grids + random activities must sail through every guard
    on both CPU rungs (the port holds every rung to the strict float64
    row) — a guard that cries wolf would send healthy sweeps down the
    scalar ladder."""
    space = DesignSpace(
        rows=(rows, rows * 2),
        cols=(cols,),
        input_bits=(bits,),
        dataflows=("WS", "OS"),
        bus_invert=(False, True),
    )
    grid = space.expand()
    r = np.random.default_rng(seed)
    a_h = r.uniform(0.01, 0.7, (2, grid.n_points))
    a_v = r.uniform(0.01, 0.9, (2, grid.n_points))
    for engine in ("numpy", "torch"):
        ev = evaluate_design_space(
            grid, a_h, a_v, engine=engine,
            sweep=SweepConfig(chunk_size=chunk, seed=seed),
        )
        rep = ev.sweep_report
        assert rep.guard_failures == 0
        assert rep.guard_checks == rep.chunks_total
        assert rep.rung_counts() == {engine: rep.chunks_total}


def test_report_as_dict_is_json_ready():
    ev = evaluate_design_space(
        GRID, A_H, A_V, engine="numpy", sweep=SweepConfig(chunk_size=7)
    )
    d = ev.sweep_report.as_dict()
    json.dumps(d)  # no numpy scalars / arrays leak into the report
    assert d["kind"] == "design" and d["chunks_total"] == 3
    assert d["guard_verdicts"]["pass"] == 3
    assert "3 chunks" in ev.sweep_report.summary()


# ---------------------------------------------------------------------------
# Parity with the reference's float64 sweep
# ---------------------------------------------------------------------------


def _assert_close(got, want, fields, engine):
    for f in fields:
        g, w_ = np.asarray(getattr(got, f)), np.asarray(getattr(want, f))
        assert g.shape == w_.shape, f
        if g.dtype == bool:
            assert np.array_equal(g, w_), f
            continue
        ok = np.isfinite(w_)
        assert np.array_equal(np.isfinite(g), ok), f
        rtol = GSS_ARGMIN_RTOL if (f == "aspect_opt_gss" and engine == "torch") else RTOL
        np.testing.assert_allclose(g[ok], w_[ok], rtol=rtol, atol=0, err_msg=f)


@pytest.mark.parametrize("engine,poison", [("numpy", False), ("torch", False), ("numpy", True)])
def test_design_sweep_matches_reference(tmp_path, engine, poison):
    """Chunk outputs within 1e-12 of the reference's ``use_jit=False``
    sweep, with the same report counters: clean, and with chunk 0's numpy
    (the reference's eager) rung poisoned, degraded to the scalar rung in
    both packages."""
    port_specs = [faults.FaultSpec("nan", match="numpy:bus_power_opt|chunk0", max_fires=1)]
    ref_specs = [ref_faults.FaultSpec("nan", match="eager:bus_power_opt|chunk0", max_fires=1)]
    with faults.injected(port_specs if poison else []):
        got = evaluate_design_space(GRID, A_H, A_V, engine=engine,
                                    sweep=SweepConfig(chunk_size=7, store=tmp_path / "p"))
    with ref_faults.injected(ref_specs if poison else []):
        want = ref_ds.evaluate_design_space(
            REF_GRID, A_H, A_V, use_jit=False,
            sweep=ref_sweep.SweepConfig(chunk_size=7, store=tmp_path / "r"))
    _assert_close(got, want, FIELDS, engine)
    assert _counters(got.sweep_report) == _counters(want.sweep_report)
    rung = {"eager": engine, "scalar": "scalar"}
    assert got.sweep_report.rung_counts() == {
        rung[k]: n for k, n in want.sweep_report.rung_counts().items()}
    assert (want.sweep_report.rung_counts() == {"eager": 2, "scalar": 1}) is poison


@pytest.mark.parametrize("engine", ["numpy", "torch"])
def test_layout_sweep_matches_reference(tmp_path, engine):
    la_h, la_v = A_H[:, : LGRID.n_points], A_V[:, : LGRID.n_points]
    got = evaluate_layout_space(LGRID, la_h, la_v, layouts=LAYOUTS, engine=engine,
                                sweep=SweepConfig(chunk_size=3, store=tmp_path / "p"))
    want = ref_power.evaluate_layout_space(
        REF_LGRID, la_h, la_v, layouts=LAYOUTS, use_jit=False,
        sweep=ref_sweep.SweepConfig(chunk_size=3, store=tmp_path / "r"))
    _assert_close(got, want, LFIELDS, engine)
    assert _counters(got.sweep_report) == _counters(want.sweep_report)
    resumed = evaluate_layout_space(LGRID, la_h, la_v, layouts=LAYOUTS, engine=engine,
                                    sweep=SweepConfig(chunk_size=3, store=tmp_path / "p"))
    want_resumed = ref_power.evaluate_layout_space(
        REF_LGRID, la_h, la_v, layouts=LAYOUTS, use_jit=False,
        sweep=ref_sweep.SweepConfig(chunk_size=3, store=tmp_path / "r"))
    assert _counters(resumed.sweep_report) == _counters(want_resumed.sweep_report)
