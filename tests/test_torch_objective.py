"""The port's fused fleet J/op objective (``core.objective`` over the
lowered partition and coding tables of ``layout.coeffs``) against the JAX
package, case by case from ``tests/test_objective.py``.

``evaluate_fleet_objective`` and ``fleet_static_power`` run on the port's
``"numpy"`` and ``"torch"`` engines and must agree with the reference's
float64 ``use_jit=False`` path within rtol 1e-12 on the reference's seeded
and hypothesis grids; the lowered partition and coding tables must equal
the reference's array by array (they are host float64 numpy in both); the
reference's ``jit`` cases run on ``engine="torch"`` and its ``eager`` ones
on ``"numpy"``.
"""

import numpy as np
import pytest
from _hyp import given, settings, st

import repro.core.design_space as ref_ds
import repro.core.objective as ref_obj
import repro.core.sweep as ref_sweep
import repro.core.workloads as ref_wl
import repro.layout.coeffs as ref_coeffs
from repro.runtime import faults as ref_faults
from repro_torch.core.design_space import DesignSpace
from repro_torch.core.floorplan import BusActivity
from repro_torch.core.objective import evaluate_fleet_objective, fleet_static_power
from repro_torch.core.optimize import bus_invert_activity
from repro_torch.core.sweep import SweepConfig, SweepInterrupted
from repro_torch.core.workloads import Gemm, design_pod_partition, partition_gemm
from repro_torch.layout import (
    CODING_SCHEMES,
    MultiPodLayout,
    evaluate_layout_space,
    get_layout,
    grid_coding_effective,
    layout_feasible,
    lower_coding_multipliers,
    lower_partition_coeffs,
    pod_layouts,
    segment_bus_power,
)
from repro_torch.layout.coeffs import (
    DATA_CLASS_IDX,
    DATA_IS_H,
    V_CROSS_DATA_IDX,
    V_HOP_DATA_IDX,
    lower_layout_coeffs,
)
from repro_torch.runtime import faults

RTOL = 1e-12
ENGINES = ("numpy", "torch")
OBJ_FIELDS = ("feasible", "utilization", "j_per_mac", "j_per_mac_robust", "bus_power_robust",
              "overhead_w", "aspect_robust", "aspect_opt", "bus_power_opt", "wirelength_um")


@pytest.fixture(autouse=True)
def _pin_faults():
    """Shield exact-report tests from env-armed chaos injection."""
    with faults.injected([]), ref_faults.injected([]):
        yield


GEMMS = [Gemm("a", 64, 128, 64), Gemm("b", 100, 20, 30), Gemm("c", 512, 512, 64)]
REF_GEMMS = [ref_wl.Gemm(g.name, g.m, g.k, g.n) for g in GEMMS]


def _axes(**kw):
    kw.setdefault("rows", (16, 32))
    kw.setdefault("cols", (16, 32))
    kw.setdefault("input_bits", (8,))
    kw.setdefault("dataflows", ("WS", "OS"))
    kw.setdefault("pe_area_um2", (900.0,))
    return kw


def _grids(**kw):
    """The same grid in both packages."""
    axes = _axes(**kw)
    return DesignSpace(**axes).expand(), ref_ds.DesignSpace(**axes).expand()


def _grid(**kw):
    return _grids(**kw)[0]


def _assert_matches(got, want, fields=OBJ_FIELDS, rtol=RTOL):
    for f in fields:
        g, w_ = np.asarray(getattr(got, f)), np.asarray(getattr(want, f))
        assert g.shape == w_.shape, f
        if g.dtype == bool:
            assert np.array_equal(g, w_), f
            continue
        ok = np.isfinite(w_)
        assert np.array_equal(np.isfinite(g), ok), f
        np.testing.assert_allclose(g[ok], w_[ok], rtol=rtol, atol=0, err_msg=f)


# ---------------------------------------------------------------------------
# Lowered partition arrays vs the scalar oracle (and the reference's tables)
# ---------------------------------------------------------------------------


def _check_partition_parity(axes, layouts, gemms):
    grid, ref_grid = DesignSpace(**axes).expand(), ref_ds.DesignSpace(**axes).expand()
    host = lower_partition_coeffs(grid, layouts, gemms).host
    want = ref_coeffs.lower_partition_coeffs(
        ref_grid, layouts, [ref_wl.Gemm(g.name, g.m, g.k, g.n) for g in gemms]).host
    assert sorted(host) == sorted(want)
    for k in host:
        assert np.array_equal(host[k], want[k]), k
    rows = np.asarray(grid.rows, np.int64)
    cols = np.asarray(grid.cols, np.int64)
    os_mask = np.asarray(grid.dataflow_os, bool)
    for gi, g in enumerate(gemms):
        for li, name in enumerate(layouts):
            layout = get_layout(name)
            k = layout.k if isinstance(layout, MultiPodLayout) else 1
            feas = layout_feasible(layout, rows, cols)
            for pj in range(grid.n_points):
                cell = (gi, li, pj)
                if not feas[pj] or g.macs == 0:
                    assert host["utilization"][cell] == 0.0
                    assert host["spill_words_per_mac"][cell] == 0.0
                    assert host["trunk_words_per_mac"][cell] == 0.0
                    continue
                ref = partition_gemm(
                    g, int(rows[pj]), int(cols[pj]), k=k,
                    dataflow="OS" if os_mask[pj] else "WS",
                )
                assert host["utilization"][cell] == pytest.approx(ref.utilization, rel=1e-9)
                assert host["spill_words_per_mac"][cell] == pytest.approx(
                    ref.spill_words / g.macs, rel=1e-9)
                assert host["trunk_words_per_mac"][cell] == pytest.approx(
                    ref.trunk_words / g.macs, rel=1e-9)
                assert host["ksplit"][cell] == float(ref.mode == "ksplit")


def test_lowered_partition_matches_oracle_seeded():
    rng = np.random.default_rng(77)
    for _ in range(6):
        axes = _axes(
            rows=tuple(int(8 * rng.integers(1, 9)) for _ in range(2)),
            cols=tuple(int(8 * rng.integers(1, 9)) for _ in range(2)),
        )
        gemms = [
            Gemm(f"g{i}", int(rng.integers(1, 600)), int(rng.integers(1, 600)),
                 int(rng.integers(1, 600)))
            for i in range(3)
        ]
        _check_partition_parity(axes, ("uniform", "serpentine2") + pod_layouts((2, 3, 8)), gemms)


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(min_value=0, max_value=2**31))
def test_lowered_partition_matches_oracle_hypothesis(seed):
    rng = np.random.default_rng(seed)
    axes = _axes(rows=(int(8 * rng.integers(1, 9)),), cols=(int(8 * rng.integers(1, 9)),))
    gemms = [Gemm("g", int(rng.integers(1, 2000)), int(rng.integers(1, 2000)),
                  int(rng.integers(1, 2000)))]
    _check_partition_parity(axes, ("uniform",) + pod_layouts((2, 4, 8)), gemms)


# ---------------------------------------------------------------------------
# Partition edge cases (the oracle the lowered arrays are tested against)
# ---------------------------------------------------------------------------


def test_partition_k1_identity_vs_uniform():
    g = Gemm("g", 200, 300, 150)
    p1 = partition_gemm(g, 32, 32, k=1)
    assert p1.mode == "tile" and p1.trunk_words == 0
    host = lower_partition_coeffs(_grid(), ("uniform", "pods1x1"), [g]).host
    for f in ("utilization", "spill_words_per_mac", "trunk_words_per_mac", "ksplit"):
        np.testing.assert_array_equal(host[f][:, 0], host[f][:, 1])


def test_partition_ragged_gemm_smaller_than_one_pod():
    g = Gemm("tiny", 4, 8, 4)
    for dataflow in ("WS", "OS"):
        p = partition_gemm(g, 32, 32, k=4, dataflow=dataflow)
        stream = g.k if dataflow == "OS" else g.m
        assert p.rounds == 1
        assert p.utilization == pytest.approx(g.macs / (32 * 32 * stream))
        assert p.utilization < 1.0 / 16


def test_partition_os_drain_semantics():
    g = Gemm("deep", 64, 4096, 64)
    os_ = partition_gemm(g, 32, 32, k=4, dataflow="OS")
    assert os_.mode == "tile"
    assert os_.spill_words == 0 and os_.trunk_words == 0
    assert os_.cycles == os_.rounds * g.k
    ws = partition_gemm(g, 32, 32, k=4, dataflow="WS")
    assert ws.spill_words > 0 or ws.trunk_words > 0


def test_partition_zero_mac_gemm():
    g0 = Gemm("empty", 0, 128, 64)
    p = partition_gemm(g0, 32, 32, k=2)
    assert p.utilization == 0.0 and g0.macs == 0
    host = lower_partition_coeffs(_grid(), ("uniform", "pods2x2"), [g0]).host
    for f in ("utilization", "spill_words_per_mac", "trunk_words_per_mac"):
        assert (host[f] == 0.0).all()
    grid = _grid()
    both = design_pod_partition(grid, ("uniform", "pods2x2"), [g0, GEMMS[0]])
    alone = design_pod_partition(grid, ("uniform", "pods2x2"), [GEMMS[0]])
    for f in both:
        np.testing.assert_allclose(both[f], alone[f], rtol=1e-12)


def test_partition_ksplit_trunk_accounting_k8():
    g = Gemm("deep", 512, 512, 64)
    p = partition_gemm(g, 64, 64, k=8)
    assert p.mode == "ksplit"
    want = -(-g.k // 64) * g.m * g.n * (8 - 1)
    assert p.trunk_words == want
    assert p.spill_words == (-(-g.k // 64) - 1) * g.m * g.n
    grid = _grid(rows=(64,), cols=(64,), dataflows=("WS",))
    host = lower_partition_coeffs(grid, ("pods8x8",), [g]).host
    assert host["trunk_words_per_mac"][0, 0, 0] == pytest.approx(want / g.macs, rel=1e-12)


def test_design_pod_partition_is_the_lowered_aggregation():
    grid, ref_grid = _grids()
    layouts = ("uniform",) + pod_layouts((1, 2))
    stats = design_pod_partition(grid, layouts, GEMMS)
    host = lower_partition_coeffs(grid, layouts, GEMMS).host
    w = np.asarray([g.macs for g in GEMMS], float)
    w3 = (w / w.sum())[:, None, None]
    np.testing.assert_array_equal(stats["utilization"], (w3 * host["utilization"]).sum(0))
    np.testing.assert_array_equal(
        stats["trunk_words_per_mac"], (w3 * host["trunk_words_per_mac"]).sum(0))
    want = ref_wl.design_pod_partition(ref_grid, layouts, REF_GEMMS)
    for f in want:
        assert np.array_equal(stats[f], want[f]), f


# ---------------------------------------------------------------------------
# Coding lowering
# ---------------------------------------------------------------------------


def test_coding_multipliers_match_closed_form():
    grid, ref_grid = _grids(bus_invert=(False, True))
    rng = np.random.default_rng(3)
    a_v = rng.uniform(0.05, 0.8, (2, grid.n_points))
    mult = lower_coding_multipliers(grid, a_v).host["act_mult"]
    assert np.array_equal(mult, ref_coeffs.lower_coding_multipliers(ref_grid, a_v).host["act_mult"])
    assert mult.shape == (2, len(DATA_CLASS_IDX), grid.n_points)
    bi = np.asarray(grid.bus_invert, bool)
    bits = np.asarray(grid.b_v_data, np.int64)
    is_h = DATA_IS_H.astype(bool)
    np.testing.assert_array_equal(mult[:, is_h, :], 1.0)
    for w in range(2):
        for pj in range(grid.n_points):
            want = (
                bus_invert_activity(float(a_v[w, pj]), int(bits[pj])) / float(a_v[w, pj])
                if bi[pj] else 1.0
            )
            for c in np.nonzero(~is_h)[0]:
                assert mult[w, c, pj] == pytest.approx(want, rel=1e-12)
    unc = _grid()
    assert (lower_coding_multipliers(unc, a_v).host["act_mult"] == 1.0).all()
    np.testing.assert_array_equal(grid_coding_effective(unc, a_v), a_v)


def test_coding_scheme_registry():
    assert set(CODING_SCHEMES) == {"none", "bus_invert", "zvcg"}
    a = np.asarray([0.3])
    np.testing.assert_array_equal(CODING_SCHEMES["none"](a, 8), a)
    np.testing.assert_allclose(CODING_SCHEMES["bus_invert"](a, 8), [bus_invert_activity(0.3, 8)])
    with pytest.raises(NotImplementedError, match="zero-run"):
        CODING_SCHEMES["zvcg"](a, 8)


@pytest.mark.parametrize("engine", ENGINES)
def test_bus_invert_layout_engine_parity(engine):
    grid = _grid(rows=(16,), cols=(16, 32), bus_invert=(False, True))
    a_h, a_v = 0.3, 0.45
    ev = evaluate_layout_space(grid, a_h, a_v, layouts=("uniform", "pods2x2"), engine=engine)
    bi = np.asarray(grid.bus_invert, bool)
    bits = np.asarray(grid.b_v_data, np.int64)
    for li, name in enumerate(("uniform", "pods2x2")):
        for pj in range(grid.n_points):
            if not ev.feasible[li, pj]:
                continue
            av_eff = bus_invert_activity(a_v, int(bits[pj])) if bi[pj] else a_v
            ref = segment_bus_power(
                get_layout(name), grid.geometry(pj), BusActivity(a_h, av_eff),
                float(ev.aspect_opt[0, li, pj]),
                dataflow="OS" if grid.dataflow_os[pj] else "WS",
            )
            assert float(ev.bus_power_opt[0, li, pj]) == pytest.approx(ref, rel=1e-12)


# ---------------------------------------------------------------------------
# The fused objective
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("engine", ENGINES)
def test_j_per_mac_matches_host_recombination(engine):
    """Single-GEMM fleet: j_per_mac recombines in host f64 from the eval's
    own wire-power outputs + the scalar partition oracle + the calibrated
    static split + the schema's v-class lengths — to 1e-9."""
    from repro_torch.layout.power import LayoutPowerConfig

    grid = _grid(bus_invert=(False, True))
    g = GEMMS[2]
    rng = np.random.default_rng(11)
    a_h = rng.uniform(0.1, 0.5, (1, grid.n_points))
    a_v = rng.uniform(0.1, 0.6, (1, grid.n_points))
    layouts = ("uniform", "pods2x2", "pods4x4")
    cfg = LayoutPowerConfig()
    ev = evaluate_fleet_objective(grid, a_h, a_v, [g], layouts=layouts, engine=engine)

    host = lower_partition_coeffs(grid, layouts, [g]).host
    static = fleet_static_power(grid, a_h, a_v)
    coeffs = lower_layout_coeffs(
        grid, layouts, max_envelope_aspect=cfg.max_envelope_aspect,
        repeater_spacing_um=cfg.repeater_spacing_um,
    ).host
    a_v_eff = grid_coding_effective(grid, a_v)
    pref = 0.5 * cfg.wire_cap_f_per_um * cfg.vdd**2 * cfg.freq_hz
    t_r = np.sqrt(ev.aspect_robust)
    rows = np.asarray(grid.rows, float)
    cols = np.asarray(grid.cols, float)

    def word_energy(cls_idx, hops):
        ln = (coeffs["alpha_d"][:, cls_idx] * t_r + coeffs["beta_d"][:, cls_idx] / t_r
              + coeffs["gamma_d"][:, cls_idx])
        rep = 1.0 + cfg.repeater_overhead * np.maximum(ln / cfg.repeater_spacing_um - 1.0, 0.0)
        wires = a_v_eff[0][None, :] * coeffs["width_d"][:, cls_idx]
        return hops * (pref / cfg.freq_hz) * ln * rep * wires

    e_spill = word_energy(V_HOP_DATA_IDX, 2.0 * rows[None, :])
    e_trunk = word_energy(V_CROSS_DATA_IDX, 1.0)
    util = host["utilization"][0]
    p_tot = np.asarray(ev.bus_power_robust) + np.asarray(ev.overhead_w) + static[0]
    with np.errstate(divide="ignore", invalid="ignore"):
        want = (p_tot / (cfg.freq_hz * rows * cols * util)
                + host["spill_words_per_mac"][0] * e_spill
                + host["trunk_words_per_mac"][0] * e_trunk)
    want = np.where((util > 0) & ev.feasible, want, np.inf)
    got = np.asarray(ev.j_per_mac)[0]
    m = np.isfinite(want)
    assert (np.isfinite(got) == m).all()
    np.testing.assert_allclose(got[m], want[m], rtol=1e-9)
    np.testing.assert_allclose(np.asarray(ev.j_per_mac_robust)[m], got[m], rtol=1e-12)
    np.testing.assert_array_equal(np.asarray(ev.utilization)[0], host["utilization"][0])


def test_fleet_objective_jit_matches_eager():
    """The reference's jit-vs-eager case: the port's "torch" and "numpy"
    engines, both float64, agree within 1e-12 (the reference allows its
    float32 jit 2e-4)."""
    grid = _grid(bus_invert=(False, True))
    rng = np.random.default_rng(5)
    a_h = rng.uniform(0.1, 0.4, (3, grid.n_points))
    a_v = rng.uniform(0.2, 0.6, (3, grid.n_points))
    kw = dict(layouts=("uniform", "serpentine2", "pods2x2"))
    j = evaluate_fleet_objective(grid, a_h, a_v, GEMMS, engine="torch", **kw)
    e = evaluate_fleet_objective(grid, a_h, a_v, GEMMS, engine="numpy", **kw)
    _assert_matches(j, e)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("seed", [0, 5, 11])
def test_fleet_objective_matches_reference_seeded(engine, seed):
    """The reference's seeded fleets (bus-invert on and off, three GEMMs):
    every objective field within 1e-12 of its ``use_jit=False`` path, and
    ``fleet_static_power`` too."""
    grid, ref_grid = _grids(rows=(8, 16), cols=(8, 16, 32), bus_invert=(False, True))
    rng = np.random.default_rng(seed)
    a_h = rng.uniform(0.1, 0.4, (3, grid.n_points))
    a_v = rng.uniform(0.2, 0.6, (3, grid.n_points))
    kw = dict(layouts=("uniform", "serpentine2", "pods2x2"), macs_per_token=2.5e9)
    got = evaluate_fleet_objective(grid, a_h, a_v, GEMMS, engine=engine, **kw)
    want = ref_obj.evaluate_fleet_objective(ref_grid, a_h, a_v, REF_GEMMS, use_jit=False, **kw)
    _assert_matches(got, want)
    np.testing.assert_allclose(got.j_per_token_robust[np.isfinite(want.j_per_token_robust)],
                               want.j_per_token_robust[np.isfinite(want.j_per_token_robust)],
                               rtol=RTOL)
    assert np.array_equal(got.best_layout_jpo, want.best_layout_jpo)
    np.testing.assert_allclose(fleet_static_power(grid, a_h, a_v),
                               ref_obj.fleet_static_power(ref_grid, a_h, a_v), rtol=RTOL, atol=0)


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(min_value=0, max_value=2**31))
def test_fleet_objective_matches_reference_hypothesis(seed):
    rng = np.random.default_rng(seed)
    grid, ref_grid = _grids(rows=(int(8 * rng.integers(1, 9)),),
                            cols=(int(8 * rng.integers(1, 9)), int(8 * rng.integers(1, 9))),
                            bus_invert=(False, True))
    gemms = [Gemm(f"g{i}", int(rng.integers(1, 2000)), int(rng.integers(1, 2000)),
                  int(rng.integers(1, 2000))) for i in range(2)]
    ref_gemms = [ref_wl.Gemm(g.name, g.m, g.k, g.n) for g in gemms]
    a_h = rng.uniform(0.0, 0.6, (2, grid.n_points))
    a_v = rng.uniform(0.0, 0.8, (2, grid.n_points))
    layouts = ("uniform",) + pod_layouts((2, 4))
    want = ref_obj.evaluate_fleet_objective(ref_grid, a_h, a_v, ref_gemms, layouts=layouts,
                                            use_jit=False)
    for engine in ENGINES:
        got = evaluate_fleet_objective(grid, a_h, a_v, gemms, layouts=layouts, engine=engine)
        _assert_matches(got, want)
    np.testing.assert_allclose(fleet_static_power(grid, a_h, a_v),
                               ref_obj.fleet_static_power(ref_grid, a_h, a_v), rtol=RTOL, atol=0)


def test_jpo_flips_winner_vs_bus_power():
    grid = _grid(rows=(8, 16), cols=(8, 16, 32), bus_invert=(False, True))
    rng = np.random.default_rng(0)
    a_h = rng.uniform(0.1, 0.4, (3, grid.n_points))
    a_v = rng.uniform(0.2, 0.6, (3, grid.n_points))
    ev = evaluate_fleet_objective(grid, a_h, a_v, GEMMS,
                                  layouts=("uniform", "serpentine2", "pods2x2"), engine="torch")
    assert int(np.sum(ev.best_layout != ev.best_layout_jpo)) >= 1
    util = np.asarray(ev.utilization)
    assert ((util >= 0) & (util <= 1.0 + 1e-9)).all()
    jpm = np.asarray(ev.j_per_mac)
    live = ev.feasible[None] & (util > 0)
    assert np.isfinite(jpm[live]).all() and (jpm[live] > 0).all()
    assert np.isinf(jpm[~live]).all()


def test_fleet_objective_validates_axes():
    grid = _grid()
    with pytest.raises(ValueError, match="GEMM"):
        evaluate_fleet_objective(grid, np.full((2, grid.n_points), 0.3),
                                 np.full((2, grid.n_points), 0.3), GEMMS, engine="numpy")
    with pytest.raises(ValueError, match="no gemms"):
        evaluate_fleet_objective(grid, 0.3, 0.3, [], engine="numpy")
    ev = evaluate_layout_space(grid, 0.3, 0.3, engine="numpy")
    assert ev.j_per_mac is None
    with pytest.raises(ValueError, match="J/op"):
        _ = ev.best_layout_jpo


# ---------------------------------------------------------------------------
# Objective sweeps: chunking, resume, guards
# ---------------------------------------------------------------------------


def _fleet_args():
    grid, ref_grid = _grids(rows=(8, 16), cols=(8, 16, 32), bus_invert=(False, True))
    rng = np.random.default_rng(0)
    a_h = rng.uniform(0.1, 0.4, (3, grid.n_points))
    a_v = rng.uniform(0.2, 0.6, (3, grid.n_points))
    return grid, a_h, a_v, ref_grid


SWEPT = ("feasible", "utilization", "j_per_mac", "j_per_mac_robust", "bus_power_robust",
         "overhead_w")


@pytest.mark.parametrize("engine", ENGINES)
def test_objective_sweep_chunked_resume_bit_identical(tmp_path, engine):
    grid, a_h, a_v, ref_grid = _fleet_args()
    kw = dict(layouts=("uniform", "serpentine2", "pods2x2"))
    plain = evaluate_fleet_objective(grid, a_h, a_v, GEMMS, engine=engine, **kw)
    store = tmp_path / "chunks"
    with pytest.raises(SweepInterrupted) as ei:
        evaluate_fleet_objective(
            grid, a_h, a_v, GEMMS, engine=engine, **kw,
            sweep=SweepConfig(chunk_size=7, store=store, max_chunks=2),
        )
    assert ei.value.report.chunks_evaluated == 2
    done = evaluate_fleet_objective(
        grid, a_h, a_v, GEMMS, engine=engine, **kw, sweep=SweepConfig(chunk_size=7, store=store)
    )
    rep = done.sweep_report
    assert rep.kind == "objective"
    assert rep.chunks_resumed == 2 and rep.chunks_evaluated == 2
    assert rep.rung_counts() == {engine: 4}
    for f in SWEPT:
        a, b = np.asarray(getattr(plain, f)), np.asarray(getattr(done, f))
        assert a.tobytes() == b.tobytes(), f
    np.testing.assert_array_equal(plain.best_layout_jpo, done.best_layout_jpo)
    # and within 1e-12 of the reference's float64 sweep, with its counters
    with pytest.raises(ref_sweep.SweepInterrupted):
        ref_obj.evaluate_fleet_objective(
            ref_grid, a_h, a_v, REF_GEMMS, use_jit=False, **kw,
            sweep=ref_sweep.SweepConfig(chunk_size=7, store=tmp_path / "r", max_chunks=2))
    want = ref_obj.evaluate_fleet_objective(
        ref_grid, a_h, a_v, REF_GEMMS, use_jit=False, **kw,
        sweep=ref_sweep.SweepConfig(chunk_size=7, store=tmp_path / "r"))
    _assert_matches(done, want)
    for key in ("chunks_total", "chunks_evaluated", "chunks_resumed", "guard_checks",
                "guard_failures", "resubmits"):
        assert getattr(rep, key) == getattr(want.sweep_report, key), key


def test_objective_sweep_never_aliases_layout_chunks(tmp_path):
    grid, a_h, a_v, _ = _fleet_args()
    store = tmp_path / "chunks"
    kw = dict(layouts=("uniform", "serpentine2", "pods2x2"), engine="numpy")
    evaluate_layout_space(grid, a_h, a_v, **kw, sweep=SweepConfig(chunk_size=9, store=store))
    ev = evaluate_fleet_objective(
        grid, a_h, a_v, GEMMS, **kw, sweep=SweepConfig(chunk_size=9, store=store)
    )
    assert ev.sweep_report.chunks_resumed == 0


def test_nan_poisoned_objective_chunk_trips_jop_guard():
    grid, a_h, a_v, _ = _fleet_args()
    with faults.injected(
        [faults.FaultSpec("nan", match="torch:j_per_mac|chunk0", max_fires=1)]
    ) as inj:
        ev = evaluate_fleet_objective(
            grid, a_h, a_v, GEMMS, layouts=("uniform", "serpentine2", "pods2x2"),
            engine="torch", sweep=SweepConfig(chunk_size=7),
        )
    assert inj.fired_kinds() == {"nan"}
    rep = ev.sweep_report
    assert rep.guard_failures == 1
    assert rep.failures.actions().get("degraded:numpy") == 1
    assert rep.rung_counts() == {"torch": 3, "numpy": 1}
    jpm = np.asarray(ev.j_per_mac)
    assert not np.isnan(jpm).any()
    live = ev.feasible[None] & (np.asarray(ev.utilization) > 0)
    assert np.isfinite(jpm[live]).all() and (jpm[live] > 0).all()


def test_tampered_utilization_fails_exact_passthrough_guard(tmp_path):
    import pathlib

    from repro_torch.core.store import ContentStore
    from repro_torch.core.sweep import (
        _OBJECTIVE_FIELDS,
        SWEEP_STORE_VERSION,
        _decode_chunk,
        _encode_chunk,
    )

    grid, a_h, a_v, _ = _fleet_args()
    kw = dict(layouts=("uniform", "serpentine2", "pods2x2"), engine="numpy")
    store = tmp_path / "chunks"
    evaluate_fleet_objective(grid, a_h, a_v, GEMMS, **kw,
                             sweep=SweepConfig(chunk_size=9, store=store))
    s = ContentStore(store, version=SWEEP_STORE_VERSION)
    tampered = 0
    for path in list(s.entries()):
        key = bytes.fromhex(pathlib.Path(path).stem)
        payload = s.get_payload(key)
        if payload is None or payload.get("kind") != "objective":
            continue
        out, rung = _decode_chunk(payload, "objective", payload["chunk"], _OBJECTIVE_FIELDS)
        u = out["utilization"]
        u[u > 0] = np.clip(u[u > 0] * 0.99, 0.0, 1.0)  # finite, in-range, wrong
        s.put_payload(key, _encode_chunk("objective", payload["chunk"], rung, out))
        tampered += 1
    assert tampered > 0
    warm = evaluate_fleet_objective(grid, a_h, a_v, GEMMS, **kw,
                                    sweep=SweepConfig(chunk_size=9, store=store))
    rep = warm.sweep_report
    assert rep.guard_failures >= tampered
    assert rep.chunks_quarantined == tampered and rep.chunks_resumed == 0
