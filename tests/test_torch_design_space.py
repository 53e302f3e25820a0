"""The port's design-space engine against the JAX package.

The same seeded grids and activities go through the reference's
``repro.core.design_space`` (its float64 ``use_jit=False`` path, and once
its jitted float32 path) and the port's, on the ``"numpy"`` engine (float64
numpy) and the ``"torch"`` engine (float64 tensors on the CPU).  Every field
agrees within rtol 1e-12, except the golden-section cross-check
``aspect_opt_gss``: a float64 argmin of a smooth minimum is set only to
about sqrt(eps), so the last bits by which torch's ``exp`` differs from
numpy's move it by up to ~1e-8; it is held within 1e-7, and the power
shape at it within 1e-12.  The port's own cases mirror
``tests/test_design_space.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch
from _hyp import given, settings, st

import repro.core.design_space as ref_ds
import repro.core.workloads as ref_wl
from repro_torch.core import design_space as ds
from repro_torch.core import workloads as wl
from repro_torch.core.design_space import (
    DesignSpace,
    evaluate_design_space,
    pareto_mask,
    sweep_bus_power,
)
from repro_torch.core.energy import power_breakdown
from repro_torch.core.floorplan import (
    ASPECT_MAX,
    ASPECT_MIN,
    BusActivity,
    accumulator_width,
    bus_power,
    optimal_aspect_power,
)
from repro_torch.core.optimize import _power_shape, bus_invert_activity, max_regret
from repro_torch.core.sweep import SweepConfig
from repro_torch.core.switching import clear_profile_cache
from repro_torch.kernels._engine import CudaUnavailableError

RTOL = 1e-12
GSS_ARGMIN_RTOL = 1e-7
ENGINES = ("numpy", "torch")

AXES = dict(
    rows=(8, 32),
    cols=(8, 16),
    input_bits=(8, 16),
    dataflows=("WS", "OS"),
    bus_invert=(False, True),
    pe_area_um2=(900.0, 1200.0),
)
SPACE = DesignSpace(**AXES)
GRID = SPACE.expand()
REF_GRID = ref_ds.DesignSpace(**AXES).expand()

_rng = np.random.default_rng(7)
W = 3
A_H = np.broadcast_to(_rng.uniform(0.1, 0.4, (W, 1)), (W, GRID.n_points)).copy()
A_V = np.broadcast_to(_rng.uniform(0.2, 0.6, (W, 1)), (W, GRID.n_points)).copy()
# Distinct activities per point, for the parity tests.
A_H2 = _rng.uniform(0.0, 0.5, (W, GRID.n_points))
A_V2 = _rng.uniform(0.0, 0.7, (W, GRID.n_points))
A_H2[0, :4] = 0.0
A_V2[1, 2:6] = 0.0

EVAL_FIELDS = tuple(
    f.name for f in dataclasses.fields(ref_ds.DesignSpaceEval)
    if f.name not in ("grid", "sweep_report")
)


def _oracle_pareto(obj):
    le = (obj[:, None, :] <= obj[None, :, :]).all(-1)
    lt = (obj[:, None, :] < obj[None, :, :]).any(-1)
    return ~(le & lt).any(axis=0)


def _tiny_layers(pkg=wl):
    return [
        pkg.ConvLayer("T1", k=1, h=8, w=8, c=48, m=24, input_density=0.5),
        pkg.ConvLayer("T2", k=1, h=6, w=6, c=64, m=32, input_density=0.4),
    ]


# --- expansion ---------------------------------------------------------------


def test_expand_cross_product_and_bus_widths():
    assert SPACE.n_points == GRID.n_points == 2**6
    for i in range(GRID.n_points):
        r, bits = int(GRID.rows[i]), int(GRID.b_h[i])
        want_data = bits if GRID.dataflow_os[i] else accumulator_width(bits, r)
        assert int(GRID.b_v_data[i]) == want_data
        assert int(GRID.b_v[i]) == want_data + int(GRID.bus_invert[i])
    combos = set(
        zip(GRID.rows, GRID.cols, GRID.b_h, GRID.dataflow_os, GRID.bus_invert, GRID.pe_area_um2)
    )
    assert len(combos) == GRID.n_points
    for f in dataclasses.fields(ref_ds.DesignGrid):
        got, want = getattr(GRID, f.name), getattr(REF_GRID, f.name)
        assert np.array_equal(got, want) and np.asarray(got).dtype == np.asarray(want).dtype


def test_scalar_axes_auto_promote():
    sp = DesignSpace(rows=32, cols=32, input_bits=16)
    assert sp.rows == (32,) and sp.n_points == 1
    g = sp.expand()
    assert int(g.b_v[0]) == accumulator_width(16, 32)
    assert g.geometry(0).b_v == int(g.b_v[0])
    assert g.describe(0) == "32x32 b16 Bv=37"
    assert [GRID.describe(i) for i in range(GRID.n_points)] == [
        REF_GRID.describe(i) for i in range(GRID.n_points)
    ]
    sel = np.asarray(GRID.bus_invert)
    assert np.array_equal(GRID.select(sel).b_v, REF_GRID.select(sel).b_v)


@pytest.mark.parametrize("kwargs", [
    dict(rows=(0,), cols=(8,)),
    dict(rows=(8,), cols=(8,), dataflows=("XX",)),
    dict(rows=(2**30,), cols=(8,), input_bits=(32,)),
    dict(rows=(8,), cols=(8,), layouts=("nope",)),
    dict(rows=(8,), cols=(8,), aspect_lo=2.0, aspect_hi=1.0),
])
def test_expand_validation(kwargs):
    with pytest.raises(ValueError):
        DesignSpace(**kwargs)
    with pytest.raises(ValueError):
        ref_ds.DesignSpace(**kwargs)


# --- evaluation against the reference ------------------------------------------


def _assert_eval_matches(got, want, rtol=RTOL):
    for name in EVAL_FIELDS:
        g, w = np.asarray(getattr(got, name), float), np.asarray(getattr(want, name), float)
        assert g.shape == w.shape, name
        if name == "aspect_opt_gss":
            np.testing.assert_allclose(g, w, rtol=GSS_ARGMIN_RTOL, err_msg=name)
            continue
        np.testing.assert_allclose(g, w, rtol=rtol, atol=0, err_msg=name)


@pytest.mark.parametrize("engine", ENGINES)
def test_eval_matches_reference_float64(engine):
    got = evaluate_design_space(GRID, A_H2, A_V2, weights=[1.0, 2.0, 0.5], engine=engine)
    want = ref_ds.evaluate_design_space(REF_GRID, A_H2, A_V2, weights=[1.0, 2.0, 0.5], use_jit=False)
    _assert_eval_matches(got, want)
    # the golden-section argmins differ only inside the objective's flat
    # basin: the power shape at either argmin agrees to float64 round-off
    b_h, b_v = GRID.b_h.astype(float), GRID.b_v.astype(float)
    at_got = _power_shape(b_h, b_v, A_H2, got.a_v_eff, got.aspect_opt_gss, np)
    at_want = _power_shape(b_h, b_v, A_H2, got.a_v_eff, want.aspect_opt_gss, np)
    np.testing.assert_allclose(at_got, at_want, rtol=RTOL)


def test_eval_matches_reference_jit_within_its_tolerances():
    """The reference's jitted float32 program against the port's float64
    torch program, at the tolerances the reference holds its jit path to."""
    ev_t = evaluate_design_space(GRID, A_H, A_V, engine="torch")
    ev_j = ref_ds.evaluate_design_space(REF_GRID, A_H, A_V, use_jit=True)
    assert np.allclose(ev_j.aspect_opt, ev_t.aspect_opt, rtol=1e-4)
    assert np.allclose(ev_j.bus_power_opt, ev_t.bus_power_opt, rtol=1e-4)
    assert np.allclose(ev_j.aspect_robust, ev_t.aspect_robust, rtol=1e-3)
    assert np.allclose(ev_j.max_regret, ev_t.max_regret, rtol=1e-2, atol=1e-5)
    assert np.allclose(ev_j.bus_power_robust, ev_t.bus_power_robust, rtol=1e-4)
    assert np.allclose(ev_j.interconnect_saving, ev_t.interconnect_saving, atol=1e-4)
    assert np.allclose(ev_j.total_saving, ev_t.total_saving, atol=1e-4)


@pytest.mark.parametrize("engine", ENGINES)
def test_eval_matches_scalar_api_pointwise(engine):
    ev = evaluate_design_space(GRID, A_H, A_V, engine=engine)
    grid_aspects = np.exp(np.linspace(np.log(ASPECT_MIN), np.log(ASPECT_MAX), 801))
    for i in (0, 13, 42, GRID.n_points - 1):
        geom = GRID.geometry(i)
        acts = []
        for w in range(W):
            a_v_eff = (
                bus_invert_activity(float(A_V[w, i]), int(GRID.b_v_data[i]))
                if GRID.bus_invert[i]
                else float(A_V[w, i])
            )
            assert float(ev.a_v_eff[w, i]) == pytest.approx(a_v_eff, rel=1e-12)
            act = BusActivity(float(A_H[w, i]), a_v_eff)
            acts.append(act)
            assert float(ev.aspect_opt[w, i]) == pytest.approx(optimal_aspect_power(geom, act), rel=1e-15)
            assert float(ev.bus_power_opt[w, i]) == pytest.approx(
                bus_power(geom, act, float(ev.aspect_opt[w, i])), rel=1e-12
            )
            assert float(ev.bus_power_sym[w, i]) == pytest.approx(bus_power(geom, act, 1.0), rel=1e-12)
        assert np.allclose(ev.aspect_opt_gss[:, i], ev.aspect_opt[:, i], rtol=1e-6)
        mr = float(ev.max_regret[i])
        assert mr == pytest.approx(
            max_regret(geom, acts, float(ev.aspect_robust[i])), rel=1e-9, abs=1e-12
        )
        assert mr <= min(max_regret(geom, acts, float(a)) for a in grid_aspects) + 1e-7
        assert float(ev.bus_power_square[i]) == pytest.approx(
            np.mean([bus_power(geom, a, 1.0) for a in acts]), rel=1e-12
        )
        assert float(ev.area_um2[i]) == pytest.approx(
            geom.rows * geom.cols * geom.pe_area_um2, rel=1e-12
        )


@pytest.mark.parametrize("engine", ENGINES)
def test_eval_savings_match_energy_model(engine):
    ev = evaluate_design_space(GRID, A_H, A_V, engine=engine)
    for i in (0, 13, GRID.n_points - 1):
        geom = GRID.geometry(i)
        robust = float(ev.aspect_robust[i])
        sym_i = asym_i = comp = 0.0
        for w in range(W):
            act = BusActivity(float(A_H[w, i]), float(ev.a_v_eff[w, i]))
            b_sym = power_breakdown(geom, act, 1.0)
            b_asym = power_breakdown(geom, act, robust)
            sym_i += b_sym.interconnect_w
            asym_i += b_asym.interconnect_w
            comp += b_sym.compute_w
        assert float(ev.interconnect_saving[i]) == pytest.approx(1.0 - asym_i / sym_i, rel=1e-9)
        assert float(ev.total_saving[i]) == pytest.approx(
            1.0 - (asym_i + comp) / (sym_i + comp), rel=1e-9
        )


@pytest.mark.parametrize("engine", ENGINES)
def test_eval_activity_broadcasting_and_weights(engine):
    ev_s = evaluate_design_space(GRID, 0.22, 0.36, engine=engine)
    assert ev_s.aspect_opt.shape == (1, GRID.n_points)
    ev_p = evaluate_design_space(
        GRID, np.full(GRID.n_points, 0.22), np.full(GRID.n_points, 0.36), engine=engine
    )
    assert np.allclose(ev_s.aspect_opt, ev_p.aspect_opt)
    ev_one = evaluate_design_space(GRID, A_H[:1], A_V[:1], engine=engine)
    ev_wt = evaluate_design_space(GRID, A_H, A_V, weights=[1.0, 0.0, 0.0], engine=engine)
    assert np.allclose(ev_wt.bus_power_square, ev_one.bus_power_square)
    with pytest.raises(ValueError):
        evaluate_design_space(GRID, A_H, A_V, weights=[1.0], engine=engine)
    with pytest.raises(ValueError):
        evaluate_design_space(GRID, 1.5, 0.3, engine=engine)


@pytest.mark.parametrize("engine", ENGINES)
def test_sweep_matches_scalar_bus_power_and_reference(engine):
    aspects = np.exp(np.linspace(np.log(ASPECT_MIN), np.log(ASPECT_MAX), 9))
    a_h, a_v = A_H2.mean(axis=0), A_V2.mean(axis=0)
    surf = sweep_bus_power(GRID, a_h, a_v, aspects, engine=engine)
    assert surf.shape == (GRID.n_points, len(aspects))
    want = ref_ds.sweep_bus_power(REF_GRID, a_h, a_v, aspects, use_jit=False)
    np.testing.assert_allclose(surf, want, rtol=RTOL, atol=0)
    for i in (0, 7, GRID.n_points - 1):
        geom = GRID.geometry(i)
        a_v_eff = (
            bus_invert_activity(float(a_v[i]), int(GRID.b_v_data[i]))
            if GRID.bus_invert[i]
            else float(a_v[i])
        )
        act = BusActivity(float(a_h[i]), a_v_eff)
        for s, asp in enumerate(aspects):
            assert float(surf[i, s]) == pytest.approx(bus_power(geom, act, float(asp)), rel=1e-12)


def test_engines_and_sweep_contracts(monkeypatch):
    with pytest.raises(ValueError, match="unknown engine"):
        evaluate_design_space(GRID, A_H, A_V, engine="jax")
    plain = evaluate_design_space(GRID, A_H, A_V, engine="numpy")
    swept = evaluate_design_space(GRID, A_H, A_V, engine="numpy",
                                  sweep=SweepConfig(chunk_size=GRID.n_points // 3))
    assert plain.sweep_report is None and swept.sweep_report.chunks_total == 4
    assert swept.sweep_report.rung_counts() == {"numpy": 4}
    for field in EVAL_FIELDS:
        assert np.array_equal(getattr(plain, field), getattr(swept, field)), field
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(CudaUnavailableError):
        evaluate_design_space(GRID, A_H, A_V)
    with pytest.raises(CudaUnavailableError):
        sweep_bus_power(GRID, 0.2, 0.3, [1.0])


# --- Pareto extraction -----------------------------------------------------------


def test_pareto_mask_matches_oracle_random():
    r = np.random.default_rng(3)
    for n, d in ((1, 2), (40, 2), (301, 3), (1500, 3), (97, 4)):
        obj = r.random((n, d)).round(2)
        got = pareto_mask(obj, chunk=64)
        assert np.array_equal(got, _oracle_pareto(obj)), (n, d)
        assert np.array_equal(got, ref_ds.pareto_mask(obj, chunk=64))


def test_pareto_mask_edges():
    assert pareto_mask(np.zeros((0, 3))).shape == (0,)
    assert pareto_mask(np.ones((5, 2))).all()
    obj = np.vstack([np.ones((5, 2)), [[0.5, 0.5]]])
    assert pareto_mask(obj).tolist() == [False] * 5 + [True]
    assert pareto_mask(np.asarray([[np.inf, 0.0]])).tolist() == [False]
    assert not pareto_mask(np.full((3, 2), np.nan)).any()
    with pytest.raises(ValueError):
        pareto_mask(np.zeros(3))


def test_pareto_mask_poisoned_cells_excluded():
    r = np.random.default_rng(11)
    obj = r.random((120, 3))
    poison = r.random(120) < 0.25
    rows = np.flatnonzero(poison)
    vals = np.asarray([np.nan, np.inf, -np.inf])
    obj[rows, r.integers(0, 3, rows.size)] = vals[r.integers(0, 3, rows.size)]
    got = pareto_mask(obj, chunk=32)
    assert not got[poison].any()
    want = np.zeros(120, bool)
    want[~poison] = _oracle_pareto(obj[~poison])
    assert np.array_equal(got, want)
    assert not pareto_mask(np.asarray([[-np.inf, 0.0], [1.0, 1.0]]))[0]


@settings(deadline=None, max_examples=30)
@given(
    data=st.lists(
        st.tuples(st.integers(0, 5), st.integers(0, 5), st.integers(0, 5)),
        min_size=1,
        max_size=60,
    )
)
def test_pareto_mask_matches_oracle_hypothesis(data):
    obj = np.asarray(data, float)
    assert np.array_equal(pareto_mask(obj, chunk=7), _oracle_pareto(obj))


@pytest.mark.parametrize("engine", ENGINES)
def test_eval_pareto_is_nonempty_and_nondominated(engine):
    ev = evaluate_design_space(GRID, A_H2, A_V2, engine=engine)
    mask = ev.pareto()
    assert mask.any()
    assert np.array_equal(mask, _oracle_pareto(ev.objectives()))
    assert ev.grid.select(mask).n_points == int(mask.sum())
    want = ref_ds.evaluate_design_space(REF_GRID, A_H2, A_V2, use_jit=False)
    assert np.array_equal(mask, want.pareto())
    names = ("bus_energy_per_mac_j", "neg_macs_per_cycle")
    assert np.array_equal(ev.pareto(names), want.pareto(names))


# --- measured activities (tiny layers, through run_profile_batch) ---------------


def test_measured_activities_map_classes_onto_grid():
    """One job per (rows, b_h, b_v_data) class per layer, cols- and
    coding-invariant; the reference's activities and scheduler statistics."""
    axes = dict(rows=(4, 8), cols=(4, 8, 16), input_bits=(8,), bus_invert=(False, True))
    grid = DesignSpace(**axes).expand()
    layers = _tiny_layers()
    clear_profile_cache()
    a_h, a_v, stats = wl.measured_design_activities(
        grid, layers, backend="torch", return_stats=True
    )
    assert a_h.shape == a_v.shape == (len(layers), grid.n_points)
    assert (0 <= a_h).all() and (a_h <= 1).all() and (0 <= a_v).all() and (a_v <= 1).all()
    assert stats.jobs == 2 * len(layers) and stats.serial_fallbacks == 0
    for c in (8, 16):
        assert np.array_equal(a_h[:, grid.cols == 4], a_h[:, grid.cols == c])
        assert np.array_equal(a_v[:, grid.cols == 4], a_v[:, grid.cols == c])
    for r in (4, 8):
        sel = np.asarray(grid.rows == r)
        for i, layer in enumerate(layers):
            p = wl.profile_conv_layer(layer, rows=r, cols=4, bits=8, seed=i, backend="torch")
            assert np.array_equal(a_h[i, sel], np.full(sel.sum(), p.a_h))
            assert np.array_equal(a_v[i, sel], np.full(sel.sum(), p.a_v))
    ref_grid = ref_ds.DesignSpace(**axes).expand()
    r_h, r_v, r_stats = ref_wl.measured_design_activities(
        ref_grid, _tiny_layers(ref_wl), use_cache=False, return_stats=True
    )
    assert np.array_equal(a_h, r_h) and np.array_equal(a_v, r_v)
    fields = ("jobs", "passes", "pass_reuse", "buckets", "tasks", "strips", "serial_fallbacks")
    assert {f: getattr(stats, f) for f in fields} == {f: getattr(r_stats, f) for f in fields}
    clear_profile_cache()


def test_measured_activities_os_points_are_measured():
    grid = DesignSpace(rows=(4, 8), cols=(4,), input_bits=(8,), dataflows=("WS", "OS")).expand()
    layers = _tiny_layers()[:1]
    a_h, a_v, stats = wl.measured_design_activities(
        grid, layers, backend="torch", use_cache=False, return_stats=True
    )
    os_sel = np.asarray(grid.dataflow_os)
    assert not np.array_equal(a_v[:, os_sel], a_h[:, os_sel])
    assert not np.array_equal(a_h[:, os_sel], a_h[:, ~os_sel])
    assert np.unique(a_v[:, os_sel], axis=1).shape[1] == 1
    assert stats.jobs == 3 * len(layers)
    p = wl.profile_conv_layer(layers[0], rows=4, cols=4, bits=8, seed=0, dataflow="OS",
                              backend="numpy", use_cache=False)
    assert np.allclose(a_h[0, os_sel], p.a_h)
    assert np.allclose(a_v[0, os_sel], p.a_v)
    r_h, r_v = ref_wl.measured_design_activities(
        ref_ds.DesignSpace(rows=(4, 8), cols=(4,), input_bits=(8,), dataflows=("WS", "OS")).expand(),
        _tiny_layers(ref_wl)[:1], use_cache=False,
    )
    assert np.array_equal(a_h, r_h) and np.array_equal(a_v, r_v)


@pytest.mark.parametrize("engine", ENGINES)
def test_measured_end_to_end_evaluation(engine):
    """Measured activities -> the evaluator -> a non-empty Pareto frontier,
    the reference's frontier."""
    axes = dict(rows=(4, 8), cols=(4, 16), input_bits=(8,), bus_invert=(False, True))
    grid = DesignSpace(**axes).expand()
    a_h, a_v = wl.measured_design_activities(grid, _tiny_layers(), backend="numpy", use_cache=False)
    ev = evaluate_design_space(grid, a_h, a_v, engine=engine)
    assert np.isfinite(ev.bus_power_robust).all()
    assert (ev.max_regret >= -1e-12).all()
    assert ev.pareto().any()
    bi = np.asarray(grid.bus_invert)
    pts = np.lexsort((bi, np.asarray(grid.cols), np.asarray(grid.rows))).reshape(-1, 2)
    for plain, coded in pts:
        assert (ev.a_v_eff[:, coded] <= ev.a_v_eff[:, plain] + 1e-12).all()
    want = ref_ds.evaluate_design_space(ref_ds.DesignSpace(**axes).expand(), a_h, a_v, use_jit=False)
    _assert_eval_matches(ev, want)
    assert np.array_equal(ev.pareto(), want.pareto())


def test_measured_gemm_activities_match_reference():
    """The serving adapter: content-keyed seeds, clipped operand classes
    deduplicated, the reference's activities."""
    axes = dict(rows=(4, 8), cols=(4,), input_bits=(8,), dataflows=("WS", "OS"))
    grid = DesignSpace(**axes).expand()
    gemms = [wl.Gemm("a", 40, 24, 16), wl.Gemm("b", 40, 24, 16), wl.Gemm("c", 300, 700, 20)]
    ref_gemms = [ref_wl.Gemm(g.name, g.m, g.k, g.n) for g in gemms]
    for g, rg in zip(gemms, ref_gemms):
        assert wl.gemm_profile_seed(g) == ref_wl.gemm_profile_seed(rg)
        assert wl.gemm_profile_seed(g, clip=None, density=0.5) == ref_wl.gemm_profile_seed(
            rg, clip=None, density=0.5)
    a_h, a_v, stats = wl.measured_design_gemm_activities(
        grid, gemms, densities=[None, None, 0.5], backend="torch", use_cache=False,
        return_stats=True,
    )
    assert a_h.shape == (3, grid.n_points)
    assert np.array_equal(a_h[0], a_h[1]) and np.array_equal(a_v[0], a_v[1])
    assert stats.jobs == 3 * 2  # 3 classes x 2 unique operand classes
    r_h, r_v = ref_wl.measured_design_gemm_activities(
        ref_ds.DesignSpace(**axes).expand(), ref_gemms, densities=[None, None, 0.5],
        use_cache=False,
    )
    assert np.array_equal(a_h, r_h) and np.array_equal(a_v, r_v)
    with pytest.raises(ValueError):
        wl.measured_design_gemm_activities(grid, [])
    with pytest.raises(ValueError):
        wl.measured_design_gemm_activities(grid, gemms, seeds=[1])
    job = wl.gemm_job(gemms[2], 8, 4, 8, seed=3, density=0.5)
    ref_job = ref_wl.gemm_job(ref_gemms[2], 8, 4, 8, seed=3, density=0.5)
    assert job.shape == ref_job.shape == (128, 512, 20)
    (a, w), (ra, rw) = job.operands(), ref_job.operands()
    assert np.array_equal(a, ra) and np.array_equal(w, rw)


def test_activity_classes_match_reference():
    classes, idx = wl._activity_classes(GRID)
    r_classes, r_idx = ref_wl._activity_classes(REF_GRID)
    assert classes == r_classes and np.array_equal(idx, r_idx)
    assert ds.ENGINES == ("cuda", "torch", "numpy")
