"""The port's segment-level layout engine against the JAX package:
geometry, segments, the coefficient lowering and the batched evaluator.

Host tables (placements, segment lists, class coefficients, the lowered
coefficient, partition and coding tables) are float64 numpy in both
packages and must be equal array by array.  The evaluator runs on the
port's ``"numpy"`` and ``"torch"`` engines and must agree with the
reference's float64 ``use_jit=False`` path within rtol 1e-12, and with its
jitted float32 path within the reference's own tolerances.  The port's own
cases mirror ``tests/test_layout.py`` and ``tests/test_coeffs.py``.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch
from _hyp import given, settings, st

import repro.core.design_space as ref_ds
import repro.core.workloads as ref_wl
import repro.layout as RL
import repro.layout.geometry as ref_geo
import repro.layout.power as ref_power
from repro_torch.core import workloads as wl
from repro_torch.core.design_space import DesignSpace, evaluate_layout_design_space
from repro_torch.core.floorplan import (
    BusActivity,
    SystolicArrayGeometry,
    bus_power,
    bus_power_arr,
    optimal_aspect_power,
    optimal_aspect_power_arr,
    pe_dims_arr,
    wirelength_total,
    wirelength_total_arr,
)
from repro_torch.core.sweep import SweepConfig
from repro_torch.core.workloads import Gemm, design_pod_partition, partition_gemm
from repro_torch.kernels._engine import CudaUnavailableError
from repro_torch.layout import (
    LAYOUTS,
    LayoutPowerConfig,
    MultiPodLayout,
    ObjectiveSpec,
    SerpentineLayout,
    UniformLayout,
    clear_coeff_cache,
    coeff_cache_info,
    enumerate_segments,
    evaluate_layout_space,
    get_layout,
    grid_coding_effective,
    lower_coding_multipliers,
    lower_layout_coeffs,
    lower_partition_coeffs,
    pod_layouts,
    rollup_segments,
    segment_bus_power,
    segment_class_coeffs,
    segment_wirelength,
    set_coeff_cache_capacity,
)
from repro_torch.layout import coeffs as coeffs_mod
from repro_torch.layout.geometry import (
    clock_tree_coeffs,
    clock_tree_depth,
    envelope,
    htree_segments,
    layout_feasible,
    place_pes,
    register_layout,
)
from repro_torch.layout.segments import SEGMENT_CLASS_SCHEMA

RTOL = 1e-12
ENGINES = ("numpy", "torch")
GEOM = SystolicArrayGeometry.paper_32x32()
ACT = BusActivity.paper_resnet50()
EVAL_FIELDS = ("aspect_opt", "bus_power_opt", "aspect_robust", "bus_power_robust",
               "overhead_w", "wirelength_um")


def _both(**axes):
    return DesignSpace(**axes).expand(), ref_ds.DesignSpace(**axes).expand()


def _assert_close(got, want, rtol=RTOL):
    got, want = np.asarray(got, float), np.asarray(want, float)
    ok = np.isfinite(want)
    assert got.shape == want.shape and (np.isfinite(got) == ok).all()
    np.testing.assert_allclose(got[ok], want[ok], rtol=rtol, atol=0)


# --- registry and placement -------------------------------------------------------


def test_registry_families():
    assert isinstance(LAYOUTS["uniform"], UniformLayout)
    assert isinstance(LAYOUTS["serpentine2"], SerpentineLayout)
    assert isinstance(LAYOUTS["pods4x4"], MultiPodLayout)
    assert {k: repr(v) for k, v in LAYOUTS.items()} == {k: repr(v) for k, v in RL.LAYOUTS.items()}
    register_layout("serpentine8", SerpentineLayout(folds=8))
    try:
        assert LAYOUTS["serpentine8"].folds == 8
    finally:
        del LAYOUTS["serpentine8"]
    with pytest.raises(TypeError):
        register_layout("bad", object())
    with pytest.raises(ValueError):
        SerpentineLayout(folds=1)
    assert isinstance(MultiPodLayout(k=1), MultiPodLayout)
    with pytest.raises(ValueError):
        MultiPodLayout(k=0)
    assert pod_layouts((1, 3)) == ("pods1x1", "pods3x3")
    assert get_layout("pods3x3") == MultiPodLayout(k=3)
    with pytest.raises(KeyError):
        get_layout("pods2x3")


def test_feasibility_divisibility():
    assert layout_feasible(LAYOUTS["serpentine2"], 8, 10)
    assert not layout_feasible(LAYOUTS["serpentine2"], 8, 9)
    assert not layout_feasible(LAYOUTS["pods2x2"], 7, 8)
    got = layout_feasible(LAYOUTS["pods4x4"], np.asarray([8, 9]), np.asarray([8, 8]))
    assert got.tolist() == [True, False]
    with pytest.raises(ValueError):
        place_pes(LAYOUTS["serpentine2"], 4, 9, 10.0, 10.0)


@pytest.mark.parametrize("name", ["uniform", "serpentine2", "serpentine4", "pods2x2", "pods4x4"])
def test_placement_and_envelope_match_reference(name):
    for rows, cols, w, h in ((8, 16, 10.0, 20.0), (16, 8, 7.5, 3.0)):
        x, y = place_pes(get_layout(name), rows, cols, w, h)
        rx, ry = ref_geo.place_pes(ref_geo.get_layout(name), rows, cols, w, h)
        assert np.array_equal(x, rx) and np.array_equal(y, ry)
        assert envelope(get_layout(name), rows, cols, w, h) == ref_geo.envelope(
            ref_geo.get_layout(name), rows, cols, w, h)


def test_serpentine_placement_folds_and_turnarounds():
    rows, cols, f, w, h = 4, 8, 2, 10.0, 20.0
    x, y = place_pes(SerpentineLayout(folds=f), rows, cols, w, h)
    assert x[0, :4].tolist() == [0.0, 10.0, 20.0, 30.0]
    assert x[0, 4:].tolist() == [30.0, 20.0, 10.0, 0.0]
    assert (y[:, 4] - y[:, 3] == rows * h).all()
    assert envelope(SerpentineLayout(folds=f), rows, cols, w, h) == ((cols / f) * w, f * rows * h)
    segs = enumerate_segments("serpentine2", rows, cols, 8, 20, 200.0, 1.0)
    turns = segs.select((segs.net == "h") & (segs.kind == "turn"))
    assert turns.n_segments == rows * (f - 1)
    hpe = float(pe_dims_arr(200.0, 1.0, xp=np)[1])
    np.testing.assert_allclose(turns.length, rows * hpe)


def test_multipod_placement_gutters_and_widths():
    rows = cols = 8
    lay = MultiPodLayout(k=2, gutter_um=30.0)
    register_layout("podstest", lay)
    try:
        w, h = (float(v) for v in pe_dims_arr(400.0, 1.0, xp=np))
        x, y = place_pes(lay, rows, cols, w, h)
        assert x[0, 4] - x[0, 3] == pytest.approx(w + 30.0)
        assert y[4, 0] - y[3, 0] == pytest.approx(h + 30.0)
        segs = enumerate_segments("podstest", rows, cols, 16, 37, 400.0, 1.0)
        v = segs.for_net("v")
        trunks = v.select(v.kind == "trunk")
        assert trunks.n_segments == cols * (lay.k - 1)
        np.testing.assert_allclose(trunks.length, h + 30.0)
        assert (trunks.width == 37).all()
        assert (v.select(v.kind == "hop").width == 34).all()
        segs_os = enumerate_segments("podstest", rows, cols, 16, 16, 400.0, 1.0, dataflow="OS")
        assert (segs_os.for_net("v").width == 16).all()
        assert segs_os.for_net("drain").n_segments == rows * cols
        assert segs.for_net("preload").n_segments == rows * cols
        assert segs_os.for_net("preload").n_segments == 0
    finally:
        del LAYOUTS["podstest"]


def test_htree_total_length_matches_coeffs():
    for depth in (1, 2, 5, 8):
        segs = htree_segments(0.0, 0.0, 120.0, 70.0, depth)
        assert len(segs) == 2**depth - 1
        assert segs == ref_geo.htree_segments(0.0, 0.0, 120.0, 70.0, depth)
        tot = sum(abs(x1 - x0) + abs(y1 - y0) for x0, y0, x1, y1 in segs)
        cw, ch = clock_tree_coeffs(depth)
        assert tot == pytest.approx(float(cw) * 120.0 + float(ch) * 70.0)
    assert int(clock_tree_depth(1024)) == 10
    assert int(clock_tree_depth(1025)) == 11


# --- segments: explicit enumeration vs class coefficients, vs the reference --------


@pytest.mark.parametrize("name", sorted(RL.LAYOUTS))
@pytest.mark.parametrize("dataflow", ["WS", "OS"])
def test_explicit_matches_class_coeffs(name, dataflow):
    rows, cols, b_h = 16, 32, 16
    b_v = 37 if dataflow == "WS" else 16
    aspect = 2.7
    segs = enumerate_segments(name, rows, cols, b_h, b_v, 1200.0, aspect, dataflow=dataflow)
    ref_segs = RL.enumerate_segments(name, rows, cols, b_h, b_v, 1200.0, aspect, dataflow=dataflow)
    for f in dataclasses.fields(segs):
        assert np.array_equal(getattr(segs, f.name), getattr(ref_segs, f.name)), f.name
    args = [np.asarray([float(v)]) for v in (rows, cols, b_h, b_v)] + [np.asarray([dataflow == "OS"])]
    cc = segment_class_coeffs(name, *args)
    ref_cc = RL.segment_class_coeffs(name, *args)
    assert cc.keys() == ref_cc.keys()
    for key in cc:
        assert np.array_equal(cc[key], ref_cc[key]), key
    w, h = pe_dims_arr(1200.0, aspect, xp=np)
    ln = cc["len_w"] * w + cc["len_h"] * h + cc["len_c"]
    for net in ("h", "v", "preload", "drain", "clk"):
        mask = np.asarray([n == net for n, _ in SEGMENT_CLASS_SCHEMA])
        tot_c = float((cc["count"][mask, 0] * ln[mask, 0]).sum())
        wl_c = float((cc["count"][mask, 0] * ln[mask, 0] * cc["width"][mask, 0]).sum())
        s = segs.for_net(net)
        np.testing.assert_allclose(tot_c, s.length.sum(), rtol=1e-9)
        np.testing.assert_allclose(wl_c, (s.length * s.width).sum(), rtol=1e-9)


@pytest.mark.parametrize("aspect", [0.25, 1.0, 3.8, 9.0])
def test_uniform_reduces_to_closed_form(aspect):
    assert segment_wirelength("uniform", GEOM, aspect) == pytest.approx(
        wirelength_total(GEOM, aspect), rel=1e-12
    )
    assert segment_bus_power("uniform", GEOM, ACT, aspect) == pytest.approx(
        bus_power(GEOM, ACT, aspect), rel=1e-12
    )


def test_uniform_segment_counts_are_eq12():
    segs = enumerate_segments("uniform", 32, 32, 16, 37, 1200.0, 1.0, nets=("h", "v"))
    h, v = segs.for_net("h"), segs.for_net("v")
    assert h.n_segments == 32 * 32 and v.n_segments == 32 * 32
    w, hh = pe_dims_arr(1200.0, 1.0, xp=np)
    np.testing.assert_allclose(h.length, float(w))
    np.testing.assert_allclose(v.length, float(hh))


@settings(deadline=None, max_examples=30)
@given(
    st.integers(2, 64), st.integers(2, 64), st.integers(2, 24), st.integers(2, 48),
    st.floats(0.01, 1.0), st.floats(0.01, 1.0),
)
def test_uniform_segment_argmin_matches_eq6(rows, cols, b_h, b_v, a_h, a_v):
    grid = DesignSpace(rows=(rows,), cols=(cols,), input_bits=(8,)).expand()
    object.__setattr__(grid, "b_h", np.asarray([b_h], np.int64))
    object.__setattr__(grid, "b_v", np.asarray([b_v], np.int64))
    object.__setattr__(grid, "b_v_data", np.asarray([b_v], np.int64))
    ev = evaluate_layout_space(grid, float(a_h), float(a_v), layouts=("uniform",), engine="torch")
    geom = SystolicArrayGeometry(rows=rows, cols=cols, b_h=b_h, b_v=b_v)
    want = optimal_aspect_power(geom, BusActivity(a_h=a_h, a_v=a_v))
    assert math.log(float(ev.aspect_opt[0, 0, 0])) == pytest.approx(math.log(want), abs=1e-6)
    p_cf = bus_power(geom, BusActivity(a_h=a_h, a_v=a_v), want)
    assert float(ev.bus_power_opt[0, 0, 0]) == pytest.approx(p_cf, rel=1e-9)


# --- the lowered host tables, array by array ----------------------------------------

LOWER_AXES = dict(
    rows=(8, 32), cols=(8, 64), input_bits=(8, 16), dataflows=("WS", "OS"),
    bus_invert=(False, True), pe_area_um2=(400.0, 2500.0),
)
LOWER_FAMILIES = ("uniform", "serpentine2", "serpentine4") + pod_layouts((1, 2, 3, 4))


@pytest.mark.parametrize("max_env", [None, 4.0])
def test_lowered_layout_tables_equal_reference(max_env):
    grid, ref_grid = _both(**LOWER_AXES)
    got = lower_layout_coeffs(grid, LOWER_FAMILIES, max_envelope_aspect=max_env)
    want = RL.lower_layout_coeffs(ref_grid, LOWER_FAMILIES, max_envelope_aspect=max_env)
    assert got.key == want.key and got.rep_idx == want.rep_idx
    assert got.host.keys() == want.host.keys()
    for key in got.host:
        assert got.host[key].dtype == want.host[key].dtype, key
        assert np.array_equal(got.host[key], want.host[key]), key
    dev = got.device(torch.device("cpu"))
    assert tuple(dev) == coeffs_mod.DEVICE_FIELDS
    for key in coeffs_mod.DEVICE_FIELDS:
        assert np.array_equal(dev[key].numpy(), got.host[key]), key
    assert got.device(torch.device("cpu")) is dev


def test_lowered_partition_and_coding_tables_equal_reference():
    grid, ref_grid = _both(**LOWER_AXES)
    gemms = [Gemm("a", 64, 128, 64), Gemm("b", 50, 20, 30), Gemm("z", 0, 8, 8)]
    ref_gemms = [ref_wl.Gemm(g.name, g.m, g.k, g.n) for g in gemms]
    got = lower_partition_coeffs(grid, LOWER_FAMILIES, gemms)
    want = RL.lower_partition_coeffs(ref_grid, LOWER_FAMILIES, ref_gemms)
    assert got.key == want.key and got.host.keys() == want.host.keys()
    for key in got.host:
        assert np.array_equal(got.host[key], want.host[key]), key
    a_v = np.random.default_rng(4).uniform(0.0, 0.6, (2, grid.n_points))
    a_v[0, :3] = 0.0
    assert np.array_equal(grid_coding_effective(grid, a_v), RL.grid_coding_effective(ref_grid, a_v))
    got = lower_coding_multipliers(grid, a_v)
    want = RL.lower_coding_multipliers(ref_grid, a_v)
    assert got.key == want.key
    assert np.array_equal(got.host["act_mult"], want.host["act_mult"])
    assert np.array_equal(got.device(torch.device("cpu"))["act_mult"].numpy(), got.host["act_mult"])


# --- the batched evaluator against the reference --------------------------------------


def _grid_and_acts():
    axes = dict(rows=(8, 16), cols=(16, 32), input_bits=(8, 16), dataflows=("WS", "OS"))
    grid, ref_grid = _both(**axes)
    rng = np.random.default_rng(0)
    a_h = rng.uniform(0.1, 0.4, (3, grid.n_points))
    a_v = rng.uniform(0.2, 0.6, (3, grid.n_points))
    return grid, ref_grid, a_h, a_v


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("variant", ["aggregate", "lanes", "bus_invert", "envelope"])
def test_evaluator_matches_reference_float64(engine, variant):
    grid, ref_grid, a_h, a_v = _grid_and_acts()
    kw = dict(layouts=("uniform", "serpentine2", "serpentine4", "pods2x2", "pods4x4"),
              weights=[0.5, 1.0, 2.0])
    if variant == "lanes":
        rng = np.random.default_rng(1)
        kw["h_lanes"] = rng.uniform(0.0, 0.5, (3, grid.n_points, 64))
        kw["v_lanes"] = rng.uniform(0.0, 0.8, (3, grid.n_points, 64))
    if variant == "bus_invert":
        axes = dict(rows=(8, 16), cols=(16, 32), input_bits=(8,), bus_invert=(False, True))
        grid, ref_grid = _both(**axes)
        a_h, a_v = a_h[:, : grid.n_points], a_v[:, : grid.n_points]
    if variant == "envelope":
        kw["cfg"] = LayoutPowerConfig(max_envelope_aspect=4.0, preload_duty=0.1, drain_duty=0.05)
    cfg = kw.pop("cfg", LayoutPowerConfig())
    got = evaluate_layout_space(grid, a_h, a_v, engine=engine, cfg=cfg, **kw)
    ref_cfg = ref_power.LayoutPowerConfig(**dataclasses.asdict(cfg))
    want = RL.evaluate_layout_space(ref_grid, a_h, a_v, use_jit=False, cfg=ref_cfg, **kw)
    for f in EVAL_FIELDS:
        _assert_close(getattr(got, f), getattr(want, f))
    for f in ("feasible", "aspect_lo", "aspect_hi"):
        assert np.array_equal(getattr(got, f), getattr(want, f))
    assert np.array_equal(got.best_layout, want.best_layout)


@pytest.mark.parametrize("engine", ENGINES)
def test_evaluator_objective_matches_reference(engine):
    """The J/op outputs of an ObjectiveSpec (partition lowering + static
    power), against the reference's."""
    grid, ref_grid, a_h, a_v = _grid_and_acts()
    layouts = ("uniform", "pods2x2")
    gemms = [Gemm("a", 64, 128, 64), Gemm("b", 50, 20, 30), Gemm("c", 33, 16, 8)]
    ref_gemms = [ref_wl.Gemm(g.name, g.m, g.k, g.n) for g in gemms]
    static_w = np.random.default_rng(2).uniform(1e-3, 5e-3, (3, grid.n_points))
    w = np.asarray([g.macs for g in gemms], float)
    got = evaluate_layout_space(
        grid, a_h, a_v, layouts=layouts, weights=w, engine=engine,
        objective=ObjectiveSpec(lower_partition_coeffs(grid, layouts, gemms), static_w),
    )
    want = RL.evaluate_layout_space(
        ref_grid, a_h, a_v, layouts=layouts, weights=w, use_jit=False,
        objective=RL.ObjectiveSpec(RL.lower_partition_coeffs(ref_grid, layouts, ref_gemms), static_w),
    )
    for f in EVAL_FIELDS + ("j_per_mac", "j_per_mac_robust", "utilization"):
        _assert_close(getattr(got, f), getattr(want, f))
    assert np.array_equal(got.best_layout_jpo, want.best_layout_jpo)
    with pytest.raises(ValueError, match="objective.static_w"):
        evaluate_layout_space(grid, a_h, a_v, layouts=layouts, engine=engine,
                              objective=ObjectiveSpec(lower_partition_coeffs(grid, layouts, gemms),
                                                      static_w[:1]))


def test_evaluator_matches_reference_jit_within_its_tolerances():
    grid, ref_grid, a_h, a_v = _grid_and_acts()
    kw = dict(layouts=("uniform", "serpentine2", "pods2x2"))
    ev_t = evaluate_layout_space(grid, a_h, a_v, engine="torch", **kw)
    ev_j = RL.evaluate_layout_space(ref_grid, a_h, a_v, use_jit=True, **kw)
    tol = {"aspect_robust": 5e-3}
    for f in ("aspect_robust", "bus_power_robust", "overhead_w", "wirelength_um"):
        a, b = getattr(ev_t, f), getattr(ev_j, f)
        ok = np.isfinite(a)
        np.testing.assert_allclose(b[ok], a[ok], rtol=tol.get(f, 1e-3))
        assert (np.isfinite(b) == ok).all()


@pytest.mark.parametrize("engine", ENGINES)
def test_evaluator_uniform_matches_closed_forms_across_grid(engine):
    grid, _, a_h, a_v = _grid_and_acts()
    ev = evaluate_layout_space(grid, a_h, a_v, layouts=("uniform",), engine=engine)
    opt = optimal_aspect_power_arr(grid.b_h, grid.b_v, a_h, a_v)
    p = bus_power_arr(grid.rows, grid.cols, grid.b_h, grid.b_v, grid.pe_area_um2, a_h, a_v, opt)
    np.testing.assert_allclose(ev.aspect_opt[:, 0, :], opt, rtol=1e-6)
    np.testing.assert_allclose(ev.bus_power_opt[:, 0, :], p, rtol=1e-9)
    wl_cf = wirelength_total_arr(
        grid.rows, grid.cols, grid.b_h, grid.b_v, grid.pe_area_um2, ev.aspect_robust[0]
    )
    np.testing.assert_allclose(ev.wirelength_um[0], wl_cf, rtol=1e-9)
    assert ev.feasible.all()
    assert np.isfinite(ev.overhead_w).all() and (ev.overhead_w > 0).all()


@pytest.mark.parametrize("engine", ENGINES)
def test_infeasible_family_points_are_inf(engine):
    space = DesignSpace(rows=(6,), cols=(9,), input_bits=(8,))
    ev = evaluate_layout_space(space.expand(), 0.2, 0.4, layouts=("uniform", "pods4x4"), engine=engine)
    assert ev.feasible[0, 0] and not ev.feasible[1, 0]
    assert np.isinf(ev.bus_power_robust[1, 0])
    assert ev.best_layout_name(0) == "uniform"


@pytest.mark.parametrize("engine", ENGINES)
def test_envelope_limit_flips_winner_to_serpentine(engine):
    grid = DesignSpace(rows=(8,), cols=(128,), input_bits=(16,)).expand()
    free = evaluate_layout_space(grid, 0.22, 0.36, layouts=("uniform", "serpentine4"), engine=engine)
    assert float(free.bus_power_robust[0, 0]) < float(free.bus_power_robust[1, 0])
    boxed = evaluate_layout_space(
        grid, 0.22, 0.36, layouts=("uniform", "serpentine4"),
        cfg=LayoutPowerConfig(max_envelope_aspect=4.0), engine=engine,
    )
    assert boxed.best_layout_name(0) == "serpentine4"
    assert float(boxed.bus_power_robust[1, 0]) < 0.75 * float(boxed.bus_power_robust[0, 0])
    assert float(boxed.aspect_hi[0, 0]) == pytest.approx(4.0 * 8 / 128)


def test_zero_gutter_pods_still_classify_boundaries():
    register_layout("pods0g", MultiPodLayout(k=2, gutter_um=0.0))
    try:
        segs = enumerate_segments("pods0g", 8, 8, 16, 37, 400.0, 1.0, nets=("v",))
        trunks = segs.select(segs.kind == "trunk")
        assert trunks.n_segments == 8 * (2 - 1)
        assert (trunks.width == 37).all()
        cc = segment_class_coeffs(
            "pods0g", *(np.asarray([v]) for v in (8.0, 8.0, 16.0, 37.0)), np.asarray([False])
        )
        w, h = pe_dims_arr(400.0, 1.0, xp=np)
        ln = cc["len_w"] * w + cc["len_h"] * h + cc["len_c"]
        mask = np.asarray([n == "v" for n, _ in SEGMENT_CLASS_SCHEMA])
        wl_c = float((cc["count"][mask, 0] * ln[mask, 0] * cc["width"][mask, 0]).sum())
        v = segs.for_net("v")
        np.testing.assert_allclose(wl_c, (v.length * v.width).sum(), rtol=1e-9)
    finally:
        del LAYOUTS["pods0g"]


@pytest.mark.parametrize("engine", ENGINES)
def test_evaluate_layout_design_space_wrapper(engine):
    space = DesignSpace(rows=(8,), cols=(16,), input_bits=(8,), layouts=("uniform", "serpentine2"))
    ev = evaluate_layout_design_space(space, 0.2, 0.4, engine=engine)
    assert ev.layouts == ("uniform", "serpentine2")
    with pytest.raises(ValueError, match="layouts"):
        evaluate_layout_design_space(space.expand(), 0.2, 0.4, engine=engine)
    ev2 = evaluate_layout_design_space(space.expand(), 0.2, 0.4, layouts=("uniform",), engine=engine)
    assert ev2.layouts == ("uniform",)
    with pytest.raises(ValueError, match="unknown layout"):
        DesignSpace(rows=(8,), cols=(8,), layouts=("nope",))
    bi = DesignSpace(rows=(8,), cols=(8,), bus_invert=(True,))
    ev_bi = evaluate_layout_design_space(bi, 0.2, 0.4, engine=engine)
    assert np.isfinite(ev_bi.bus_power_robust).all()
    lanes = np.full((1, 1, 64), 0.4)
    with pytest.raises(ValueError, match="uncoded"):
        evaluate_layout_design_space(bi, 0.2, 0.4, v_lanes=lanes, engine=engine)


def test_evaluator_engine_and_sweep_contracts(monkeypatch):
    grid = DesignSpace(rows=(8,), cols=(16,), input_bits=(8,)).expand()
    with pytest.raises(ValueError, match="unknown engine"):
        evaluate_layout_space(grid, 0.2, 0.4, engine="xla")
    plain = evaluate_layout_space(grid, 0.2, 0.4, engine="torch")
    swept = evaluate_layout_space(grid, 0.2, 0.4, engine="torch", sweep=SweepConfig(chunk_size=1))
    assert plain.sweep_report is None and swept.sweep_report.rung_counts() == {"torch": 1}
    for field in EVAL_FIELDS + ("feasible", "aspect_lo", "aspect_hi"):
        assert np.array_equal(getattr(plain, field), getattr(swept, field)), field
    with pytest.raises(ValueError, match="h_lanes"):
        evaluate_layout_space(grid, 0.2, 0.4, engine="torch", h_lanes=np.zeros((2, 1, 64)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(CudaUnavailableError):
        evaluate_layout_space(grid, 0.2, 0.4)


# --- per-lane vs mean-lane roll-up ----------------------------------------------------


def test_mean_lane_is_exact_on_full_width_segments():
    b_h, b_v = 16, 37
    rng = np.random.default_rng(1)
    h_lanes = np.zeros(64)
    v_lanes = np.zeros(64)
    h_lanes[:b_h] = rng.uniform(0.05, 0.5, b_h)
    v_lanes[:b_v] = rng.uniform(0.05, 0.8, b_v)
    a_h, a_v = float(h_lanes[:b_h].mean()), float(v_lanes[:b_v].mean())
    segs = enumerate_segments("uniform", 16, 16, b_h, b_v, 1200.0, 2.0, nets=("h", "v"))
    lane = rollup_segments(segs, a_h, a_v, h_lanes=h_lanes, v_lanes=v_lanes)
    assert lane["bus_w"] == pytest.approx(rollup_segments(segs, a_h, a_v)["bus_w"], rel=1e-12)
    segs_p = enumerate_segments("pods4x4", 16, 16, b_h, b_v, 1200.0, 2.0, nets=("h", "v"))
    lane_p = rollup_segments(segs_p, a_h, a_v, h_lanes=h_lanes, v_lanes=v_lanes)
    assert lane_p["bus_w"] != pytest.approx(rollup_segments(segs_p, a_h, a_v)["bus_w"], rel=1e-6)
    ref_segs = RL.enumerate_segments("pods4x4", 16, 16, b_h, b_v, 1200.0, 2.0, nets=("h", "v"))
    assert lane_p == ref_power.rollup_segments(ref_segs, a_h, a_v, h_lanes=h_lanes, v_lanes=v_lanes)


@pytest.mark.parametrize("engine", ENGINES)
def test_measured_lane_activities_feed_the_evaluator(engine):
    axes = dict(rows=(8,), cols=(8,), input_bits=(8,))
    grid, ref_grid = _both(**axes)
    layers = [wl.ConvLayer("T1", k=1, h=6, w=6, c=32, m=24, input_density=0.5)]
    a_h, a_v, h_lanes, v_lanes = wl.measured_design_lane_activities(
        grid, layers, backend="torch", use_cache=False
    )
    assert h_lanes.shape == (1, 1, 64) and v_lanes.shape == (1, 1, 64)
    np.testing.assert_allclose(h_lanes.sum(-1), a_h * grid.b_h[None, :])
    np.testing.assert_allclose(v_lanes.sum(-1), a_v * grid.b_v[None, :])
    want = ref_wl.measured_design_lane_activities(
        ref_grid, [ref_wl.ConvLayer("T1", k=1, h=6, w=6, c=32, m=24, input_density=0.5)],
        backend="numpy", use_cache=False,
    )
    for g, w_ in zip((a_h, a_v, h_lanes, v_lanes), want):
        assert np.array_equal(g, w_)
    ev = evaluate_layout_space(grid, a_h, a_v, layouts=("uniform", "pods2x2"),
                               h_lanes=h_lanes, v_lanes=v_lanes, engine=engine)
    assert np.isfinite(ev.bus_power_robust).all()
    with pytest.raises(ValueError, match="uncoded"):
        wl.measured_design_lane_activities(DesignSpace(rows=(8,), cols=(8,), bus_invert=(True,)).expand(),
                                           layers, backend="torch")


def test_repeater_scaling_prices_long_segments_only():
    cfg = LayoutPowerConfig()
    segs = enumerate_segments("serpentine2", 32, 16, 16, 37, 1200.0, 1.0, nets=("h", "v"))
    assert (segs.select(segs.kind == "turn").length > cfg.repeater_spacing_um).all()
    assert (segs.select(segs.kind == "hop").length < cfg.repeater_spacing_um).all()
    p_rep = rollup_segments(segs, ACT.a_h, ACT.a_v, cfg=cfg)["bus_w"]
    cfg0 = LayoutPowerConfig(repeater_overhead=0.0)
    assert p_rep > rollup_segments(segs, ACT.a_h, ACT.a_v, cfg=cfg0)["bus_w"]
    u = enumerate_segments("uniform", 32, 16, 16, 37, 1200.0, 1.0, nets=("h", "v"))
    assert rollup_segments(u, ACT.a_h, ACT.a_v, cfg=cfg)["bus_w"] == pytest.approx(
        rollup_segments(u, ACT.a_h, ACT.a_v, cfg=cfg0)["bus_w"], rel=1e-12
    )


def test_overhead_nets_default_off_and_priceable():
    segs = enumerate_segments("uniform", 8, 8, 16, 37, 1200.0, 1.0)
    base = rollup_segments(segs, 0.2, 0.4)
    assert base["preload"] == 0.0
    assert rollup_segments(segs, 0.2, 0.4, cfg=LayoutPowerConfig(preload_duty=0.05))["preload"] > 0.0
    assert base["clk"] > 0.0
    assert base["total_w"] == pytest.approx(base["bus_w"] + base["overhead_w"])


# --- the coefficient protocol against segment enumeration (test_coeffs.py) ----------


def _check_cell(layout_name, rows, cols, bits, dataflow, area, a_h, a_v, rng, engine):
    grid = DesignSpace(rows=(rows,), cols=(cols,), input_bits=(bits,), dataflows=(dataflow,),
                       pe_area_um2=(area,)).expand()
    layout = get_layout(layout_name)
    cfg = LayoutPowerConfig(
        preload_duty=float(rng.uniform(0.01, 0.2)), drain_duty=float(rng.uniform(0.01, 0.2))
    )
    h_lanes = v_lanes = None
    if rng.random() < 0.5:
        h_lanes = np.zeros((2, 1, 64))
        v_lanes = np.zeros((2, 1, 64))
        b_v = int(grid.b_v[0])
        h_lanes[:, 0, :bits] = rng.uniform(0.0, 1.0, (2, bits))
        v_lanes[:, 0, :b_v] = rng.uniform(0.0, 1.0, (2, b_v))
    w = rng.uniform(0.2, 1.0, 2)
    ev = evaluate_layout_space(
        grid, np.asarray([[a_h], [a_h * 0.6]]), np.asarray([[a_v], [a_v * 1.3]]),
        layouts=(layout_name,), h_lanes=h_lanes, v_lanes=v_lanes, weights=w, cfg=cfg,
        engine=engine,
    )
    assert ev.feasible[0, 0]
    geom = grid.geometry(0)
    acts = [BusActivity(a_h, a_v), BusActivity(a_h * 0.6, a_v * 1.3)]
    w = w / w.sum()

    def lanes_of(wi):
        return dict(h_lanes=None if h_lanes is None else h_lanes[wi, 0],
                    v_lanes=None if v_lanes is None else v_lanes[wi, 0])

    for wi, act in enumerate(acts):
        ref = segment_bus_power(layout, geom, act, float(ev.aspect_opt[wi, 0, 0]),
                                dataflow=dataflow, cfg=cfg, **lanes_of(wi))
        assert float(ev.bus_power_opt[wi, 0, 0]) == pytest.approx(ref, rel=RTOL)
    asp_r = float(ev.aspect_robust[0, 0])
    ref_rob = sum(
        wv * segment_bus_power(layout, geom, act, asp_r, dataflow=dataflow, cfg=cfg, **lanes_of(wi))
        for wi, (wv, act) in enumerate(zip(w, acts))
    )
    assert float(ev.bus_power_robust[0, 0]) == pytest.approx(ref_rob, rel=RTOL)
    segs = enumerate_segments(layout, geom.rows, geom.cols, geom.b_h, geom.b_v, geom.pe_area_um2,
                              asp_r, dataflow=dataflow, nets=("preload", "drain", "clk"))
    ref_ov = rollup_segments(segs, 0.0, 0.0, cfg=cfg)["overhead_w"]
    assert float(ev.overhead_w[0, 0]) == pytest.approx(ref_ov, rel=RTOL, abs=1e-18)
    assert float(ev.wirelength_um[0, 0]) == pytest.approx(
        segment_wirelength(layout, geom, asp_r, dataflow=dataflow), rel=RTOL)


_FAMILIES = (
    ("uniform", 1), ("serpentine2", 2), ("serpentine4", 4), ("pods1x1", 1), ("pods2x2", 2),
    ("pods3x3", 3), ("pods4x4", 4), ("pods5x5", 5), ("pods8x8", 8),
)


def _random_cell(rng):
    name, div = _FAMILIES[int(rng.integers(len(_FAMILIES)))]
    rows = div * int(rng.integers(1, 7))
    cols = div * int(rng.integers(1, 7))
    if name.startswith("serpentine"):
        rows = int(rng.integers(2, 33))
    bits = int(rng.integers(4, 17))
    dataflow = "OS" if rng.random() < 0.5 else "WS"
    return (name, rows, cols, bits, dataflow, float(rng.uniform(200.0, 3000.0)),
            float(rng.uniform(0.02, 0.6)), float(rng.uniform(0.02, 0.6)))


@pytest.mark.parametrize("engine", ENGINES)
def test_coeff_matches_segment_rollup_seeded(engine):
    rng = np.random.default_rng(1234)
    seen = set()
    for _ in range(24):
        cell = _random_cell(rng)
        seen.add(cell[0])
        _check_cell(*cell, rng, engine)
    assert seen & {"pods3x3", "pods5x5", "pods8x8"}


@settings(max_examples=15, deadline=None)
@given(seed=st.integers(min_value=0, max_value=2**31))
def test_coeff_matches_segment_rollup_hypothesis(seed):
    rng = np.random.default_rng(seed)
    _check_cell(*_random_cell(rng), rng, "torch")


@pytest.mark.parametrize("engine", ENGINES)
def test_pods1x1_equals_uniform_through_evaluator(engine):
    grid = DesignSpace(rows=(8, 16), cols=(8, 32), input_bits=(8,), dataflows=("WS", "OS"),
                       pe_area_um2=(900.0,)).expand()
    ev = evaluate_layout_space(grid, 0.3, 0.2, layouts=("uniform", "pods1x1"), engine=engine)
    for f in ("aspect_robust", "bus_power_robust", "overhead_w", "wirelength_um"):
        np.testing.assert_array_equal(getattr(ev, f)[0], getattr(ev, f)[1])


def test_k_axis_rides_the_layout_axis():
    space = DesignSpace(rows=(24,), cols=(24,), input_bits=(8,), pe_area_um2=(900.0,),
                        layouts=("uniform",) + pod_layouts((2, 3)))
    ev = evaluate_layout_space(space.expand(), 0.3, 0.25, layouts=space.layouts, engine="torch")
    assert ev.feasible.all()
    assert ev.layouts == ("uniform", "pods2x2", "pods3x3")
    with pytest.raises(ValueError, match="unknown layout"):
        DesignSpace(rows=(8,), cols=(8,), layouts=("pods2x3",))


def test_coeff_cache_counters_and_eviction():
    def cell(cols):
        return DesignSpace(rows=(8,), cols=(cols,), input_bits=(8,), pe_area_um2=(900.0,)).expand()

    grid, grid2 = cell(8), cell(16)
    clear_coeff_cache()
    prev = set_coeff_cache_capacity(1)
    try:
        c1 = lower_layout_coeffs(grid, ("uniform",))
        assert lower_layout_coeffs(grid, ("uniform",)) is c1
        info = coeff_cache_info()
        assert (info["hits"], info["misses"], info["size"]) == (1, 1, 1)
        lower_layout_coeffs(grid2, ("uniform",))
        assert coeff_cache_info()["evictions"] == 1
        assert lower_layout_coeffs(grid, ("uniform",)) is not c1
        assert coeff_cache_info()["misses"] == 3
        register_layout("podsX", MultiPodLayout(k=2, gutter_um=10.0))
        try:
            ca = lower_layout_coeffs(grid, ("podsX",))
            register_layout("podsX", MultiPodLayout(k=2, gutter_um=99.0))
            assert ca.key != lower_layout_coeffs(grid, ("podsX",)).key
        finally:
            del LAYOUTS["podsX"]
        with pytest.raises(ValueError):
            set_coeff_cache_capacity(0)
    finally:
        set_coeff_cache_capacity(prev)
        clear_coeff_cache()


def test_repeater_prune_is_exact():
    grid = DesignSpace(rows=(8, 32), cols=(8, 64), input_bits=(8,), dataflows=("WS",),
                       pe_area_um2=(400.0, 2500.0)).expand()
    c = lower_layout_coeffs(grid, ("uniform", "serpentine2", "pods2x2"))
    h = c.host
    for j in range(h["alpha_d"].shape[1]):
        ln_ends = np.maximum(
            h["alpha_d"][:, j] * h["t_lo"] + h["beta_d"][:, j] / h["t_lo"] + h["gamma_d"][:, j],
            h["alpha_d"][:, j] * h["t_hi"] + h["beta_d"][:, j] / h["t_hi"] + h["gamma_d"][:, j],
        )
        live = h["feasible"] & (h["count_d"][:, j] > 0)
        if j not in c.rep_idx:
            assert not (ln_ends[live] > 200.0).any()


# --- GEMM partitioning across pods ----------------------------------------------------


@pytest.mark.parametrize("case", [
    ((256, 64, 16), 32, 32, 2, "WS"), ((256, 64, 16), 32, 32, 1, "WS"),
    ((100, 20, 20), 32, 32, 1, "WS"), ((100, 20, 20), 128, 128, 4, "WS"),
    ((64, 32, 32), 32, 32, 2, "WS"), ((64, 64, 64), 32, 32, 4, "OS"),
    ((0, 8, 8), 16, 16, 2, "WS"), ((1000, 3000, 70), 64, 64, 8, "WS"),
])
def test_partition_gemm_matches_reference(case):
    (m, k, n), rows, cols, kk, df = case
    got = partition_gemm(Gemm("g", m, k, n), rows, cols, k=kk, dataflow=df)
    want = ref_wl.partition_gemm(ref_wl.Gemm("g", m, k, n), rows, cols, k=kk, dataflow=df)
    g, w = dataclasses.asdict(got), dataclasses.asdict(want)
    assert g == w


def test_partition_deep_k_prefers_ksplit():
    p = partition_gemm(Gemm("g", m=256, k=64, n=16), 32, 32, k=2)
    assert p.mode == "ksplit" and p.trunk_words > 0
    assert p.spill_words <= partition_gemm(Gemm("g", m=256, k=64, n=16), 32, 32, k=1).spill_words


def test_partition_small_ragged_underutilizes_large_arrays():
    small = Gemm("g", m=100, k=20, n=20)
    u32 = partition_gemm(small, 32, 32, k=1).utilization
    u128 = partition_gemm(small, 128, 128, k=4).utilization
    assert u128 < u32 < 1.0
    assert partition_gemm(Gemm("g", m=64, k=32, n=32), 32, 32, k=2).utilization == 1.0


def test_partition_degeneracies():
    g = Gemm("g", m=64, k=64, n=64)
    assert partition_gemm(g, 32, 32, k=1).trunk_words == 0
    os_ = partition_gemm(g, 32, 32, k=4, dataflow="OS")
    assert os_.mode == "tile" and os_.trunk_words == 0 and os_.spill_words == 0
    with pytest.raises(ValueError):
        partition_gemm(g, 30, 32, k=4)
    with pytest.raises(ValueError):
        partition_gemm(g, 32, 32, dataflow="XS")
    assert wl.total_macs([g, Gemm("h", 2, 3, 4)]) == 64**3 + 24


def test_design_pod_partition_grid():
    axes = dict(rows=(16, 32), cols=(16, 32), input_bits=(8,), dataflows=("WS", "OS"),
                pe_area_um2=(900.0,))
    grid, ref_grid = _both(**axes)
    gemms = [Gemm("a", 64, 128, 64), Gemm("b", 50, 20, 30)]
    layouts = ("uniform",) + pod_layouts((1, 2))
    stats = design_pod_partition(grid, layouts, gemms)
    util = stats["utilization"]
    assert util.shape == (3, grid.n_points)
    np.testing.assert_array_equal(util[0], util[1])
    assert (util > 0).all() and (util <= 1.0).all()
    assert (stats["trunk_words_per_mac"][:2] == 0).all()
    want = ref_wl.design_pod_partition(ref_grid, layouts,
                                       [ref_wl.Gemm(g.name, g.m, g.k, g.n) for g in gemms])
    assert stats.keys() == want.keys()
    for key in stats:
        np.testing.assert_allclose(stats[key], want[key], rtol=RTOL, atol=0)
    with pytest.raises(ValueError):
        design_pod_partition(grid, layouts, [])
