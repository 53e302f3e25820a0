"""The port's quant, systolic, floorplan, energy and optimize modules against
the JAX package.

Integer results (quantized values, schedules, tiled matmuls) must be equal.
Float results must agree with the reference's float64 numpy path within
rtol 1e-12: the formulas are the same, the golden-section searches run the
same 64 (or 80) iterations, and only the last bits of torch's and numpy's
elementwise functions may differ.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.energy as ref_energy
import repro.core.floorplan as ref_fp
import repro.core.optimize as ref_opt
import repro.core.quant as ref_quant
import repro.core.systolic as ref_sys
import repro.core.switching as ref_switching
import repro_torch.core.energy as energy
import repro_torch.core.floorplan as fp
import repro_torch.core.optimize as opt
import repro_torch.core.quant as quant
import repro_torch.core.switching as switching
import repro_torch.core.systolic as systolic

RTOL = 1e-12


def _t(x):
    return torch.as_tensor(np.asarray(x, dtype=np.float64))


def _close(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=0)


def _points(seed=0, n=64):
    """Random design points, including zero-activity edge cases."""
    rng = np.random.default_rng(seed)
    pts = {
        "rows": rng.integers(4, 129, n).astype(np.float64),
        "cols": rng.integers(4, 129, n).astype(np.float64),
        "b_h": rng.integers(4, 33, n).astype(np.float64),
        "b_v": rng.integers(8, 65, n).astype(np.float64),
        "pe_area": rng.uniform(200.0, 3000.0, n),
        "a_h": rng.uniform(0.0, 1.0, n),
        "a_v": rng.uniform(0.0, 1.0, n),
        "aspect": np.exp(rng.uniform(np.log(1 / 16), np.log(16), n)),
    }
    pts["a_h"][:3] = 0.0
    pts["a_v"][1:4] = 0.0
    return pts


# --- quant -------------------------------------------------------------------


@pytest.mark.parametrize("bits", [2, 8, 16, 32])
def test_quantize_matches_reference(bits):
    x = np.random.default_rng(bits).normal(size=(64, 48))
    got, want = quant.quantize_symmetric(x, bits), ref_quant.quantize_symmetric(x, bits)
    assert np.array_equal(got.values, want.values) and got.values.dtype == np.int64
    assert (got.scale, got.bits) == (want.scale, want.bits)
    assert np.array_equal(quant.dequantize(got), ref_quant.dequantize(want))
    with pytest.raises(ValueError):
        quant.quantize_symmetric(x, 33)


# --- systolic ------------------------------------------------------------------

SHAPES = [(100, 70, 50, 32, 32), (7, 5, 3, 32, 32), (33, 70, 10, 16, 8), (1, 1, 1, 1, 1)]


@pytest.mark.parametrize("dataflow", ["WS", "OS"])
@pytest.mark.parametrize("shape", SHAPES)
def test_schedule_matches_reference(shape, dataflow):
    got = systolic.schedule_gemm(*shape, dataflow=dataflow)
    want = ref_sys.schedule_gemm(*shape, dataflow=dataflow)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.utilization == want.utilization
    gemms = [shape[:3], (50, 32, 96)]
    assert dataclasses.asdict(systolic.schedule_many(gemms, 32, 32, dataflow)) == (
        dataclasses.asdict(ref_sys.schedule_many(gemms, 32, 32, dataflow))
    )


def test_tile_cycles_and_dataflow_lookup():
    assert systolic.ws_tile_cycles(32, 32, 100) == ref_sys.ws_tile_cycles(32, 32, 100)
    assert systolic.os_tile_cycles(32, 16, 70) == ref_sys.os_tile_cycles(32, 16, 70)
    assert systolic.get_dataflow("OS").name == "OS"
    with pytest.raises(ValueError, match="unknown dataflow"):
        systolic.get_dataflow("RS")


@pytest.mark.parametrize("dataflow", ["WS", "OS"])
@pytest.mark.parametrize("shape", SHAPES[:3])
def test_tiled_matmul_int_exact(shape, dataflow):
    m, k, n, rows, cols = shape
    rng = np.random.default_rng(m + k + n)
    # magnitudes whose sums fit the int32 accumulator
    a = rng.integers(-1000, 1000, size=(m, k)).astype(np.int16)
    w = rng.integers(-1000, 1000, size=(k, n)).astype(np.int16)
    got = systolic.matmul_reference(torch.from_numpy(a), torch.from_numpy(w), rows, cols, dataflow)
    want = ref_sys.matmul_reference(jnp.asarray(a), jnp.asarray(w), rows, cols, dataflow)
    assert got.dtype == torch.int32  # int16 operands accumulate in int32
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(got.numpy(), a.astype(np.int64) @ w.astype(np.int64))


def test_tiled_matmul_accumulator_dtypes():
    a = torch.ones((4, 3), dtype=torch.int8)
    assert systolic.ws_matmul_reference(a, a.T.contiguous(), 2, 2).dtype == torch.int32
    a64 = torch.ones((4, 3), dtype=torch.int64)
    assert systolic.os_matmul_reference(a64, a64.T, 2, 2).dtype == torch.int64
    h = torch.ones((4, 3), dtype=torch.float16)
    out = systolic.ws_matmul_reference(h, h.T, 2, 2)
    assert out.dtype == torch.float32 and torch.all(out == 3)
    with pytest.raises(ValueError, match="bad shapes"):
        systolic.ws_matmul_reference(a, a, 2, 2)


# --- floorplan -------------------------------------------------------------------


def test_floorplan_scalar_api_matches_reference():
    pts = _points(1, 16)
    for i in range(16):
        g = fp.SystolicArrayGeometry(int(pts["rows"][i]), int(pts["cols"][i]), int(pts["b_h"][i]),
                                     int(pts["b_v"][i]), float(pts["pe_area"][i]))
        rg = ref_fp.SystolicArrayGeometry(g.rows, g.cols, g.b_h, g.b_v, g.pe_area_um2)
        act = fp.BusActivity(float(pts["a_h"][i]), float(pts["a_v"][i]))
        ract = ref_fp.BusActivity(act.a_h, act.a_v)
        r = float(pts["aspect"][i])
        _close(fp.pe_dims_from_aspect(g, r), ref_fp.pe_dims_from_aspect(rg, r))
        _close(fp.wirelength_total(g, r), ref_fp.wirelength_total(rg, r))
        _close(fp.optimal_aspect_wirelength(g), ref_fp.optimal_aspect_wirelength(rg))
        _close(fp.optimal_aspect_power(g, act), ref_fp.optimal_aspect_power(rg, ract))
        _close(fp.bus_power(g, act, r), ref_fp.bus_power(rg, ract, r))
        _close(fp.bus_switched_capacitance_per_cycle(g, act, r),
               ref_fp.bus_switched_capacitance_per_cycle(rg, ract, r))
        _close(fp.bus_power_ratio_vs_square(g, act), ref_fp.bus_power_ratio_vs_square(rg, ract))
        if act.a_h > 0 or act.a_v > 0:
            _close(fp.numeric_optimal_aspect(g, act), ref_fp.numeric_optimal_aspect(rg, ract))
        want_rows = ref_fp.sweep_aspects(rg, ract, [0.5, 1.0, 4.0])
        for got_row, want_row in zip(fp.sweep_aspects(g, act, [0.5, 1.0, 4.0]), want_rows):
            assert got_row.keys() == want_row.keys()
            _close(list(got_row.values()), list(want_row.values()))
    paper = fp.SystolicArrayGeometry.paper_32x32()
    assert (paper.b_h, paper.b_v) == (16, 37) == (16, fp.accumulator_width(16, 32))
    assert fp.optimal_aspect_power(paper, fp.BusActivity.paper_resnet50()) == pytest.approx(3.8, abs=0.05)


def test_floorplan_arr_kernels_torch_match_reference_numpy():
    p = _points(2)
    t = {k: _t(v) for k, v in p.items()}
    geo = ("rows", "cols")
    _close(torch.stack(fp.pe_dims_arr(t["pe_area"], t["aspect"])),
           np.stack(ref_fp.pe_dims_arr(p["pe_area"], p["aspect"])))
    _close(fp.wirelength_total_arr(*(t[k] for k in geo), t["b_h"], t["b_v"], t["pe_area"], t["aspect"]),
           ref_fp.wirelength_total_arr(*(p[k] for k in geo), p["b_h"], p["b_v"], p["pe_area"], p["aspect"]))
    _close(fp.optimal_aspect_wirelength_arr(t["b_h"], t["b_v"]),
           ref_fp.optimal_aspect_wirelength_arr(p["b_h"], p["b_v"]))
    got = fp.optimal_aspect_power_arr(t["b_h"], t["b_v"], t["a_h"], t["a_v"])
    assert got.dtype == torch.float64
    _close(got, ref_fp.optimal_aspect_power_arr(p["b_h"], p["b_v"], p["a_h"], p["a_v"]))
    args = ("rows", "cols", "b_h", "b_v", "pe_area", "a_h", "a_v", "aspect")
    _close(fp.bus_power_arr(*(t[k] for k in args)), ref_fp.bus_power_arr(*(p[k] for k in args)))
    _close(fp.bus_power_ratio_vs_square_arr(t["b_h"], t["b_v"], t["a_h"], t["a_v"]),
           ref_fp.bus_power_ratio_vs_square_arr(p["b_h"], p["b_v"], p["a_h"], p["a_v"]))
    # scalar geometry broadcast against tensors
    _close(fp.bus_power_arr(32, 32, 16, 37, 1200.0, t["a_h"], t["a_v"], 1.0),
           ref_fp.bus_power_arr(32, 32, 16, 37, 1200.0, p["a_h"], p["a_v"], 1.0))


def test_batched_golden_section_matches_reference():
    centers = np.linspace(-2.0, 3.0, 9)

    def f_np(x):
        return (x - centers) ** 2 + 0.1 * np.abs(x - centers) ** 3

    def f_t(x):
        c = _t(centers)
        return (x - c) ** 2 + 0.1 * torch.abs(x - c) ** 3

    got = fp.golden_section_minimize_arr(f_t, _t(np.full(9, -5.0)), _t(np.full(9, 5.0)))
    want = ref_fp.golden_section_minimize_arr(f_np, np.full(9, -5.0), np.full(9, 5.0), xp=np)
    _close(got, want)
    np.testing.assert_allclose(got.numpy(), centers, atol=1e-9)
    assert fp.golden_section_minimize(lambda x: (x - 1.5) ** 2, -4, 4) == pytest.approx(
        ref_fp.golden_section_minimize(lambda x: (x - 1.5) ** 2, -4, 4), rel=RTOL
    )


# --- energy ------------------------------------------------------------------------


def test_energy_scalar_api_matches_reference():
    pts = _points(3, 12)
    geom, rgeom = fp.SystolicArrayGeometry.paper_32x32(), ref_fp.SystolicArrayGeometry.paper_32x32()
    comps, rcomps = [], []
    for i in range(3, 12):  # non-degenerate activities
        act = fp.BusActivity(float(pts["a_h"][i]), float(pts["a_v"][i]))
        ract = ref_fp.BusActivity(act.a_h, act.a_v)
        design = fp.BusActivity(0.22, 0.36)
        rdesign = ref_fp.BusActivity(0.22, 0.36)
        c = energy.compare_sym_asym(geom, act, design_act=design)
        rc = ref_energy.compare_sym_asym(rgeom, ract, design_act=rdesign)
        for field in ("aspect_opt", "interconnect_saving", "total_saving", "bus_saving"):
            _close(getattr(c, field), getattr(rc, field))
        b = energy.power_breakdown(geom, act, 2.0, reference_act=design)
        rb = ref_energy.power_breakdown(rgeom, ract, 2.0, reference_act=rdesign)
        _close([b.bus_w, b.fixed_interconnect_w, b.compute_w, b.total_w],
               [rb.bus_w, rb.fixed_interconnect_w, rb.compute_w, rb.total_w])
        comps.append(c)
        rcomps.append(rc)
    got, want = energy.average_comparison(comps), ref_energy.average_comparison(rcomps)
    assert got.keys() == want.keys()
    _close(list(got.values()), list(want.values()))
    paper = energy.compare_sym_asym(geom, fp.BusActivity.paper_resnet50())
    assert paper.interconnect_saving == pytest.approx(0.091, abs=0.002)
    assert paper.total_saving == pytest.approx(0.021, abs=0.002)


def test_compare_sym_asym_arr_torch_matches_reference_numpy():
    p = _points(4)
    p["a_h"][:3] = 0.05  # bus_saving divides by the square layout's bus power
    t = {k: _t(v) for k, v in p.items()}
    args = ("rows", "cols", "b_h", "b_v", "pe_area", "a_h", "a_v")
    kw = dict(design_a_h=0.22, design_a_v=0.36)
    got = energy.compare_sym_asym_arr(*(t[k] for k in args), **kw)
    want = ref_energy.compare_sym_asym_arr(*(p[k] for k in args), **kw)
    assert got.keys() == want.keys()
    for key in want:
        _close(got[key], want[key])
    bd = energy.power_breakdown_arr(*(t[k] for k in args), t["aspect"])
    rbd = ref_energy.power_breakdown_arr(*(p[k] for k in args), p["aspect"])
    for key in rbd:
        _close(bd[key], rbd[key])


# --- optimize ------------------------------------------------------------------------


def _workload_acts(seed=5, w=4, n=8):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.05, 0.6, (w, n)), rng.uniform(0.2, 0.7, (w, n))


def test_regret_and_minimax_arr_torch_match_reference_numpy():
    a_h, a_v = _workload_acts()
    b_h, b_v = np.full(8, 16.0), np.linspace(17, 64, 8)
    aspect = np.linspace(0.5, 8.0, 8)
    _close(opt.regret_arr(_t(b_h), _t(b_v), _t(a_h), _t(a_v), _t(aspect)),
           ref_opt.regret_arr(b_h, b_v, a_h, a_v, aspect))
    _close(opt.max_regret_arr(_t(b_h), _t(b_v), _t(a_h), _t(a_v), _t(aspect)),
           ref_opt.max_regret_arr(b_h, b_v, a_h, a_v, aspect))
    _close(opt.minimax_aspect_arr(_t(b_h), _t(b_v), _t(a_h), _t(a_v)),
           ref_opt.minimax_aspect_arr(b_h, b_v, a_h, a_v, xp=np))


def test_bus_invert_arr_torch_matches_reference_numpy():
    a = np.array([0.0, 1e-12, 0.1, 0.36, 0.5, 0.9, 1.0 - 1e-12, 1.0])
    bits = np.array([1, 8, 16, 17, 32, 37, 63, 64], dtype=np.float64)
    _close(opt.bus_invert_activity_arr(_t(a), _t(bits)), ref_opt.bus_invert_activity_arr(a, bits))
    for ai, bi in zip(a, bits.astype(int)):
        _close(opt.bus_invert_activity(float(ai), int(bi)), ref_opt.bus_invert_activity(float(ai), int(bi)))


@pytest.mark.parametrize("strategy", ["average", "weighted", "minimax"])
def test_robust_design_point_matches_reference(strategy):
    a_h, a_v = _workload_acts(6, 5, 1)
    profiles = [switching.ActivityProfile(float(h), float(v), 16, 37, 1000 + i, 2000 + i, 0.4, 50)
                for i, (h, v) in enumerate(zip(a_h[:, 0], a_v[:, 0]))]
    rprofiles = [ref_switching.ActivityProfile(**dataclasses.asdict(p)) for p in profiles]
    geom, rgeom = fp.SystolicArrayGeometry.paper_32x32(), ref_fp.SystolicArrayGeometry.paper_32x32()
    weights = [3.0, 1.0, 1.0, 0.5, 2.0] if strategy == "weighted" else None
    _close(opt.robust_design_point(geom, profiles, strategy, weights),
           ref_opt.robust_design_point(rgeom, rprofiles, strategy, weights))
    acts = [fp.BusActivity(p.a_h, p.a_v) for p in profiles]
    racts = [ref_fp.BusActivity(p.a_h, p.a_v) for p in profiles]
    _close(opt.max_regret(geom, acts, 3.0), ref_opt.max_regret(rgeom, racts, 3.0))


def test_os_geometry_and_bus_invert_geometry_match_reference():
    assert dataclasses.asdict(opt.os_dataflow_geometry(16, 32, 32)) == dataclasses.asdict(
        ref_opt.os_dataflow_geometry(16, 32, 32)
    )
    geom, act = fp.SystolicArrayGeometry.paper_32x32(), fp.BusActivity(0.22, 0.36)
    g2, a2 = opt.bus_invert_geometry(geom, act)
    rg2, ra2 = ref_opt.bus_invert_geometry(ref_fp.SystolicArrayGeometry.paper_32x32(),
                                           ref_fp.BusActivity(0.22, 0.36))
    assert g2.b_v == rg2.b_v == 38
    _close([a2.a_h, a2.a_v], [ra2.a_h, ra2.a_v])
