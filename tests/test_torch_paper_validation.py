"""Parity copy of ``tests/test_paper_validation.py`` on the port's CPU path.

Every profiling test passes ``backend="torch"`` (the plain PyTorch versions
of the CUDA kernels) and compares its profiles with the JAX package's on the
same seeded operands; the LLM GEMM extraction (``gemms_for_arch``) is held
to the reference's for all ten architectures.

It also checks the port's Table-I main path at full size against
``src/repro_torch/data/table1_reference.json`` and that the file is what the
JAX package computes today (``tests/_torch_reference.py``).
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import repro.core.switching as ref_switching
import repro.core.workloads as ref_workloads
from _torch_reference import REFERENCE_PATH, build_reference
from repro_torch.core import switching
from repro_torch.core.energy import average_comparison, compare_sym_asym
from repro_torch.core.floorplan import (
    BusActivity,
    SystolicArrayGeometry,
    optimal_aspect_power,
)
from repro_torch.core.optimize import os_dataflow_geometry
from repro_torch.core.quant import dequantize, quantize_symmetric
from repro_torch.core.switching import combine_profiles
from repro_torch.core.workloads import (
    RESNET50_TABLE1,
    conv_to_gemm,
    gemms_for_arch,
    profile_conv_layer,
    profile_network,
    synth_activations,
    synth_weights,
)

GEOM = SystolicArrayGeometry.paper_32x32()
PAPER_ACT = BusActivity.paper_resnet50()
REFERENCE = json.loads(REFERENCE_PATH.read_text())


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


def _same_as_reference(profiles, ref_profiles):
    assert [p.as_dict() for p in profiles] == [dataclasses.asdict(r) for r in ref_profiles]


def test_headline_numbers():
    assert optimal_aspect_power(GEOM, PAPER_ACT) == pytest.approx(3.8, abs=0.05)
    c = compare_sym_asym(GEOM, PAPER_ACT)
    assert c.interconnect_saving == pytest.approx(0.091, abs=0.002)
    assert c.total_saving == pytest.approx(0.021, abs=0.002)


def test_table1_gemm_lowering():
    dims = {g.name: g for g in map(conv_to_gemm, RESNET50_TABLE1)}
    assert (dims["L1"].m, dims["L1"].k, dims["L1"].n) == (3136, 256, 64)
    assert (dims["L2"].m, dims["L2"].k, dims["L2"].n) == (784, 1152, 128)
    assert (dims["L6"].m, dims["L6"].k, dims["L6"].n) == (196, 2304, 256)
    ref_dims = [ref_workloads.conv_to_gemm(layer) for layer in ref_workloads.RESNET50_TABLE1]
    assert [dataclasses.astuple(g) for g in dims.values()] == [
        dataclasses.astuple(g) for g in ref_dims
    ]
    assert [dataclasses.astuple(layer) for layer in RESNET50_TABLE1] == [
        dataclasses.astuple(layer) for layer in ref_workloads.RESNET50_TABLE1
    ]


def test_llm_gemm_extraction():
    """Beyond-paper: the SA analysis consumes LLM layer GEMMs too."""
    import repro.configs.registry as ref_registry
    from repro_torch.configs.registry import ARCH_IDS, get_arch

    gemms = gemms_for_arch(get_arch("yi_6b"), seq_len=128, batch=1)
    names = {g.name for g in gemms}
    assert {"q_proj", "k_proj", "o_proj", "ffn_up", "lm_head"} <= names
    q = next(g for g in gemms if g.name == "q_proj")
    assert (q.m, q.k, q.n) == (128, 4096, 4096)
    moe = gemms_for_arch(get_arch("mixtral_8x7b"), seq_len=128, batch=1)
    eu = next(g for g in moe if g.name == "expert_up")
    assert eu.m == 128 * 2  # top-2 active tokens
    for arch in ARCH_IDS:
        for seq_len, batch in ((128, 1), (1, 64)):
            got = gemms_for_arch(get_arch(arch), seq_len=seq_len, batch=batch)
            want = ref_workloads.gemms_for_arch(ref_registry.get_arch(arch), seq_len, batch)
            assert [dataclasses.astuple(g) for g in got] == [
                dataclasses.astuple(g) for g in want], arch


def test_simulated_activities_in_paper_band():
    """Synthetic-input profiling lands in the paper's regime: a_h in the
    0.15-0.35 band, a_v in 0.3-0.55, and a_v > a_h for EVERY layer."""
    profiles = [
        profile_conv_layer(layer, max_tiles=4, max_stream=128, seed=i, backend="torch")
        for i, layer in enumerate(RESNET50_TABLE1)
    ]
    _same_as_reference(profiles, [
        ref_workloads.profile_conv_layer(layer, max_tiles=4, max_stream=128, seed=i)
        for i, layer in enumerate(ref_workloads.RESNET50_TABLE1)
    ])
    for p in profiles:
        assert p.a_v > p.a_h
    avg = combine_profiles(profiles)
    assert 0.1 < avg.a_h < 0.4
    assert 0.25 < avg.a_v < 0.6
    by_density = sorted(zip(RESNET50_TABLE1, profiles), key=lambda t: t[0].input_density)
    assert by_density[0][1].a_h < by_density[-1][1].a_h


def test_end_to_end_simulated_savings_positive():
    """Full pipeline on simulated data (no paper constants): per-layer asym
    floorplan still saves interconnect power on every Table I layer."""
    profiles = profile_network(RESNET50_TABLE1, max_tiles=3, max_stream=96, backend="torch")
    _same_as_reference(profiles, [
        ref_workloads.profile_conv_layer(layer, max_tiles=3, max_stream=96, seed=i)
        for i, layer in enumerate(ref_workloads.RESNET50_TABLE1)
    ])
    avg = combine_profiles(profiles).as_bus_activity()
    comps = [compare_sym_asym(GEOM, p.as_bus_activity(), design_act=avg) for p in profiles]
    for c in comps:
        assert c.interconnect_saving > 0.02
    agg = average_comparison(comps)
    assert 0.04 < agg["interconnect_saving"] < 0.15
    assert 0.005 < agg["total_saving"] < 0.04


def test_quantization_roundtrip_bound():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 64))
    for bits in (8, 16):
        q = quantize_symmetric(x, bits)
        err = np.max(np.abs(dequantize(q) - x))
        assert err <= q.scale * 0.5 + 1e-12
        assert np.max(np.abs(q.values)) <= 2 ** (bits - 1) - 1


@pytest.mark.parametrize("i", range(len(RESNET50_TABLE1)))
def test_operands_byte_identical_to_reference(i):
    """Both packages synthesize the same int16 operands for layer i (seed i)."""
    layer, g = RESNET50_TABLE1[i], conv_to_gemm(RESNET50_TABLE1[i])
    a = quantize_symmetric(synth_activations(g.m, g.k, layer.input_density, seed=i), 16).values
    w = quantize_symmetric(synth_weights(g.k, g.n, seed=i + 1), 16).values
    ref_a = ref_workloads.quantize_symmetric(
        ref_workloads.synth_activations(g.m, g.k, layer.input_density, seed=i), 16
    ).values
    ref_w = ref_workloads.quantize_symmetric(ref_workloads.synth_weights(g.k, g.n, seed=i + 1), 16).values
    assert switching._operand_digest(a) == ref_switching._operand_digest(ref_a)
    assert switching._operand_digest(w) == ref_switching._operand_digest(ref_w)


@pytest.mark.parametrize("i", range(len(RESNET50_TABLE1)))
def test_full_size_table1_layer_matches_reference_file(i):
    """The port's main path at full size, exact, on the CPU rung: every
    profile equals the JAX package's, field for field."""
    want = REFERENCE["layers"][i]
    for dataflow in ("WS", "OS"):
        p = profile_conv_layer(
            RESNET50_TABLE1[i], seed=i, backend="torch", use_cache=False, dataflow=dataflow
        )
        assert p.as_dict() == want[dataflow]["profile"]
        assert p.b_v == want[dataflow]["b_v"]
        h, v, ht, vt = want[dataflow]["counts"]
        assert (p.h_transitions, p.v_transitions) == (ht, vt)
        assert (p.a_h, p.a_v) == (h / (ht * p.b_h), v / (vt * p.b_v))


@pytest.mark.parametrize("dataflow", ["WS", "OS"])
def test_verdict_from_reference_profiles_matches_file(dataflow):
    """combine -> Eq. 6 -> per-layer compare -> average, on the port, from
    the reference's per-layer profiles, within 1e-12 of the reference."""
    geom = GEOM if dataflow == "WS" else os_dataflow_geometry(16, 32, 32)
    profiles = [
        switching.ActivityProfile.from_dict(layer[dataflow]["profile"])
        for layer in REFERENCE["layers"]
    ]
    want = REFERENCE["verdict"][dataflow]
    avg = combine_profiles(profiles)
    design = avg.as_bus_activity()
    assert optimal_aspect_power(geom, design) == pytest.approx(want["aspect_opt"], rel=1e-12)
    assert avg.as_dict() == pytest.approx(want["average_profile"], rel=1e-12)
    comps = [compare_sym_asym(geom, p.as_bus_activity(), design_act=design) for p in profiles]
    for c, w in zip(comps, want["per_layer"]):
        for key, value in w.items():
            assert getattr(c, key) == pytest.approx(value, rel=1e-12)
    assert average_comparison(comps) == pytest.approx(want["average"], rel=1e-12)
    if dataflow == "WS":
        assert want["aspect_opt"] == pytest.approx(3.8, abs=0.05)
        assert want["average"]["interconnect_saving"] == pytest.approx(0.091, abs=0.002)
        assert want["average"]["total_saving"] == pytest.approx(0.021, abs=0.002)


def test_reference_file_is_what_the_jax_package_computes():
    assert build_reference() == REFERENCE


def test_design_space_grid_in_file_agrees_with_the_layer_profiles():
    """The file's design-space activities (the example grid over the first
    three layers) are the Table-I profiles at the 32x32 WS point, and every
    point of one activity class carries its class's values."""
    from repro_torch.core.design_space import DesignSpace
    from repro_torch.core.workloads import _activity_classes

    ds = REFERENCE["design_space"]
    grid = DesignSpace(**ds["axes"]).expand()
    a_h, a_v = np.asarray(ds["a_h"]), np.asarray(ds["a_v"])
    assert a_h.shape == a_v.shape == (ds["layers"], grid.n_points)
    paper = (grid.rows == 32) & (grid.cols == 32) & ~grid.dataflow_os & ~grid.bus_invert
    for i, layer in enumerate(REFERENCE["layers"][: ds["layers"]]):
        assert (a_h[i, paper] == layer["WS"]["profile"]["a_h"]).all()
        assert (a_v[i, paper] == layer["WS"]["profile"]["a_v"]).all()
    classes, point_class = _activity_classes(grid)
    assert len(classes) == ds["batch_stats"]["jobs"] // ds["layers"]
    for c in range(len(classes)):
        sel = point_class == c
        assert (a_h[:, sel] == a_h[:, sel][:, :1]).all() and (a_v[:, sel] == a_v[:, sel][:, :1]).all()
