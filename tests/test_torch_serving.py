"""The port's serving co-design (``configs``, ``launch.specs.token_shape``,
``core.workloads.gemms_for_arch`` and ``serving``) against the JAX package,
case by case from ``tests/test_serving.py``.

Every ``ArchConfig`` field equals the reference's for all ten
architectures; token shapes, expansions and job sets are bit-exact (weights
as arrays); ``codesign`` with ``backend="torch"`` gives the reference's
measured activities exactly and its ``j_per_mac`` within 1e-12 on the
``"torch"`` and ``"numpy"`` engines.  At full width, Mixtral-8x7B under
``decode_heavy`` is held to ``src/repro_torch/data/serving_reference.json``
(``tests/_torch_reference.py``), which must be what the JAX package
computes today.
"""

import dataclasses
import json

import numpy as np
import pytest

import repro.configs.registry as ref_registry
import repro.core.design_space as ref_ds
import repro.core.objective as ref_obj
import repro.core.workloads as ref_wl
import repro.launch.specs as ref_specs
import repro.serving as ref_serving
from _torch_reference import SERVING_REFERENCE_PATH, build_serving_reference, dumps_compact
from repro_torch.configs import registry
from repro_torch.configs.registry import ARCH_IDS, SHAPES, get_arch
from repro_torch.core.design_space import DesignSpace
from repro_torch.core.objective import evaluate_fleet_objective
from repro_torch.core.sweep import SweepConfig
from repro_torch.core.workloads import (
    Gemm,
    gemm_profile_seed,
    measured_design_gemm_activities,
)
from repro_torch.kernels._engine import CudaUnavailableError
from repro_torch.launch.specs import token_shape
from repro_torch.serving import (
    DEFAULT_FAMILIES,
    DEFAULT_SPACE,
    PRESETS,
    ServingGemm,
    TrafficModel,
    cnn_reference,
    codesign,
    expand_arch,
    expand_shape,
    get_preset,
    regime_tokens,
    routing_sparsity,
    sample_requests,
    traffic_classes,
    weighted_gemms,
)

RTOL = 1e-12
MOE_ARCHS = [a for a in ARCH_IDS if get_arch(a).num_experts > 1]
SERVING_REFERENCE = json.loads(SERVING_REFERENCE_PATH.read_text())


def _gemm_tuple(g):
    return (g.name, g.m, g.k, g.n)


def _ref_arch(arch):
    return ref_registry.get_arch(arch)


# ---------------------------------------------------------------------------
# The registry: the same configurations, field by field
# ---------------------------------------------------------------------------


# Fields of the port's config that the reference's has not, with the value
# every registry entry holds: the one at which the port computes the
# reference's function (Jamba's inner norms, which a benchmark config turns
# on).
PORT_ONLY_FIELDS = {"mamba_inner_norms": False}


def _shared(cfg) -> dict:
    return {k: v for k, v in dataclasses.asdict(cfg).items() if k not in PORT_ONLY_FIELDS}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_arch_config_equals_reference(arch):
    got, want = get_arch(arch), _ref_arch(arch)
    assert [f.name for f in dataclasses.fields(got) if f.name not in PORT_ONLY_FIELDS] == [
        f.name for f in dataclasses.fields(want)]
    for cfg in (got, got.reduced()):
        assert {k: getattr(cfg, k) for k in PORT_ONLY_FIELDS} == PORT_ONLY_FIELDS
    assert _shared(got) == dataclasses.asdict(want)
    assert _shared(got.reduced()) == dataclasses.asdict(want.reduced())
    assert (got.n_stages, got.dt_rank) == (want.n_stages, want.dt_rank)


def test_registry_tables_equal_reference():
    assert ARCH_IDS == ref_registry.ARCH_IDS
    assert registry.ALIASES == ref_registry.ALIASES
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in ref_registry.SHAPES.items()}
    assert registry.all_cells() == ref_registry.all_cells()
    for alias, arch in registry.ALIASES.items():
        assert get_arch(alias).name == arch
    with pytest.raises(KeyError, match="unknown arch"):
        get_arch("nope")
    with pytest.raises(ValueError, match="multiple"):
        registry.ArchConfig("x", 3, 8, 1, 1, 8, 8, 8, stage_pattern=(("attn", "dense"),) * 2)


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("batch,seq", [(1, 1), (128, 1), (4, 512), (32, 32768)])
def test_token_shape_equals_reference(arch, batch, seq):
    assert token_shape(get_arch(arch), batch, seq) == ref_specs.token_shape(
        _ref_arch(arch), batch, seq)


# ---------------------------------------------------------------------------
# Registry expansion (every config, both regimes)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("regime,batch,seq", [("prefill", 4, 512), ("decode", 64, 1)])
def test_every_config_expands(arch, regime, batch, seq):
    cfg = get_arch(arch)
    jobs = expand_arch(cfg, regime, batch, seq)
    assert jobs, f"{arch}: empty {regime} job set"
    t = regime_tokens(cfg, regime, batch, seq)
    for j in jobs:
        assert min(j.gemm.m, j.gemm.k, j.gemm.n) >= 1, (arch, j.block)
        assert j.count >= 1 and j.macs > 0, (arch, j.block)
        assert j.regime == regime
        if j.input_density is not None:
            assert 0.0 < j.input_density <= 1.0
        if not j.block.startswith("moe.expert"):
            assert j.gemm.m == t, (arch, j.block, j.gemm.m, t)
    assert "head.lm_head" in {j.block for j in jobs}
    want = ref_serving.expand_arch(_ref_arch(arch), regime, batch, seq)
    assert [(_gemm_tuple(j.gemm), j.block, j.regime, j.count, j.input_density) for j in jobs] == [
        (_gemm_tuple(j.gemm), j.block, j.regime, j.count, j.input_density) for j in want]
    assert t == ref_serving.regime_tokens(_ref_arch(arch), regime, batch, seq)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_routing_sparsity_in_unit_interval(arch):
    cfg = get_arch(arch)
    s = routing_sparsity(cfg)
    assert 0.0 < s <= 1.0
    assert s == ref_serving.routing_sparsity(_ref_arch(arch))
    if cfg.num_experts > 1:
        assert s == cfg.top_k / cfg.num_experts < 1.0
    else:
        assert s == 1.0


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_effective_expert_batch(arch):
    cfg = get_arch(arch)
    t = 256
    jobs = expand_arch(cfg, "prefill", 1, t)
    experts = [j for j in jobs if j.block.startswith("moe.expert")]
    assert experts, f"{arch}: no expert GEMMs"
    m_e = max(1, round(t * routing_sparsity(cfg)))
    assert all(j.gemm.m == m_e for j in experts)
    assert all(j.count % cfg.num_experts == 0 for j in experts)
    router = [j for j in jobs if j.block == "moe.router"]
    assert router and all(j.gemm.m == t and j.gemm.n == cfg.num_experts for j in router)


@pytest.mark.parametrize("shape_id", sorted(SHAPES))
def test_registry_shape_cells_expand(shape_id):
    shape = SHAPES[shape_id]
    for arch in ("mixtral_8x7b", "qwen3_8b"):
        jobs = expand_shape(get_arch(arch), shape)
        assert jobs and all(j.macs > 0 for j in jobs)
        want = "decode" if shape.kind == "decode" else "prefill"
        assert all(j.regime == want for j in jobs)
        ref_jobs = ref_serving.expand_shape(_ref_arch(arch), ref_registry.SHAPES[shape_id])
        assert [(_gemm_tuple(j.gemm), j.count) for j in jobs] == [
            (_gemm_tuple(j.gemm), j.count) for j in ref_jobs]


def test_expand_contract_errors():
    cfg = get_arch("qwen3_8b")
    with pytest.raises(ValueError, match="regime"):
        expand_arch(cfg, "train", 1, 16)
    with pytest.raises(ValueError, match="batch"):
        expand_arch(cfg, "prefill", 0, 16)
    with pytest.raises(ValueError, match="count"):
        ServingGemm(Gemm("x", 1, 1, 1), "b", "decode", count=0)
    with pytest.raises(ValueError, match="non-positive"):
        ServingGemm(Gemm("x", 1, 0, 1), "b", "decode", count=1)


# ---------------------------------------------------------------------------
# Decode shapes: one authority (launch.specs.token_shape)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_specs_match_token_shape(arch):
    """The reference's dry-run decode specs (its ``decode_batch_specs``)
    have exactly the port's decode token shape."""
    cfg = get_arch(arch)
    shape = SHAPES["decode_32k"]
    specs, _axes = ref_specs.decode_batch_specs(_ref_arch(arch), ref_registry.SHAPES["decode_32k"])
    assert tuple(specs["tokens"].shape) == token_shape(cfg, shape.global_batch, 1)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_expansion_matches_decode_specs(arch):
    cfg = get_arch(arch)
    b = SHAPES["decode_32k"].global_batch
    tok = token_shape(cfg, b, 1)
    m = tok[0] * tok[1]  # codebook streams share one position
    assert regime_tokens(cfg, "decode", b) == m
    jobs = expand_arch(cfg, "decode", b)
    non_expert = [j for j in jobs if not j.block.startswith("moe.expert")]
    assert all(j.gemm.m == m for j in non_expert)
    assert expand_arch(cfg, "decode", b, 999)[0].gemm.m == m


def test_prefill_tokens_are_batch_times_seq():
    for arch in ("qwen3_8b", "musicgen_medium"):
        cfg = get_arch(arch)
        assert regime_tokens(cfg, "prefill", 3, 128) == 3 * 128


# ---------------------------------------------------------------------------
# Traffic model: seeded determinism, weight invariants, parity
# ---------------------------------------------------------------------------


def test_sample_requests_deterministic():
    tm = get_preset("balanced")
    a = sample_requests(tm)
    b = sample_requests(tm)
    for x, y in zip(a, b):
        assert np.array_equal(x, y)
    for x, y in zip(a, ref_serving.sample_requests(ref_serving.get_preset("balanced"))):
        assert np.array_equal(x, y) and x.dtype == y.dtype
    c = sample_requests(dataclasses.replace(tm, seed=1))
    assert not all(np.array_equal(x, y) for x, y in zip(a, c))


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_traffic_classes_invariants(preset):
    tm = get_preset(preset)
    assert dataclasses.asdict(tm) == dataclasses.asdict(ref_serving.get_preset(preset))
    classes = traffic_classes(tm)
    assert [dataclasses.astuple(c) for c in classes] == [
        dataclasses.astuple(c) for c in ref_serving.traffic_classes(ref_serving.get_preset(preset))]
    assert {tc.regime for tc in classes} == {"prefill", "decode"}
    prompts, gens, _ = sample_requests(tm)
    window_s = tm.n_samples / tm.qps
    tok = sum(tc.tokens_per_s for tc in classes)
    assert tok == pytest.approx(float(prompts.sum() + gens.sum()) / window_s)
    for tc in classes:
        assert tc.batch >= 1 and tc.seq_len >= 1
        assert tc.tokens_per_s > 0 and tc.execs_per_s > 0
        if tc.regime == "decode":
            assert tc.seq_len == 1 and tc.batch <= tm.max_decode_batch
        else:
            assert tc.batch <= tm.max_prefill_batch
            assert tc.seq_len & (tc.seq_len - 1) == 0


def _assert_jobset_equal(got, want):
    assert [_gemm_tuple(g) for g in got.gemms] == [_gemm_tuple(g) for g in want.gemms]
    for f in ("weights", "mac_rate"):
        a, b = np.asarray(getattr(got, f)), np.asarray(getattr(want, f))
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f
    assert (got.arch, got.traffic, got.regimes, got.densities) == (
        want.arch, want.traffic, want.regimes, want.densities)
    assert got.tokens_per_s == want.tokens_per_s
    assert got.macs_per_token == want.macs_per_token


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_jobset_bit_exact_against_reference(arch, preset):
    _assert_jobset_equal(weighted_gemms(get_arch(arch), get_preset(preset)),
                         ref_serving.weighted_gemms(_ref_arch(arch), ref_serving.get_preset(preset)))


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_jobset_weights_sum_to_one(preset):
    js = weighted_gemms(get_arch("mixtral_8x7b"), get_preset(preset))
    w = np.asarray(js.weights)
    assert w.sum() == pytest.approx(1.0, abs=1e-12)
    assert (w > 0).all()
    assert js.macs_per_token > 0
    dec = js.regime_weights("decode").sum()
    pre = js.regime_weights("prefill").sum()
    assert dec + pre == pytest.approx(1.0, abs=1e-12)


def test_jobset_bit_deterministic():
    cfg = get_arch("jamba_v01_52b")
    tm = get_preset("decode_heavy")
    a = weighted_gemms(cfg, tm)
    _assert_jobset_equal(a, weighted_gemms(cfg, tm))
    c = weighted_gemms(cfg, dataclasses.replace(tm, seed=3))
    assert not np.array_equal(np.asarray(a.weights), np.asarray(c.weights))


def test_jobset_mac_conservation():
    cfg = get_arch("qwen3_8b")
    tm = get_preset("balanced")
    js = weighted_gemms(cfg, tm)
    total = 0.0
    for tc in traffic_classes(tm):
        step = sum(sg.macs for sg in expand_arch(cfg, tc.regime, tc.batch, tc.seq_len))
        total += tc.execs_per_s * step
    assert float(np.asarray(js.mac_rate).sum()) == pytest.approx(total, rel=1e-12)
    assert js.macs_per_token == pytest.approx(total / js.tokens_per_s, rel=1e-12)


def test_preset_regime_shares():
    cfg = get_arch("mixtral_8x7b")
    dec_share = lambda p: float(weighted_gemms(cfg, get_preset(p)).regime_weights("decode").sum())
    assert dec_share("decode_heavy") > 0.6
    assert dec_share("prefill_heavy") < 0.1
    assert dec_share("decode_heavy") > dec_share("balanced") > dec_share("prefill_heavy")


def test_with_ratio_rescales_gen_mean():
    tm = get_preset("balanced")
    t2 = tm.with_ratio(4.0)
    assert t2.prefill_decode_ratio == pytest.approx(4.0)
    assert t2.prompt_len == tm.prompt_len
    assert dataclasses.asdict(t2) == dataclasses.asdict(
        ref_serving.get_preset("balanced").with_ratio(4.0))
    with pytest.raises(ValueError):
        tm.with_ratio(0.0)


def test_traffic_model_validation():
    with pytest.raises(ValueError, match="qps"):
        TrafficModel("x", qps=0.0, prompt_len=(64.0, 0.5), gen_len=(64.0, 0.5))
    with pytest.raises(ValueError, match="gen_len"):
        TrafficModel("x", qps=1.0, prompt_len=(64.0, 0.5), gen_len=(0.5, 0.5))
    with pytest.raises(KeyError):
        get_preset("nope")


# ---------------------------------------------------------------------------
# Ratio sweep moves the design optimum (regression-pinned)
# ---------------------------------------------------------------------------


def test_ratio_sweep_moves_optimum():
    cfg = get_arch("mixtral_8x7b")
    tm = get_preset("balanced")
    axes = dict(rows=(16, 32), cols=(8, 32, 128), input_bits=(16,), dataflows=("WS", "OS"),
                bus_invert=(False, True))
    grid, ref_grid = DesignSpace(**axes).expand(), ref_ds.DesignSpace(**axes).expand()
    families = ("uniform", "serpentine2", "pods2x2", "pods4x4")
    cells, shares = {}, {}
    for ratio in (0.05, 4.0, 48.0):
        js = weighted_gemms(cfg, tm.with_ratio(ratio))
        shares[ratio] = float(js.regime_weights("decode").sum())
        rng = np.random.default_rng(7)
        a_h = rng.uniform(0.1, 0.4, (len(js.gemms), grid.n_points))
        a_v = rng.uniform(0.2, 0.6, (len(js.gemms), grid.n_points))
        ev = evaluate_fleet_objective(
            grid, a_h, a_v, js.gemms, layouts=families, weights=js.weights,
            macs_per_token=js.macs_per_token, engine="torch",
        )
        j = np.asarray(ev.j_per_mac_robust)
        cells[ratio] = tuple(int(i) for i in np.unravel_index(np.argmin(j), j.shape))
        if ratio == 4.0:
            want = ref_obj.evaluate_fleet_objective(
                ref_grid, a_h, a_v, [ref_wl.Gemm(*_gemm_tuple(g)) for g in js.gemms],
                layouts=families, weights=js.weights, macs_per_token=js.macs_per_token,
                use_jit=False)
            ok = np.isfinite(want.j_per_mac)
            assert np.array_equal(np.isfinite(ev.j_per_mac), ok)
            np.testing.assert_allclose(ev.j_per_mac[ok], want.j_per_mac[ok], rtol=RTOL, atol=0)
    assert shares[0.05] > shares[4.0] > shares[48.0]
    assert shares[0.05] == pytest.approx(0.8469, abs=0.05)
    assert shares[48.0] == pytest.approx(0.0172, abs=0.02)
    assert cells[0.05] != cells[48.0], cells


# ---------------------------------------------------------------------------
# J/token aggregation slot
# ---------------------------------------------------------------------------


def _tiny_eval(macs_per_token=None):
    grid = DesignSpace(rows=(8,), cols=(8, 16), input_bits=(8,), dataflows=("WS",)).expand()
    gemms = [Gemm("a", 64, 32, 16), Gemm("b", 8, 32, 16)]
    rng = np.random.default_rng(0)
    a_h = rng.uniform(0.1, 0.4, (2, grid.n_points))
    a_v = rng.uniform(0.2, 0.6, (2, grid.n_points))
    return evaluate_fleet_objective(grid, a_h, a_v, gemms, layouts=("uniform",),
                                    macs_per_token=macs_per_token, engine="torch")


def test_j_per_token_is_j_per_mac_times_macs_per_token():
    ev = _tiny_eval(macs_per_token=1.5e9)
    assert ev.macs_per_token == 1.5e9
    got = np.asarray(ev.j_per_token_robust)
    assert np.array_equal(got, np.asarray(ev.j_per_mac_robust) * 1.5e9)
    assert np.isfinite(got).any()


def test_j_per_token_requires_both_halves():
    ev = _tiny_eval()
    with pytest.raises(ValueError, match="macs_per_token"):
        _ = ev.j_per_token_robust
    with pytest.raises(ValueError, match="positive"):
        _tiny_eval(macs_per_token=0.0)


def test_serving_jobset_through_objective():
    js = weighted_gemms(get_arch("qwen3_8b"), get_preset("decode_heavy"))
    grid = DesignSpace(rows=(16,), cols=(8, 16), input_bits=(16,),
                       dataflows=("WS", "OS")).expand()
    rng = np.random.default_rng(1)
    a_h = rng.uniform(0.1, 0.4, (len(js.gemms), grid.n_points))
    a_v = rng.uniform(0.2, 0.6, (len(js.gemms), grid.n_points))
    ev = evaluate_fleet_objective(grid, a_h, a_v, js.gemms, layouts=("uniform", "pods2x2"),
                                  weights=js.weights, macs_per_token=js.macs_per_token,
                                  engine="numpy")
    jpt = np.asarray(ev.j_per_token_robust)
    assert jpt.shape == (2, grid.n_points)
    assert np.isfinite(jpt).any() and (jpt[np.isfinite(jpt)] > 0).all()


# ---------------------------------------------------------------------------
# Measured activities over a GEMM job set: dedup + determinism
# ---------------------------------------------------------------------------


def test_gemm_profile_seed_content_keyed():
    g1 = Gemm("dec.q", 64, 4096, 4096)
    g2 = Gemm("pre.q", 64, 4096, 4096)
    clip = (128, 512, 256)
    assert gemm_profile_seed(g1, clip=clip) == gemm_profile_seed(g2, clip=clip)
    g3 = Gemm("x", 64, 600, 4096)
    assert gemm_profile_seed(g1, clip=clip) == gemm_profile_seed(g3, clip=clip)
    assert gemm_profile_seed(g1, clip=clip) != gemm_profile_seed(g1, clip=clip, density=0.5)
    assert gemm_profile_seed(g1, clip=None) != gemm_profile_seed(g3, clip=None)
    assert gemm_profile_seed(g1, clip=clip) == ref_wl.gemm_profile_seed(
        ref_wl.Gemm(*_gemm_tuple(g1)), clip=clip)


def test_measured_gemm_activities_dedup_and_determinism():
    axes = dict(rows=(8,), cols=(8,), input_bits=(8,), dataflows=("WS", "OS"))
    grid = DesignSpace(**axes).expand()
    clip = (16, 32, 16)
    gemms = [Gemm("a", 16, 32, 16), Gemm("b", 999, 4096, 777), Gemm("c", 4, 32, 16)]
    a_h, a_v, stats = measured_design_gemm_activities(
        grid, gemms, clip=clip, backend="torch", use_cache=False, return_stats=True)
    assert a_h.shape == a_v.shape == (3, grid.n_points)
    assert ((0 <= a_h) & (a_h <= 1)).all() and ((0 <= a_v) & (a_v <= 1)).all()
    assert np.array_equal(a_h[0], a_h[1]) and np.array_equal(a_v[0], a_v[1])
    assert not np.array_equal(a_h[0], a_h[2])
    b_h, b_v = measured_design_gemm_activities(grid, gemms, clip=clip, backend="torch")
    assert np.array_equal(a_h, b_h) and np.array_equal(a_v, b_v)
    r_h, r_v, r_stats = ref_wl.measured_design_gemm_activities(
        ref_ds.DesignSpace(**axes).expand(), [ref_wl.Gemm(*_gemm_tuple(g)) for g in gemms],
        clip=clip, backend="pallas", use_cache=False, return_stats=True)
    assert np.array_equal(a_h, r_h) and np.array_equal(a_v, r_v)
    assert (stats.jobs, stats.passes, stats.tasks, stats.strips) == (
        r_stats.jobs, r_stats.passes, r_stats.tasks, r_stats.strips)


# ---------------------------------------------------------------------------
# codesign end to end
# ---------------------------------------------------------------------------

SMALL_AXES = dict(rows=(8, 16), cols=(8, 16), input_bits=(8,), dataflows=("WS", "OS"),
                  bus_invert=(False, True))
SMALL_FAMILIES = ("uniform", "pods2x2")
SMALL_CLIP = (32, 64, 32)


@pytest.mark.parametrize("engine", ["torch", "numpy"])
def test_codesign_small_space_matches_reference(engine, tmp_path):
    got = codesign("qwen3_8b", "decode_heavy", space=DesignSpace(**SMALL_AXES),
                   layouts=SMALL_FAMILIES, clip=SMALL_CLIP, backend="torch", engine=engine,
                   use_cache=False)
    want = ref_serving.codesign("qwen3_8b", "decode_heavy",
                                space=ref_ds.DesignSpace(**SMALL_AXES), layouts=SMALL_FAMILIES,
                                clip=SMALL_CLIP, backend="pallas", use_jit=False,
                                use_cache=False)
    _assert_jobset_equal(got.jobset, want.jobset)
    for f in ("j_per_mac", "j_per_mac_robust", "j_per_token_robust", "bus_power_robust"):
        g, w_ = np.asarray(getattr(got.eval, f)), np.asarray(getattr(want.eval, f))
        ok = np.isfinite(w_)
        assert np.array_equal(np.isfinite(g), ok), f
        np.testing.assert_allclose(g[ok], w_[ok], rtol=RTOL, atol=0, err_msg=f)
    assert np.array_equal(got.eval.utilization, want.eval.utilization)
    assert got.best_cell == want.best_cell
    for regime in ("decode", "prefill"):
        assert got.regime_cell(regime) == want.regime_cell(regime)
    assert got.describe_cell(got.best_cell) == want.describe_cell(want.best_cell)
    assert got.j_per_token == pytest.approx(want.j_per_token, rel=RTOL)
    # the same pricing through the checkpointed chunk runner, bit for bit
    swept = codesign("qwen3_8b", "decode_heavy", space=DesignSpace(**SMALL_AXES),
                     layouts=SMALL_FAMILIES, clip=SMALL_CLIP, backend="torch", engine=engine,
                     sweep=SweepConfig(chunk_size=5, store=tmp_path / "s"))
    assert swept.eval.sweep_report.rung_counts() == {engine: 4}
    for f in ("j_per_mac", "j_per_mac_robust", "utilization", "feasible"):
        assert np.asarray(getattr(swept.eval, f)).tobytes() == np.asarray(
            getattr(got.eval, f)).tobytes(), f


def test_cnn_reference_matches_reference():
    space = DesignSpace(rows=(16, 32), cols=(16, 32), input_bits=(16,), dataflows=("WS", "OS"))
    cell, ev = cnn_reference(space=space, layouts=SMALL_FAMILIES, n_layers=1, backend="torch",
                             engine="torch", use_cache=False)
    want_cell, want = ref_serving.cnn_reference(
        space=ref_ds.DesignSpace(rows=(16, 32), cols=(16, 32), input_bits=(16,),
                                 dataflows=("WS", "OS")),
        layouts=SMALL_FAMILIES, n_layers=1, backend="pallas", use_jit=False, use_cache=False)
    assert cell == want_cell
    ok = np.isfinite(want.j_per_mac_robust)
    np.testing.assert_allclose(ev.j_per_mac_robust[ok], want.j_per_mac_robust[ok], rtol=RTOL)


def test_codesign_engine_and_backend_never_fall_back(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    kw = dict(space=DesignSpace(rows=(8,), cols=(8,), input_bits=(8,)), layouts=("uniform",),
              clip=(8, 16, 8), use_cache=False)
    with pytest.raises(CudaUnavailableError):
        codesign("qwen3_8b", "decode_heavy", backend="torch", **kw)  # engine="cuda"
    with pytest.raises(RuntimeError, match="CUDA device"):
        codesign("qwen3_8b", "decode_heavy", backend="auto", engine="torch", **kw)
    with pytest.raises(CudaUnavailableError):
        cnn_reference(space=kw["space"], layouts=("uniform",), n_layers=1, backend="torch")


def test_mixtral_decode_heavy_matches_reference_file():
    """The chip check's cell at full width on the CPU: Mixtral-8x7B under
    decode_heavy (72 shape classes, DEFAULT_SPACE x DEFAULT_FAMILIES) through
    the plain versions, against the JAX package's file."""
    ref = SERVING_REFERENCE
    res = codesign(ref["arch"], ref["traffic"], backend="torch", engine="torch",
                   use_cache=False)
    js = res.jobset
    assert [list(_gemm_tuple(g)) for g in js.gemms] == ref["jobset"]["gemms"]
    assert js.weights.tolist() == ref["jobset"]["weights"]
    assert list(js.densities) == ref["jobset"]["densities"]
    assert js.macs_per_token == ref["jobset"]["macs_per_token"]
    assert list(res.layouts) == ref["layouts"] == list(DEFAULT_FAMILIES)
    assert res.grid.n_points == DEFAULT_SPACE.n_points == len(ref["a_h"][0])
    a_h, a_v = measured_design_gemm_activities(
        res.grid, js.gemms, densities=js.densities, backend="torch")
    assert np.array_equal(a_h, ref["a_h"]) and np.array_equal(a_v, ref["a_v"])
    for f in ("j_per_mac", "j_per_mac_robust", "j_per_token_robust"):
        g, w_ = np.asarray(getattr(res.eval, f)), np.asarray(ref[f], float)
        ok = np.isfinite(w_)
        assert np.array_equal(np.isfinite(g), ok), f
        np.testing.assert_allclose(g[ok], w_[ok], rtol=RTOL, atol=0, err_msg=f)
    assert list(res.best_cell) == ref["best_cell"]
    assert {r: list(res.regime_cell(r)) for r in ("decode", "prefill")} == ref["regime_cells"]


def test_serving_reference_file_is_what_the_jax_package_computes():
    assert dumps_compact(build_serving_reference()) == SERVING_REFERENCE_PATH.read_text()
