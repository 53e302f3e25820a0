"""The port's lane-resolved profiles against the JAX package.

``profile_gemm(..., lane_detail=True)`` on the port's ``"torch"`` backend
(the lane passes as PyTorch programs on the CPU) and ``"numpy"`` backend
(the lane oracle) must give the reference's lane counts bit for bit, from
its lane passes (``backend="pallas"``, XLA on the CPU) and its numpy oracle.
The port's own cases mirror ``tests/test_switching.py``'s lane tests and
``tests/test_profile_store.py::test_store_roundtrip_lane_detail``.
"""

import ctypes
import dataclasses

import numpy as np
import pytest
import torch

import repro.kernels.activity_profile.ops as ref_ops
from repro.core.switching import profile_gemm as ref_profile_gemm
from repro.core.switching import stream_lane_toggles as ref_stream_lane_toggles
from repro.core.workloads import profile_conv_layer as ref_profile_conv_layer
from repro_torch.core.switching import (
    ActivityProfile,
    _cache_key,
    clear_profile_cache,
    combine_profiles,
    configure_profile_store,
    profile_cache_info,
    profile_gemm,
    stream_lane_toggles,
    stream_toggle_rate,
)
from repro_torch.core.workloads import ConvLayer, profile_conv_layer
from repro_torch.kernels import _engine
from repro_torch.kernels.activity_profile import kernel as K
from repro_torch.kernels.activity_profile import ops


def _rand_gemm(seed=0, m=23, k=21, n=13):
    rng = np.random.default_rng(seed)
    a = rng.integers(-60, 200, (m, k)).astype(np.int64)
    a[a < 0] = 0
    w = rng.integers(-70, 70, (k, n)).astype(np.int64)
    return a, w


def _ref(profile) -> ActivityProfile:
    return ActivityProfile.from_dict(dataclasses.asdict(profile))


# --- the reference's lane tests, on the port ---------------------------------


@pytest.mark.parametrize("dataflow,b_v", [("WS", 37), ("OS", 16)])
def test_lane_detail_backends_bit_exact_and_sum_to_aggregate(dataflow, b_v):
    """torch lane passes == numpy lane oracle == the reference's lane passes
    and oracle, and the lane sums reproduce the aggregate counts."""
    a, w = _rand_gemm()
    kw = dict(dataflow=dataflow, lane_detail=True, use_cache=False)
    p_np = profile_gemm(a, w, 8, 4, 16, b_v, backend="numpy", **kw)
    p_t = profile_gemm(a, w, 8, 4, 16, b_v, backend="torch", **kw)
    assert p_t == p_np
    assert p_t == _ref(ref_profile_gemm(a, w, 8, 4, 16, b_v, backend="pallas", **kw))
    assert p_t == _ref(ref_profile_gemm(a, w, 8, 4, 16, b_v, backend="numpy", **kw))
    assert len(p_t.h_lane_toggles) == 16
    assert len(p_t.v_lane_toggles) == b_v
    agg = profile_gemm(a, w, 8, 4, 16, b_v, dataflow=dataflow, backend="torch", use_cache=False)
    assert sum(p_t.h_lane_toggles) == round(agg.a_h * agg.h_transitions * 16)
    assert sum(p_t.v_lane_toggles) == round(agg.a_v * agg.v_transitions * b_v)
    assert (p_t.h_transitions, p_t.v_transitions) == (agg.h_transitions, agg.v_transitions)
    assert p_t.a_h == pytest.approx(agg.a_h, abs=1e-15)
    assert p_t.a_v == pytest.approx(agg.a_v, abs=1e-15)
    np.testing.assert_allclose(p_t.a_h_lanes.mean(), p_t.a_h)
    np.testing.assert_allclose(p_t.a_v_lanes.mean(), p_t.a_v)


def test_lane_detail_sign_extension_lanes():
    """Bus lanes above bit 31 of an operand stream are copies of its sign
    lane: they all carry the sign-flip count (WS h bus widened past 32)."""
    a, w = _rand_gemm(seed=3, m=17, k=9, n=5)
    a[::2] -= 90
    kw = dict(lane_detail=True, use_cache=False)
    p = profile_gemm(a, w, 4, 4, 40, 48, backend="numpy", **kw)
    lanes = np.asarray(p.h_lane_toggles)
    assert (lanes[32:] == lanes[32]).all() and lanes[32] > 0
    p_t = profile_gemm(a, w, 4, 4, 40, 48, backend="torch", **kw)
    assert p_t == p
    assert p_t == _ref(ref_profile_gemm(a, w, 4, 4, 40, 48, backend="pallas", **kw))


def test_lane_detail_rejects_subsampling():
    a, w = _rand_gemm()
    with pytest.raises(ValueError, match="lane_detail requires exact"):
        profile_gemm(a, w, 8, 4, 16, 37, max_tiles=1, lane_detail=True, backend="torch")


def test_lane_detail_cache_key_v4_no_alias():
    """Lane-detailed and aggregate profiles of identical operands never share
    a cache entry (the v4 key), and lane profiles do cache."""
    a, w = _rand_gemm(seed=5)
    clear_profile_cache()
    p_agg = profile_gemm(a, w, 8, 4, 16, 37, backend="torch")
    p_lane = profile_gemm(a, w, 8, 4, 16, 37, backend="torch", lane_detail=True)
    info = profile_cache_info()
    assert info["misses"] == 2 and info["hits"] == 0
    assert p_agg.h_lane_toggles is None and p_lane.h_lane_toggles is not None
    assert profile_gemm(a, w, 8, 4, 16, 37, backend="torch", lane_detail=True) == p_lane
    assert profile_cache_info()["hits"] == 1
    k_agg = _cache_key(a, w, 8, 4, 16, 37, ("torch", "WS", "exact"))
    k_lane = _cache_key(a, w, 8, 4, 16, 37, ("torch", "WS", "exact", "lanes"))
    assert k_agg != k_lane
    clear_profile_cache()


def test_combine_profiles_sums_lane_counts():
    a, w = _rand_gemm(seed=7)
    a2, w2 = _rand_gemm(seed=8, m=19)
    kw = dict(lane_detail=True, use_cache=False, backend="torch")
    p1 = profile_gemm(a, w, 8, 4, 16, 37, **kw)
    p2 = profile_gemm(a2, w2, 8, 4, 16, 37, **kw)
    comb = combine_profiles([p1, p2])
    assert comb.h_lane_toggles == tuple(x + y for x, y in zip(p1.h_lane_toggles, p2.h_lane_toggles))
    assert comb.v_lane_toggles == tuple(x + y for x, y in zip(p1.v_lane_toggles, p2.v_lane_toggles))
    p3 = profile_gemm(a, w, 8, 4, 16, 37, use_cache=False, backend="torch")
    assert combine_profiles([p1, p3]).h_lane_toggles is None


def test_stream_lane_toggles_sum_matches_rate():
    s = np.random.default_rng(11).integers(-300, 300, (29, 7))
    lanes = stream_lane_toggles(s, 12)
    assert np.array_equal(lanes, ref_stream_lane_toggles(s, 12))
    assert lanes.sum() == round(stream_toggle_rate(s, 12) * 12 * (29 - 1) * 7)


def test_store_roundtrip_lane_detail(tmp_path):
    """A lane-resolved profile written by profile_gemm comes back from the
    on-disk store with its lane tuples, equal to the one computed."""
    a, w = _rand_gemm(seed=9)
    configure_profile_store(tmp_path / "store")
    try:
        clear_profile_cache()
        p = profile_gemm(a, w, 8, 4, 16, 37, backend="torch", lane_detail=True)
        clear_profile_cache()
        got = profile_gemm(a, w, 8, 4, 16, 37, backend="torch", lane_detail=True)
        assert profile_cache_info()["store_hits"] == 1
        assert got == p and isinstance(got.v_lane_toggles, tuple)
    finally:
        configure_profile_store(None)
        clear_profile_cache()


# --- the lane passes against the reference's, at their edges -----------------

# (M, K, N, rows, cols, b_h, b_v, dataflow): T = 2, K below rows, N off the
# column groups, b_v of 33-64 (the high lanes of the int64 sums), b_h past
# 32 (the sign lane repeated), b_v below 16 (lanes truncated).  Then the
# edges of L1 and L2 (chip_smoke.py's LANE_EDGE_CASES): b_v of 1, 16, 32
# and 37 (one run of 15 transitions and a partial one), M = 3, K off rows
# and past one staged chunk of 32 rows, N = 1, N past one block's 128
# columns, b_h of 8 and 33, and an operand stream wider than one L2 block
# of 256 lanes.
EDGES = [
    (2, 5, 3, 8, 8, 16, 37, "WS"),
    (19, 5, 7, 8, 4, 16, 33, "WS"),
    (33, 70, 10, 16, 8, 16, 64, "WS"),
    (40, 17, 33, 16, 32, 40, 48, "WS"),
    (12, 9, 9, 4, 4, 8, 12, "WS"),
    (2, 3, 4, 8, 8, 16, 16, "OS"),
    (30, 25, 40, 8, 16, 33, 50, "OS"),
    (3, 20, 1, 8, 8, 8, 1, "WS"),
    (17, 40, 130, 16, 32, 16, 16, "WS"),
    (31, 70, 33, 48, 32, 33, 32, "WS"),
    (46, 45, 65, 32, 32, 16, 37, "WS"),
    (3, 7, 300, 8, 8, 8, 1, "OS"),
    (16, 50, 33, 8, 8, 16, 37, "OS"),
]


@pytest.mark.parametrize("case", EDGES, ids=lambda c: "-".join(map(str, c)))
def test_lane_toggles_match_reference_at_int16_extremes(case):
    m, k, n, rows, cols, b_h, b_v, dataflow = case
    rng = np.random.default_rng(list(case[:7]))
    a = rng.choice([-32767, 32767, -1, 0, 1, 12345], size=(m, k))
    w = rng.choice([-32767, 32767, -1, 0, 1, -23456], size=(k, n))
    got = ops.profile_gemm_lane_toggles(a, w, rows, cols, b_h, b_v, dataflow=dataflow, engine="torch")
    want = ref_ops.profile_gemm_lane_toggles(a, w, rows, cols, b_h, b_v, dataflow=dataflow)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    agg = ops.profile_gemm_toggles(a, w, rows, cols, b_h, b_v, dataflow=dataflow, engine="torch")
    assert got.totals() == agg


def test_lane_passes_carry_across_blocks(monkeypatch):
    """Blocks of a few values (every time step its own block, strips split)
    give the counts of one block, and the numpy oracle's."""
    a, w = _rand_gemm(seed=2, m=41, k=19, n=11)
    a[1::3] *= -1
    whole = ops.profile_gemm_lane_toggles(a, w, 8, 4, 16, 37, engine="torch")
    monkeypatch.setattr(K, "LANE_BLOCK_ELEMENTS", 5)
    assert ops.profile_gemm_lane_toggles(a, w, 8, 4, 16, 37, engine="torch") == whole
    oracle = profile_gemm(a, w, 8, 4, 16, 37, backend="numpy", lane_detail=True, use_cache=False)
    assert whole.h_lanes == oracle.h_lane_toggles
    assert whole.v_lanes == oracle.v_lane_toggles


# (bits, (T, L)): every bus width on a (37, 6) stream, then L2's edges:
# T = 2 and 3, one lane, many 15-step chunks and a short last group, lanes
# past one block of 256 threads.
STREAM_CASES = [pytest.param(bits, (37, 6), id=str(bits)) for bits in (1, 12, 32, 33, 64, 8, 16)]
STREAM_CASES += [pytest.param(bits, shape, id=f"{bits}-{shape[0]}x{shape[1]}")
                 for shape in ((2, 1), (3, 300), (482, 33)) for bits in (8, 16, 33)]


@pytest.mark.parametrize("bits,shape", STREAM_CASES)
def test_stream_lane_totals_match_reference(bits, shape):
    x = np.random.default_rng(bits).integers(-32767, 32768, shape)
    got = ops.stream_lane_toggle_totals(x, bits, engine="torch")
    assert np.array_equal(got, ref_ops.stream_lane_toggle_totals(x, bits))
    assert got.sum() == ops.stream_toggle_total(x, bits, engine="torch")
    assert K.compact_lanes(bits) == ref_ops._compact_lanes(bits)
    compact = np.arange(K.compact_lanes(bits))
    assert np.array_equal(ops._expand_sign_lanes(compact, bits), ref_ops._expand_sign_lanes(compact, bits))


def test_lane_contracts_match_reference():
    a, w = _rand_gemm()
    for fn, eng in ((ops.profile_gemm_lane_toggles, {"engine": "torch"}),
                    (ref_ops.profile_gemm_lane_toggles, {})):
        with pytest.raises(ValueError, match="bad GEMM shapes"):
            fn(a, w[:-1], 8, 4, 16, 37, **eng)
        with pytest.raises(ValueError, match="bus widths"):
            fn(a, w, 8, 4, 16, 65, **eng)
        with pytest.raises(ValueError, match="int16-range"):
            fn(a * 1000, w, 8, 4, 16, 37, **eng)
        with pytest.raises(ValueError, match="unknown dataflow"):
            fn(a, w, 8, 4, 16, 37, dataflow="XS", **eng)
        with pytest.raises(ValueError, match="int16-range"):
            (ops.stream_lane_toggle_totals if fn is ops.profile_gemm_lane_toggles
             else ref_ops.stream_lane_toggle_totals)(a * 1000, 16, **eng)


def test_cuda_engine_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a, w = _rand_gemm()
    with pytest.raises(_engine.CudaUnavailableError):
        ops.profile_gemm_lane_toggles(a, w, 8, 4, 16, 37)
    with pytest.raises(_engine.CudaUnavailableError):
        ops.stream_lane_toggle_totals(a, 16)
    with pytest.raises(_engine.CudaUnavailableError):
        profile_gemm(a, w, 8, 4, 16, 37, backend="cuda", lane_detail=True, use_cache=False)
    # L1 and L2 themselves: a tensor taken for a card tensor launches the
    # kernel, and a launch that cannot happen raises; no plain version
    # stands in and no launch is counted
    a_t = torch.from_numpy(a.astype(np.int32))
    w_t = torch.from_numpy(w.astype(np.int32))

    def no_card(*args):
        raise _engine.CudaUnavailableError("no CUDA device")

    monkeypatch.setattr(K, "on_cpu", lambda x, name: False)
    monkeypatch.setattr(K, "launch", no_card)
    before = (K.ws_lane_toggles.launches, K.stream_lane_toggles.launches)
    with pytest.raises(_engine.CudaUnavailableError):
        K.ws_lane_toggles(a_t, w_t, 8, 37)
    with pytest.raises(_engine.CudaUnavailableError):
        K.stream_lane_toggles(a_t, 16)
    assert (K.ws_lane_toggles.launches, K.stream_lane_toggles.launches) == before
    monkeypatch.undo()
    with pytest.raises(ValueError, match="runs on cpu or cuda tensors"):
        K.stream_lane_toggles(a_t.to("meta"), 16)


@pytest.mark.parametrize("dataflow", ["WS", "OS"])
def test_card_route_calls_no_plain_version(monkeypatch, dataflow):
    """With the route resolved for a CUDA device, the lane profile launches
    L2 (and L1 under WS) once a pass and never calls a plain version."""
    def plain(*args, **kw):
        raise AssertionError("a plain version ran on the card route")

    launched = []

    def fake_launch(source, fn_name, device, *args):
        # zero the output, as the C entry does: (a, w, out, ...) for L1,
        # (x, out, t, lanes, bits) for L2
        out, size = (args[2], 8 * args[7]) if fn_name == "ws_lane_toggles" else (
            args[1], 8 * K.compact_lanes(args[4]))
        ctypes.memset(out, 0, size)
        launched.append((source, fn_name))

    for name in ("ws_lane_toggles_plain", "stream_lane_toggles_plain", "_lane_counts"):
        monkeypatch.setattr(K, name, plain)
    monkeypatch.setattr(ops, "engine_device", lambda engine: torch.device("cpu"))
    monkeypatch.setattr(K, "on_cpu", lambda x, name: False)
    monkeypatch.setattr(K, "launch", fake_launch)
    a, w = _rand_gemm()
    before = (K.ws_lane_toggles.launches, K.stream_lane_toggles.launches)
    got = ops.profile_gemm_lane_toggles(a, w, 8, 4, 16, 37, dataflow=dataflow, engine="cuda")
    l1, l2 = ("lane_toggles", "ws_lane_toggles"), ("lane_toggles", "stream_lane_toggles")
    assert launched == ([l2, l1] if dataflow == "WS" else [l2, l2])
    assert (K.ws_lane_toggles.launches - before[0], K.stream_lane_toggles.launches - before[1]) == (
        (1, 1) if dataflow == "WS" else (0, 2))
    assert sum(got.h_lanes) == sum(got.v_lanes) == 0
    ops.stream_lane_toggle_totals(a, 33, engine="cuda")
    assert launched[-1] == ("lane_toggles", "stream_lane_toggles")


@pytest.mark.parametrize("dataflow", ["WS", "OS"])
def test_profile_conv_layer_lane_detail_matches_reference(dataflow):
    layer = ConvLayer("T1", k=1, h=6, w=6, c=32, m=24, input_density=0.5)
    kw = dict(rows=8, cols=8, bits=8, seed=1, dataflow=dataflow, use_cache=False, lane_detail=True)
    got = profile_conv_layer(layer, backend="torch", **kw)
    assert got == _ref(ref_profile_conv_layer(layer, backend="numpy", **kw))
