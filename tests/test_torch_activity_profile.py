"""The port's activity engine against the JAX package, on the CPU.

The port's plain versions of kernels K1 (WS) and K4 (OS), its numpy oracle
and its ``profile_gemm`` dispatch must give toggle counts bit-identical to
the reference package's XLA engine and numpy oracle, on the reference's own
test matrices (``tests/test_activity_profile.py`` CASES / OS_CASES).  The
CUDA kernels themselves run only on the card (``tests/test_torch_cuda.py``
and ``chip_smoke.py``); here the wrappers take the plain path because the
tensors lie on the CPU.
"""

import dataclasses
import warnings

import numpy as np
import pytest
import torch

from repro.core.switching import popcount as ref_popcount
from repro.core.switching import profile_gemm as ref_profile_gemm
from repro.kernels.activity_profile.ops import profile_gemm_toggles as ref_toggles
from repro.kernels.activity_profile.ref import profile_gemm_toggles_ref as ref_oracle
from repro_torch.core import switching
from repro_torch.core.switching import (
    ActivityProfile,
    clear_profile_cache,
    combine_profiles,
    popcount,
    profile_cache_info,
    profile_gemm,
)
from repro_torch.kernels.activity_profile import kernel as K
from repro_torch.kernels.activity_profile.ops import (
    ToggleCounts,
    operands_fit_fused,
    profile_gemm_toggles,
    stream_toggle_total,
)
from repro_torch.kernels.activity_profile.ref import profile_gemm_toggles_ref
from repro_torch.kernels.bitops import bus_mask, popcount64
from repro_torch.runtime.resilience import (
    ContractViolationError,
    ProfileDegradationWarning,
)

CASES = [
    # m, k, n, rows, cols, b_h, b_v
    (7, 5, 3, 32, 32, 16, 37),
    (64, 64, 48, 32, 32, 16, 37),
    (100, 37, 29, 16, 8, 8, 20),
    (33, 70, 10, 32, 32, 16, 64),
    (2, 1, 1, 8, 8, 16, 37),
    (17, 16, 16, 16, 16, 32, 32),
    (257, 40, 33, 16, 16, 37, 33),  # b_h > 32: sign-extension toggles
    (1025, 96, 64, 32, 32, 16, 37),  # long stream: many seed rows
]
OS_CASES = [
    (7, 5, 3, 32, 32, 16, 16),
    (64, 64, 48, 32, 32, 16, 16),
    (100, 37, 29, 16, 8, 8, 8),
    (33, 70, 10, 32, 32, 16, 64),
    (1, 2, 1, 8, 8, 16, 37),
    (17, 16, 16, 16, 16, 32, 32),
    (257, 40, 33, 16, 16, 37, 33),
    (12, 1025, 16, 8, 8, 16, 12),
]


def _rand_gemm(case, lo=-32767, hi=32768):
    m, k, n = case[:3]
    rng = np.random.default_rng(list(case))
    return rng.integers(lo, hi, size=(m, k)), rng.integers(lo, hi, size=(k, n))


def _tuple(t: ToggleCounts):
    return (t.h_toggles, t.v_toggles, t.h_transitions, t.v_transitions)


@pytest.mark.parametrize("case", CASES)
def test_ws_counts_match_reference_bit_exact(case):
    a, w = _rand_gemm(case)
    args = (a, w, *case[3:])
    want = ref_oracle(*args)
    assert _tuple(ref_toggles(*args, engine="xla")) == want
    assert profile_gemm_toggles_ref(*args) == want
    assert _tuple(profile_gemm_toggles(*args, engine="torch")) == want


@pytest.mark.parametrize("case", OS_CASES)
def test_os_counts_match_reference_bit_exact(case):
    a, w = _rand_gemm(case)
    args = (a, w, *case[3:])
    want = ref_oracle(*args, dataflow="OS")
    assert _tuple(ref_toggles(*args, dataflow="OS", engine="xla")) == want
    assert profile_gemm_toggles_ref(*args, dataflow="OS") == want
    assert _tuple(profile_gemm_toggles(*args, dataflow="OS", engine="torch")) == want


@pytest.mark.parametrize("block_t", [1, 7, 8, K.WS_KERNEL_STEPS, 31, 64])
def test_ws_plain_windows_recompute_seed_rows(block_t):
    """Windows of block_t transitions, each seeded with row t0 - 1 (the CUDA
    kernel's decomposition: runs of ``K.WS_KERNEL_STEPS``), give the
    whole-stream counts."""
    case = (100, 40, 24, 16, 8, 16, 37)
    a, w = _rand_gemm(case)
    want = ref_oracle(a, w, *case[3:])[:2]
    a_t = torch.from_numpy(a.astype(np.int32))
    w_t = torch.from_numpy(w.astype(np.int32))
    got = K.ws_activity_toggles_plain(a_t, w_t, *case[3:], block_t=block_t)
    assert tuple(got.tolist()) == want


@pytest.mark.parametrize("block_t", [1, 5, 8, 64])
def test_os_plain_windows_recompute_seed_rows(block_t):
    rng = np.random.default_rng(block_t)
    x = rng.integers(-32767, 32768, size=(100, 10))
    want = int(ref_popcount(
        (x[1:].astype(np.int64) ^ x[:-1].astype(np.int64)).view(np.uint64) & np.uint64(0xFFFF)
    ).sum())
    got = K.operand_stream_toggles_plain(torch.from_numpy(x.astype(np.int32)), 16, block_t=block_t)
    assert int(got.item()) == want
    assert stream_toggle_total(x, 16, engine="torch") == want


def test_37bit_partial_sums_exact_at_extremes():
    """Worst-case magnitudes: +/-32767 operands, R=32 deep: 37-bit sums."""
    a = np.full((64, 32), 32767, dtype=np.int64)
    a[::2] = -32767
    w = np.full((32, 8), 32767, dtype=np.int64)
    w[:, ::2] = -32767
    want = ref_oracle(a, w, 32, 8, 16, 37)
    assert _tuple(profile_gemm_toggles(a, w, 32, 8, 16, 37, engine="torch")) == want


def test_popcount_matches_int_bit_count():
    rng = np.random.default_rng(0)
    v = np.concatenate([
        rng.integers(-(2**63), 2**63 - 1, size=2000, dtype=np.int64),
        np.array([0, -1, 1, 2**63 - 1, -(2**63)], dtype=np.int64),
    ])
    want = [(int(x) & (2**64 - 1)).bit_count() for x in v]
    assert popcount64(torch.from_numpy(v)).tolist() == want
    assert popcount(v.view(np.uint64)).tolist() == want
    assert ref_popcount(v.view(np.uint64)).tolist() == want


def test_bus_mask_edges():
    assert bus_mask(1) == 1 and bus_mask(37) == 2**37 - 1 and bus_mask(64) == -1
    for bad in (0, 65):
        with pytest.raises(ValueError):
            bus_mask(bad)


def test_wrapper_runs_plain_version_for_cpu_tensors():
    case = (64, 64, 48, 32, 32, 16, 37)
    a, w = _rand_gemm(case)
    a_t = torch.from_numpy(a.astype(np.int32))
    w_t = torch.from_numpy(w.astype(np.int32))
    before = (K.ws_activity_toggles.launches, K.operand_stream_toggles.launches)
    got = K.ws_activity_toggles(a_t, w_t, *case[3:])
    assert got.dtype == torch.int64 and got.device.type == "cpu"
    assert tuple(got.tolist()) == ref_oracle(a, w, *case[3:])[:2]
    K.operand_stream_toggles(w_t, 16)
    # launches count CUDA launches only
    assert (K.ws_activity_toggles.launches, K.operand_stream_toggles.launches) == before


def test_wrappers_check_their_inputs():
    a = torch.zeros((8, 4), dtype=torch.int32)
    w = torch.zeros((4, 3), dtype=torch.int32)
    with pytest.raises(TypeError, match="int32"):
        K.ws_activity_toggles(a.long(), w, 4, 4, 16, 37)
    with pytest.raises(ValueError, match="contiguous"):
        K.ws_activity_toggles(torch.zeros((4, 8), dtype=torch.int32).T, w, 4, 4, 16, 37)
    with pytest.raises(ValueError, match="bad GEMM shapes"):
        K.ws_activity_toggles(a, w[:3], 4, 4, 16, 37)
    with pytest.raises(ValueError, match="bus widths"):
        K.ws_activity_toggles(a, w, 4, 4, 16, 65)
    with pytest.raises(ValueError, match="2-D"):
        K.operand_stream_toggles(torch.zeros(8, dtype=torch.int32), 16)
    with pytest.raises(ValueError, match="cpu or cuda"):
        K.operand_stream_toggles(torch.zeros((8, 4), dtype=torch.int32, device="meta"), 16)


def test_operand_width_contract():
    a = np.full((4, 4), 40000, dtype=np.int64)
    w = np.ones((4, 4), dtype=np.int64)
    assert not operands_fit_fused(a, w)
    assert not operands_fit_fused(np.array([[-(2**63)]]), w)  # abs() would wrap
    with pytest.raises(ValueError, match="int16-range"):
        profile_gemm_toggles(a, w, 4, 4, 16, 37, engine="torch")
    with pytest.raises(ValueError, match="int16-range"):
        stream_toggle_total(a, 16, engine="torch")
    with pytest.raises(ValueError, match="unknown engine"):
        profile_gemm_toggles(w, w, 4, 4, 16, 37, engine="xla")


def test_cuda_engine_and_auto_backend_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a, w = _rand_gemm((16, 8, 4), lo=0, hi=100)
    with pytest.raises(RuntimeError, match="engine='torch'"):
        profile_gemm_toggles(a, w, 8, 8, 16, 37, engine="cuda")
    for dataflow in ("WS", "OS"):
        with pytest.raises(RuntimeError, match="backend='torch'.*backend='numpy'"):
            profile_gemm(a, w, 8, 8, 16, 37, dataflow=dataflow, backend="auto", use_cache=False)
    monkeypatch.setattr(switching, "DEFAULT_BACKEND", "auto")
    with pytest.raises(RuntimeError, match="CUDA device"):
        profile_gemm(a, w, 8, 8, 16, 37, use_cache=False)


def test_env_default_backend_is_read(monkeypatch):
    monkeypatch.setattr(switching, "DEFAULT_BACKEND", "torch")
    a, w = _rand_gemm((16, 8, 4), lo=0, hi=100)
    p = profile_gemm(a, w, 8, 8, 16, 37, use_cache=False)
    assert p == profile_gemm(a, w, 8, 8, 16, 37, backend="numpy", use_cache=False)


def test_unknown_backend_is_a_contract_violation():
    a, w = _rand_gemm((4, 4, 4), lo=0, hi=10)
    with pytest.raises(ContractViolationError, match="unknown backend"):
        profile_gemm(a, w, 4, 4, 16, 37, backend="pallas")


@pytest.mark.parametrize("dataflow", ["WS", "OS"])
def test_auto_backend_degrades_to_numpy_for_wide_operands(dataflow):
    rng = np.random.default_rng(7)
    a = rng.integers(-(2**30), 2**30, size=(16, 8))
    w = rng.integers(-(2**30), 2**30, size=(8, 4))
    b_v = 16 if dataflow == "OS" else 37
    with pytest.warns(ProfileDegradationWarning):
        p = profile_gemm(a, w, 8, 8, 16, b_v, dataflow=dataflow, backend="auto", use_cache=False)
    ref = ref_profile_gemm(a, w, 8, 8, 16, b_v, dataflow=dataflow, backend="numpy", use_cache=False)
    assert p.as_dict() == dataclasses.asdict(ref)


def test_lane_detail_waits_for_its_slice():
    """lane_detail=True runs on the port (its lane passes came with their
    slice) and gives the reference's lane-resolved profile."""
    a, w = _rand_gemm((8, 4, 4), lo=0, hi=10)
    p = profile_gemm(a, w, 4, 4, 16, 37, backend="torch", lane_detail=True, use_cache=False)
    ref = ref_profile_gemm(a, w, 4, 4, 16, 37, backend="numpy", lane_detail=True, use_cache=False)
    assert p.as_dict() == ActivityProfile.from_dict(dataclasses.asdict(ref)).as_dict()


@pytest.mark.parametrize(
    "dataflow,limits",
    [("WS", {}), ("WS", {"max_tiles": 3, "max_stream": 64, "seed": 11}), ("OS", {})],
)
def test_profile_gemm_backends_match_reference_profiles(dataflow, limits):
    """torch and numpy backends give the reference package's profile, field
    for field (the subsample plan is drawn identically from the seed)."""
    a, w = _rand_gemm((300, 80, 70), lo=-1000, hi=1000)
    b_v = 16 if dataflow == "OS" else 37
    ref = ref_profile_gemm(
        a, w, 32, 32, 16, b_v, dataflow=dataflow, backend="pallas", use_cache=False, **limits
    )
    for backend in ("torch", "numpy"):
        p = profile_gemm(
            a, w, 32, 32, 16, b_v, dataflow=dataflow, backend=backend, use_cache=False, **limits
        )
        assert p.as_dict() == pytest.approx(dataclasses.asdict(ref), rel=1e-12)
        assert (p.h_transitions, p.v_transitions, p.input_elements) == (
            ref.h_transitions, ref.v_transitions, ref.input_elements,
        )
    fused = profile_gemm(a, w, 32, 32, 16, b_v, dataflow=dataflow, backend="torch",
                         use_cache=False, **limits)
    assert fused.as_dict() == dataclasses.asdict(ref)


def test_activity_profile_dict_round_trip():
    p = ActivityProfile(0.1, 0.2, 16, 37, 10, 12, 0.5, 100, (1, 2), (3,))
    d = p.as_dict()
    assert d["h_lane_toggles"] == [1, 2]
    assert ActivityProfile.from_dict(d) == p
    ref = ref_profile_gemm(*_rand_gemm((20, 8, 8), lo=0, hi=50), 8, 8, 16, 37, use_cache=False)
    assert ActivityProfile.from_dict(dataclasses.asdict(ref)).as_dict() == dataclasses.asdict(ref)


def test_profile_cache_hits_on_identical_content():
    clear_profile_cache()
    a, w = _rand_gemm((32, 16, 8), lo=0, hi=100)
    p1 = profile_gemm(a, w, 16, 8, 16, 37, backend="torch")
    p2 = profile_gemm(a.astype(np.int32), w.copy(), 16, 8, 16, 37, backend="torch")
    info = profile_cache_info()
    assert info["hits"] == 1 and info["misses"] == 1 and info["size"] == 1
    assert p1 is p2
    assert profile_gemm(a, w, 16, 8, 16, 37, backend="torch", seed=123) is p1
    a2 = a.copy()
    a2[0, 0] += 1
    profile_gemm(a2, w, 16, 8, 16, 37, backend="torch")
    assert profile_cache_info()["misses"] == 2
    clear_profile_cache()
    info = profile_cache_info()
    assert info["size"] == info["hits"] == info["misses"] == info["evictions"] == 0


def test_profile_cache_distinguishes_geometry_backend_and_dataflow():
    clear_profile_cache()
    a, w = _rand_gemm((32, 16, 8), lo=0, hi=100)
    profile_gemm(a, w, 16, 8, 16, 37, backend="torch")
    profile_gemm(a, w, 8, 8, 16, 37, backend="torch")
    profile_gemm(a, w, 16, 8, 16, 40, backend="torch")
    assert profile_cache_info()["misses"] == 3
    pn = profile_gemm(a, w, 16, 8, 16, 37, backend="numpy")
    pt = profile_gemm(a, w, 16, 8, 16, 37, backend="torch")
    assert profile_cache_info()["misses"] == 4  # numpy missed; torch hit entry 1
    assert pn is not pt
    profile_gemm(a, w, 16, 8, 16, 37, backend="torch", dataflow="OS")
    assert profile_cache_info()["misses"] == 5
    key_t = switching._cache_key(a, w, 16, 8, 16, 37, ("torch", "WS", "exact"))
    key_c = switching._cache_key(a, w, 16, 8, 16, 37, ("cuda", "WS", "exact"))
    assert key_t != key_c
    clear_profile_cache()


def test_toggle_counts_add_and_activities():
    c = ToggleCounts(10, 20, 5, 8) + ToggleCounts(1, 2, 3, 4)
    assert c == ToggleCounts(11, 22, 8, 12)
    a_h, a_v = c.activities(b_h=2, b_v=4)
    assert a_h == 11 / (8 * 2) and a_v == 22 / (12 * 4)
    assert ToggleCounts(0, 0, 0, 0).activities(16, 37) == (0.0, 0.0)


def test_combine_zero_fraction_weighted_by_elements():
    tiny = ActivityProfile(0.1, 0.2, 16, 37, 10, 10, 1.0, input_elements=10)
    huge = ActivityProfile(0.1, 0.2, 16, 37, 10, 10, 0.0, input_elements=990)
    c = combine_profiles([tiny, huge])
    assert c.input_zero_fraction == pytest.approx(0.01)
    assert c.input_elements == 1000


def test_combine_zero_fraction_unweighted_fallback():
    p1 = ActivityProfile(0.1, 0.2, 16, 37, 10, 10, 1.0)
    p2 = ActivityProfile(0.1, 0.2, 16, 37, 10, 10, 0.0)
    assert combine_profiles([p1, p2]).input_zero_fraction == pytest.approx(0.5)


def test_no_degradation_warning_on_the_fused_path():
    a, w = _rand_gemm((32, 16, 8), lo=0, hi=100)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        profile_gemm(a, w, 16, 8, 16, 37, backend="torch", use_cache=False)
