"""Parity copy of ``tests/test_profile_store.py`` on the port's CPU path.

Crash-safe on-disk profile store: roundtrip (incl. lane-resolved
profiles), atomic-write crash safety, integrity quarantine + recompute,
LRU-by-mtime size bounding, the layered memory -> store -> compute lookup in
``repro_torch.core.switching``, and the in-memory cache
capacity/eviction/thrash satellites.  Profiling calls pass
``backend="torch"`` (the plain versions of the kernels, on the CPU).

The port's store writes the reference's entry format under the same schema
version, so each package reads what the other wrote, field for field.
"""

import dataclasses
import json
import os

from pathlib import Path

import numpy as np
import pytest

import repro.core.profile_store as ref_profile_store
from repro.core.switching import ActivityProfile as RefProfile
from repro.core.switching import profile_gemm as ref_profile_gemm
from repro.runtime import faults as ref_faults
from repro_torch.core.profile_store import STORE_VERSION, ProfileStore
from repro_torch.core.switching import (
    ActivityProfile,
    CacheThrashWarning,
    clear_profile_cache,
    configure_profile_store,
    profile_cache_info,
    profile_gemm,
    profile_store_info,
    set_profile_cache_capacity,
)
from repro_torch.runtime import faults
from repro_torch.runtime.resilience import ContractViolationError

RNG = np.random.default_rng(7)


@pytest.fixture(autouse=True)
def _pin_faults():
    """These tests assert exact store hit/corruption behavior: shield them
    from env-armed chaos injection (the chaos CI job sets $REPRO_FAULTS for
    the whole suite); tests inject their own faults explicitly."""
    with faults.injected([]), ref_faults.injected([]):
        yield


@pytest.fixture
def store(tmp_path):
    return ProfileStore(tmp_path / "store")


@pytest.fixture
def switching_store(tmp_path):
    """Wire the layered cache to a temp store; restore store-off after."""
    clear_profile_cache()
    store = configure_profile_store(tmp_path / "store")
    yield store
    configure_profile_store(None)
    clear_profile_cache()


def _profile(**over):
    base = dict(
        a_h=0.25,
        a_v=0.5,
        b_h=16,
        b_v=37,
        h_transitions=1200,
        v_transitions=3400,
        input_zero_fraction=0.125,
        input_elements=512,
    )
    base.update(over)
    return ActivityProfile(**base)


def _rand_gemm(m, k, n):
    return (
        RNG.integers(0, 100, size=(m, k)),
        RNG.integers(0, 100, size=(k, n)),
    )


def test_store_roundtrip_exact(store):
    key = bytes(range(32))
    assert store.get(key) is None
    p = _profile()
    assert store.put(key, p)
    got = store.get(key)
    assert got == p
    assert store.stats["hits"] == 1 and store.stats["misses"] == 1
    assert store.entry_path(key).startswith(
        os.path.join(store.root, STORE_VERSION)
    )


def test_store_entries_are_the_reference_format(store, tmp_path):
    """Either package reads the entries the other wrote."""
    assert STORE_VERSION == ref_profile_store.STORE_VERSION
    ref_store = ref_profile_store.ProfileStore(store.root)
    p = _profile(h_lane_toggles=tuple(range(16)))
    key = b"\x07" * 32
    assert store.put(key, p)
    assert ref_store.get(key) == RefProfile(**p.as_dict() | {"h_lane_toggles": tuple(range(16))})
    key2 = b"\x08" * 32
    assert ref_store.put(key2, RefProfile(**_profile().as_dict()))
    assert store.get(key2) == _profile()
    with open(store.entry_path(key), "rb") as f:
        mine = f.read()
    with open(ref_store.entry_path(key), "rb") as f:
        assert f.read() == mine


def test_store_roundtrip_lane_detail(store):
    """Per-lane tuples survive the JSON encode/decode as tuples of int."""
    p = _profile(
        h_lane_toggles=tuple(int(x) for x in range(16)),
        v_lane_toggles=tuple(int(x) * 3 for x in range(37)),
    )
    key = b"\x42" * 32
    store.put(key, p)
    got = store.get(key)
    assert got == p
    assert isinstance(got.h_lane_toggles, tuple)
    assert got.a_h_lanes is not None


def test_store_corruption_quarantined_not_crashed(store):
    key = b"\x01" * 32
    store.put(key, _profile())
    path = store.entry_path(key)
    raw = bytearray(open(path, "rb").read())
    raw[len(raw) // 2] ^= 0x10  # flip one payload bit
    open(path, "wb").write(bytes(raw))

    assert store.get(key) is None  # miss, not an exception
    assert store.stats["integrity_failures"] == 1
    assert not os.path.exists(path)  # moved aside
    assert len(store.quarantined()) == 1
    assert store.drain_quarantine_events() == [key.hex()]
    assert store.drain_quarantine_events() == []  # drained once

    # recompute-and-overwrite path: a fresh put fully heals the key
    store.put(key, _profile())
    assert store.get(key) == _profile()


def test_store_version_mismatch_is_quarantined(store):
    key = b"\x02" * 32
    store.put(key, _profile())
    path = store.entry_path(key)
    doc = json.load(open(path))
    doc["v"] = "v0"
    json.dump(doc, open(path, "w"))
    assert store.get(key) is None
    assert store.stats["integrity_failures"] == 1


def test_store_put_is_atomic_wrt_crash(store, tmp_path):
    """A writer killed mid-write must leave the old entry intact.

    Simulated by doing exactly what an interrupted ``put`` leaves behind: a
    half-written temp file, with no ``os.replace``."""
    key = b"\x03" * 32
    store.put(key, _profile(a_h=0.1))
    # fake a crashed writer: partial bytes in the temp-file namespace
    tmp = os.path.join(store.root, STORE_VERSION, ".tmp-99999-deadbeef")
    with open(tmp, "wb") as f:
        f.write(b'{"v": "v4", "sha256": "tru')  # torn write
    # the live entry is untouched and verifies
    assert store.get(key) == _profile(a_h=0.1)
    # the next size scan sweeps the stray temp file
    store._scan()
    assert not os.path.exists(tmp)


def test_store_eviction_is_lru_by_mtime(tmp_path):
    keys = [bytes([i]) * 32 for i in range(4)]
    big = ProfileStore(tmp_path / "s2", max_bytes=1 << 20)
    for i, k in enumerate(keys):
        big.put(k, _profile())
        os.utime(big.entry_path(k), (1000 + i, 1000 + i))
    entry_size = os.path.getsize(big.entry_path(keys[0]))
    big.max_bytes = entry_size * 2  # room for 2 of 4
    big._evict_if_needed()
    survivors = big.entries()
    assert len(survivors) == 2
    # the two NEWEST mtimes survive
    assert {os.path.basename(p) for p in survivors} == {
        keys[2].hex() + ".json",
        keys[3].hex() + ".json",
    }


def test_store_never_raises_on_io_failure(tmp_path):
    store = ProfileStore(tmp_path / "nope")
    # root not yet created: get is a plain miss
    assert store.get(b"\x00" * 32) is None
    # unwritable root (a regular file shadows the path — chmod tricks don't
    # bind under root): put degrades to False, counted, never raises
    blocked = tmp_path / "blocked"
    blocked.write_text("not a directory")
    ro = ProfileStore(blocked / "sub")
    assert ro.put(b"\x00" * 32, _profile()) is False
    assert ro.stats["io_errors"] == 1


# ---------------------------------------------------------------------------
# layered lookup through core.switching
# ---------------------------------------------------------------------------


def test_layered_lookup_memory_then_store_then_compute(switching_store):
    a, w = _rand_gemm(32, 16, 8)
    p1 = profile_gemm(a, w, 16, 8, 16, 37, backend="torch")
    assert switching_store.stats["puts"] == 1  # computed -> persisted
    # memory hit: store untouched
    p2 = profile_gemm(a, w, 16, 8, 16, 37, backend="torch")
    assert p2 is p1
    assert switching_store.stats["hits"] == 0
    # cold memory, warm disk: served from the store, promoted to memory
    clear_profile_cache()
    p3 = profile_gemm(a, w, 16, 8, 16, 37, backend="torch")
    assert p3 == p1
    assert switching_store.stats["hits"] == 1
    assert profile_cache_info()["store_hits"] == 1
    assert switching_store.stats["puts"] == 1  # promotion does NOT re-write
    p4 = profile_gemm(a, w, 16, 8, 16, 37, backend="torch")
    assert p4 is p3  # now a memory hit again
    info = profile_store_info()
    assert info is not None and info["entries"] == 1
    # the stored profile is the reference's for the same operands
    assert p1.as_dict() == dataclasses.asdict(
        ref_profile_gemm(a, w, 16, 8, 16, 37, backend="numpy", use_cache=False)
    )


def test_layered_lookup_corrupted_entry_recomputes(switching_store):
    a, w = _rand_gemm(32, 16, 8)
    expect = profile_gemm(a, w, 16, 8, 16, 37, backend="torch")
    clear_profile_cache()
    with faults.injected([faults.FaultSpec("bitflip", rate=1.0)], seed=3):
        got = profile_gemm(a, w, 16, 8, 16, 37, backend="torch")
    assert got == expect  # bit-exact recompute, no crash
    assert switching_store.stats["integrity_failures"] == 1
    assert len(switching_store.quarantined()) == 1
    # the recompute overwrote the quarantined key: next cold read verifies
    clear_profile_cache()
    assert profile_gemm(a, w, 16, 8, 16, 37, backend="torch") == expect
    assert switching_store.stats["integrity_failures"] == 1  # no new failure


def test_store_disabled_is_the_old_memory_only_cache(tmp_path):
    clear_profile_cache()
    configure_profile_store(None)
    a, w = _rand_gemm(16, 8, 4)
    profile_gemm(a, w, 8, 8, 16, 37, backend="torch")
    clear_profile_cache()
    profile_gemm(a, w, 8, 8, 16, 37, backend="torch")
    assert profile_cache_info()["store_hits"] == 0
    assert profile_store_info() is None


# ---------------------------------------------------------------------------
# in-memory cache capacity / eviction / thrash satellites
# ---------------------------------------------------------------------------


def test_cache_capacity_kwarg_and_evictions_counter():
    clear_profile_cache()
    prev = set_profile_cache_capacity(2)
    try:
        gemms = [_rand_gemm(16, 8, 4) for _ in range(3)]
        for a, w in gemms:
            profile_gemm(a, w, 8, 8, 16, 37, backend="torch")
        info = profile_cache_info()
        assert info["capacity"] == 2
        assert info["size"] == 2
        assert info["evictions"] == 1
        # oldest entry was evicted: re-profiling it misses
        profile_gemm(*gemms[0], 8, 8, 16, 37, backend="torch")
        assert profile_cache_info()["misses"] == 4
        # shrinking below the live size evicts immediately
        set_profile_cache_capacity(1)
        assert profile_cache_info()["size"] == 1
        with pytest.raises(ContractViolationError):
            set_profile_cache_capacity(0)
    finally:
        set_profile_cache_capacity(prev)
        clear_profile_cache()


def test_cache_capacity_env_override(tmp_path):
    import subprocess
    import sys

    code = (
        "from repro_torch.core.switching import profile_cache_info;"
        "print(profile_cache_info()['capacity'])"
    )
    env = dict(os.environ, REPRO_TORCH_PROFILE_CACHE_CAPACITY="7")
    env["PYTHONPATH"] = str(Path(__file__).resolve().parents[1] / "src")
    out = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True, text=True
    )
    assert out.stdout.strip() == "7", out.stderr


def test_cache_thrash_warning_fires_once_per_overflowing_batch():
    from repro_torch.core.pipeline import ProfileJob, run_profile_batch

    clear_profile_cache()
    prev = set_profile_cache_capacity(2)
    try:
        jobs = [
            ProfileJob(rows=8, cols=8, b_h=16, b_v=37, a=a, w=w)
            for a, w in (_rand_gemm(16, 8, 4) for _ in range(4))
        ]
        with pytest.warns(CacheThrashWarning, match="stored 4 profiles"):
            run_profile_batch(jobs, backend="torch")
        # one-shot: the same overflow again stays quiet until cache reset
        import warnings as _w

        with _w.catch_warnings():
            _w.simplefilter("error", CacheThrashWarning)
            run_profile_batch(jobs, backend="torch")
    finally:
        set_profile_cache_capacity(prev)
        clear_profile_cache()
