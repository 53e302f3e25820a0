#!/usr/bin/env python3
"""Run the port's main path once on one CUDA card and check it end to end.

    python3 chip_smoke.py

Phases (any mismatch exits non-zero; nothing is caught):

1. Print the card (``nvidia-smi`` name and power limit), build the CUDA
   kernels from ``src/repro_torch/csrc`` and print the build time.
2. Hold each kernel against its plain PyTorch version on the card, on the
   reference test matrices and on every ResNet50 Table-I layer: the
   integer counts must be equal (and equal to the numpy oracle on the
   small cases).
3. The main path: ``profile_network(RESNET50_TABLE1)`` exact, with
   ``backend="auto"``, WS and OS, on the paper's 32x32 array with int16
   operands.  Its profiles must equal the JAX package's, committed in
   ``src/repro_torch/data/table1_reference.json``; then ``combine_profiles``
   -> ``optimal_aspect_power`` -> ``compare_sym_asym`` per layer ->
   ``average_comparison`` must match the file to 1e-12 relative.  Every
   kernel of the path must have been launched in this phase.
4. Time each kernel at the main path's shapes with CUDA events (warm-up,
   then the median of repeated calls) beside its plain version and its
   bound.
5. Trace the main path once more with ``torch.profiler`` and print the
   device's busy share and the device time of each kernel and copy.

The last lines are the ``kernels`` JSON object, the ``nvidia-smi`` line and
``{"ok": true, "device": {...}}``.  Exits non-zero without a result when no
CUDA device is available or when the repository's ``src/`` is missing.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
REL_TOL = 1e-12
# Peak rates of one H100 SXM (NVIDIA's data sheet, at the 700 W limit):
# HBM bytes/s, and the float32 CUDA-core rate as the rate of 32-bit lane
# operations (an integer multiply-add counts 2, like a fused multiply-add).
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
# Operations per element: WS partial sum = multiply-add (2) + XOR + AND +
# popcount; a bus value = XOR + AND + popcount.
OPS_PER_PARTIAL_SUM = 5
OPS_PER_BUS_VALUE = 3
# Device-side events the profiler records for itself.
PROFILER_OWN_EVENTS = ("Activity Buffer Request",)

# The reference test matrices: tests/test_activity_profile.py CASES / OS_CASES.
CASES = [
    (7, 5, 3, 32, 32, 16, 37),
    (64, 64, 48, 32, 32, 16, 37),
    (100, 37, 29, 16, 8, 8, 20),
    (33, 70, 10, 32, 32, 16, 64),
    (2, 1, 1, 8, 8, 16, 37),
    (17, 16, 16, 16, 16, 32, 32),
    (257, 40, 33, 16, 16, 37, 33),
    (1025, 96, 64, 32, 32, 16, 37),
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


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def rel_close(got: float, want: float) -> bool:
    return abs(got - want) <= REL_TOL * max(abs(want), 1e-300)


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check runs on a CUDA card")
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"{ROOT / 'src' / 'repro_torch'} not found: run from a checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))

    import numpy as np

    from repro_torch.core.energy import average_comparison, compare_sym_asym
    from repro_torch.core.floorplan import SystolicArrayGeometry, optimal_aspect_power
    from repro_torch.core.optimize import os_dataflow_geometry
    from repro_torch.core.quant import quantize_symmetric
    from repro_torch.core.switching import clear_profile_cache, combine_profiles
    from repro_torch.core.workloads import (
        RESNET50_TABLE1,
        conv_to_gemm,
        profile_network,
        synth_activations,
        synth_weights,
    )
    from repro_torch.kernels import _build
    from repro_torch.kernels.activity_profile import kernel as K
    from repro_torch.kernels.activity_profile.ref import profile_gemm_toggles_ref

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # -- phase 1: the card and the build ------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(f"card: {smi} | torch {torch.__version__} cuda {torch.version.cuda} | {kind}", flush=True)
    t0 = time.perf_counter()
    build_logs = _build.build()
    print(f"build: {time.perf_counter() - t0:.2f} s", flush=True)
    for name, log in build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                print(f"  nvcc[{name}]: {line.strip()}")

    # -- phase 2: kernels vs plain versions on the card ---------------------
    max_err = {"ws_activity_toggles": 0, "operand_stream_toggles": 0}

    def on_card(x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x, dtype=np.int32)).to(dev)

    def check_k1(a, w, rows, cols, b_h, b_v, what, small_case=False):
        """K1 vs its plain version (and, on a small case, vs the plain
        version in 7-step windows and the numpy oracle)."""
        a_t, w_t = on_card(a), on_card(w)
        got = K.ws_activity_toggles(a_t, w_t, rows, cols, b_h, b_v).tolist()
        plain = K.ws_activity_toggles_plain(a_t, w_t, rows, cols, b_h, b_v).tolist()
        err = max(abs(g - p) for g, p in zip(got, plain))
        max_err["ws_activity_toggles"] = max(max_err["ws_activity_toggles"], err)
        check(got == plain, f"K1 {what}: kernel {got} plain {plain}")
        if small_case:
            windows = K.ws_activity_toggles_plain(a_t, w_t, rows, cols, b_h, b_v, block_t=7).tolist()
            ref = list(profile_gemm_toggles_ref(a, w, rows, cols, b_h, b_v)[:2])
            check(got == windows == ref, f"K1 {what}: kernel {got} block_t=7 {windows} oracle {ref}")

    def check_k4(x, bits, what) -> int:
        """K4 vs its plain version, whole and in 5-step windows."""
        x_t = on_card(x)
        got = int(K.operand_stream_toggles(x_t, bits).item())
        plain = int(K.operand_stream_toggles_plain(x_t, bits).item())
        windows = int(K.operand_stream_toggles_plain(x_t, bits, block_t=5).item())
        max_err["operand_stream_toggles"] = max(max_err["operand_stream_toggles"], abs(got - plain))
        check(got == plain == windows, f"K4 {what}: kernel {got} plain {plain} block_t=5 {windows}")
        return got

    rng = np.random.default_rng(0)
    for case in CASES:
        m, k, n, rows, cols, b_h, b_v = case
        a = rng.integers(-32767, 32768, size=(m, k))
        w = rng.integers(-32767, 32768, size=(k, n))
        check_k1(a, w, rows, cols, b_h, b_v, f"case {case}", small_case=True)
    a = np.full((64, 32), 32767, dtype=np.int64)
    a[::2] = -32767
    w = np.full((32, 8), 32767, dtype=np.int64)
    w[:, ::2] = -32767
    check_k1(a, w, 32, 8, 16, 37, "37-bit extremes", small_case=True)
    for case in OS_CASES:
        m, k, n, rows, cols, b_h, b_v = case
        a = rng.integers(-32767, 32768, size=(m, k))
        w = rng.integers(-32767, 32768, size=(k, n))
        h_ref, v_ref, _, _ = profile_gemm_toggles_ref(a, w, rows, cols, b_h, b_v, dataflow="OS")
        n_tiles, m_tiles = -(-n // cols), -(-m // rows)
        got_h = check_k4(a.T, b_h, f"OS case {case} A stream") * n_tiles
        got_v = check_k4(w, b_v, f"OS case {case} W stream") * m_tiles
        check((got_h, got_v) == (h_ref, v_ref),
              f"K4 OS case {case}: {(got_h, got_v)} oracle {(h_ref, v_ref)}")

    operands = []
    for seed, layer in enumerate(RESNET50_TABLE1):
        g = conv_to_gemm(layer)
        a = quantize_symmetric(synth_activations(g.m, g.k, layer.input_density, seed=seed), 16).values
        w = quantize_symmetric(synth_weights(g.k, g.n, seed=seed + 1), 16).values
        operands.append((layer.name, a, w))
        check_k1(a, w, 32, 32, 16, 37, f"{layer.name} WS")
        check_k4(a.T, 16, f"{layer.name} OS A stream")
        check_k4(w, 16, f"{layer.name} OS W stream")
    print(f"kernels vs plain versions: equal on {len(CASES) + 1 + len(RESNET50_TABLE1)} WS and "
          f"{2 * (len(OS_CASES) + len(RESNET50_TABLE1))} OS inputs", flush=True)

    # -- phase 3: the main path ----------------------------------------------
    ref = json.loads((ROOT / "src" / "repro_torch" / "data" / "table1_reference.json").read_text())
    geoms = {
        "WS": SystolicArrayGeometry.paper_32x32(),
        "OS": os_dataflow_geometry(16, 32, 32),
    }
    K.ws_activity_toggles.launches = 0
    K.operand_stream_toggles.launches = 0
    clear_profile_cache()
    main_ms = {}
    verdicts = {}
    for dataflow in ("WS", "OS"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        profiles = profile_network(RESNET50_TABLE1, dataflow=dataflow, backend="auto")
        torch.cuda.synchronize()
        main_ms[dataflow] = (time.perf_counter() - t0) * 1e3
        for layer, p, want in zip(RESNET50_TABLE1, profiles, ref["layers"]):
            counts = [
                round(p.a_h * p.h_transitions * p.b_h),
                round(p.a_v * p.v_transitions * p.b_v),
                p.h_transitions,
                p.v_transitions,
            ]
            print(f"  {dataflow} {layer.name}: a_h={p.a_h!r} a_v={p.a_v!r} counts={counts}")
            check(counts == want[dataflow]["counts"],
                  f"{dataflow} {layer.name}: counts {counts} reference {want[dataflow]['counts']}")
            check(p.as_dict() == want[dataflow]["profile"],
                  f"{dataflow} {layer.name}: profile {p.as_dict()} reference {want[dataflow]['profile']}")
            if dataflow == "WS":
                check(p.a_v > p.a_h, f"WS {layer.name}: a_v <= a_h")
        geom = geoms[dataflow]
        avg = combine_profiles(profiles)
        design = avg.as_bus_activity()
        aspect = optimal_aspect_power(geom, design)
        comps = [compare_sym_asym(geom, p.as_bus_activity(), design_act=design) for p in profiles]
        agg = average_comparison(comps)
        want = ref["verdict"][dataflow]
        pairs = [("aspect_opt", aspect, want["aspect_opt"])]
        pairs += [(f"average.{key}", agg[key], want["average"][key]) for key in want["average"]]
        pairs += [(f"average_profile.{key}", getattr(avg, key), want["average_profile"][key])
                  for key in ("a_h", "a_v", "input_zero_fraction")]
        for i, (c, w_l) in enumerate(zip(comps, want["per_layer"])):
            pairs += [(f"L{i + 1}.{key}", getattr(c, key), w_l[key]) for key in w_l]
        for what, got, exp in pairs:
            check(np.isfinite(got) and rel_close(got, exp), f"{dataflow} {what}: {got!r} reference {exp!r}")
        verdicts[dataflow] = (aspect, agg["interconnect_saving"], agg["total_saving"])
        print(f"{dataflow} verdict: W/H*={aspect!r} interconnect saving={agg['interconnect_saving']!r} "
              f"total saving={agg['total_saving']!r} ({len(pairs)} floats within {REL_TOL} of the "
              f"reference); main path {main_ms[dataflow]:.1f} ms", flush=True)
    launches = {
        "ws_activity_toggles": K.ws_activity_toggles.launches,
        "operand_stream_toggles": K.operand_stream_toggles.launches,
    }
    print(f"main-path launches: {launches}", flush=True)
    for name, count in launches.items():
        check(count > 0, f"{name} was not launched on the main path")
    check(verdicts["WS"][1] > 0 and verdicts["WS"][2] > 0, "WS asymmetric floorplan saves nothing")

    # -- phase 4: times at the main path's shapes ----------------------------
    def median_ms(fn, calls: int, bursts: int = 5) -> float:
        """Median over bursts of the mean per-call time of ``calls``
        back-to-back calls, after one warm-up burst.  Where a call's host
        work outlasts its kernel, the host's launch rate sets the time."""
        times = []
        for burst in range(bursts + 1):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(calls):
                fn()
            end.record()
            end.synchronize()
            if burst:
                times.append(start.elapsed_time(end) / calls)
        return statistics.median(times)

    def bound_ms(n_bytes: int, n_ops: int) -> tuple[float, str]:
        t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
        t_ops = n_ops / PEAK_OPS_PER_S * 1e3
        return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")

    totals = {name: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bound_by": {}} for name in launches}

    def add(name, ms, plain, bound, by):
        t = totals[name]
        t["ms"] += ms
        t["plain_ms"] += plain
        t["bound_ms"] += bound
        t["bound_by"][by] = t["bound_by"].get(by, 0.0) + bound

    print("times (ms per call; bound = max(bytes / 3.35 TB/s, ops / 67 Tops/s)):")
    for name, a, w in operands:
        m, k = a.shape
        n = w.shape[1]
        a_t, w_t = on_card(a), on_card(w)
        ms = median_ms(lambda: K.ws_activity_toggles(a_t, w_t, 32, 32, 16, 37), calls=20)
        plain = median_ms(lambda: K.ws_activity_toggles_plain(a_t, w_t, 32, 32, 16, 37), calls=2, bursts=3)
        ops = OPS_PER_PARTIAL_SUM * m * k * n + OPS_PER_BUS_VALUE * m * k * -(-n // 32)
        bound, by = bound_ms(4 * (m * k + k * n) + 16, ops)
        add("ws_activity_toggles", ms, plain, bound, by)
        print(f"  K1 {name} {m}x{k}x{n}: {ms:.4f} ms, plain {plain:.4f} ms, bound {bound:.5f} ms ({by})")
        for stream, what in ((np.ascontiguousarray(a.T), "A"), (w, "W")):
            x_t = on_card(stream)
            t_len, lanes = stream.shape
            ms = median_ms(lambda: K.operand_stream_toggles(x_t, 16), calls=20)
            plain = median_ms(lambda: K.operand_stream_toggles_plain(x_t, 16), calls=2, bursts=3)
            bound, by = bound_ms(4 * t_len * lanes + 8, OPS_PER_BUS_VALUE * t_len * lanes)
            add("operand_stream_toggles", ms, plain, bound, by)
            print(f"  K4 {name} {what} stream {t_len}x{lanes}: {ms:.4f} ms, plain {plain:.4f} ms, "
                  f"bound {bound:.6f} ms ({by})")

    # -- phase 5: where the main path's time goes ------------------------------
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    clear_profile_cache()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for dataflow in ("WS", "OS"):
            profile_network(RESNET50_TABLE1, dataflow=dataflow, backend="auto")
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # Device-side events only (kernels and copies); host ops that launched
    # them would count their time twice.  The profiler's own buffer request
    # is shown but is not the program's work.
    device_ms = {
        ev.key: (ev.self_device_time_total / 1e3, ev.count)
        for ev in prof.key_averages()
        if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0
    }
    busy_ms = sum(ms for key, (ms, _) in device_ms.items() if key not in PROFILER_OWN_EVENTS)
    print(f"trace of the main path (WS + OS, cache cleared, profiler on): wall {wall_ms:.1f} ms, "
          f"device busy {busy_ms:.4f} ms = {100 * busy_ms / wall_ms:.3f}% of the wall time")
    for key, (ms, count) in sorted(device_ms.items(), key=lambda kv: -kv[1][0])[:10]:
        print(f"  device {ms:.4f} ms in {count} x {key[:90]}")

    meta = {
        "ws_activity_toggles": (
            "src/repro_torch/csrc/activity_profile.cu",
            "src/repro/kernels/activity_profile/kernel.py:149",
        ),
        "operand_stream_toggles": (
            "src/repro_torch/csrc/activity_profile.cu",
            "src/repro/kernels/activity_profile/kernel.py:249",
        ),
    }
    kernels = []
    for name, t in totals.items():
        source, replaces = meta[name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": max_err[name],
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": max(t["bound_by"], key=t["bound_by"].get),
            "library_ms": None,  # no single PyTorch call counts bus toggles
        })
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()},
    }), flush=True)


if __name__ == "__main__":
    main()
