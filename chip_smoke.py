#!/usr/bin/env python3
"""Run the port's main paths once on one CUDA card and check them end to end.

    python3 chip_smoke.py

Phases (any mismatch exits non-zero; nothing is caught):

1. Print the card (``nvidia-smi`` name and power limit), build the CUDA
   kernels from ``src/repro_torch/csrc`` (one ``nvcc`` per source, all
   started together) and print the build time.
2. Hold each kernel against its plain PyTorch version on the card, element
   for element: K1 and K4 on the reference test matrices and on every
   ResNet50 Table-I layer (and the numpy oracle on the small cases); K2 and
   K3 on the stacked buckets the port's scheduler builds for the
   reference's ragged WS and OS job sets, and on the Table-I WS bucket
   (3776 tasks over 720 strips) and OS stream bucket (496 strips).
3. The two main paths, on the paper's 32x32 array with int16 operands, WS
   and OS, each with every kernel count set to 0 just before it and read
   just after:
   * per GEMM: ``profile_conv_layer(backend="auto")`` per layer (K1, K4);
   * batched: ``profile_network(RESNET50_TABLE1, backend="auto",
     return_stats=True)`` (K2, K3).
   Each path's profiles must equal the JAX package's, committed in
   ``src/repro_torch/data/table1_reference.json``, and ``combine_profiles``
   -> ``optimal_aspect_power`` -> ``compare_sym_asym`` per layer ->
   ``average_comparison`` must match the file to 1e-12 relative.  The
   batched path's scheduler statistics must equal the reference's, with no
   serial fallback, degraded or skipped job and an empty failure report.
   Every kernel of a path must have been launched in its run.
4. Time each kernel at the main paths' shapes with CUDA events (warm-up,
   then the median of repeated calls) beside its plain version and its
   bound.
5. Trace each main path once more with ``torch.profiler`` and print the
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
KERNELS = ("ws_activity_toggles", "ws_task_toggles", "strip_toggles", "operand_stream_toggles")
BATCH_STATS_FIELDS = (
    "jobs", "passes", "pass_reuse", "buckets", "tasks", "strips", "serial_fallbacks",
)

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
# The reference's ragged batches: tests/test_profile_pipeline.py RAGGED /
# OS_RAGGED.
RAGGED = [
    (7, 5, 3, 16, 8, 16, 37),
    (33, 70, 10, 16, 8, 16, 37),
    (100, 37, 29, 16, 8, 8, 20),
    (64, 64, 48, 32, 32, 16, 37),
    (257, 40, 33, 16, 16, 37, 33),
    (300, 80, 70, 32, 32, 16, 64),
    (50, 24, 16, 8, 8, 8, 23),
]
OS_RAGGED = [
    (7, 5, 3, 16, 8, 16, 16),
    (33, 70, 10, 16, 8, 16, 12),
    (100, 37, 29, 16, 8, 8, 8),
    (257, 40, 33, 16, 16, 37, 33),
    (12, 300, 16, 8, 8, 16, 16),
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

    from repro_torch.core import pipeline
    from repro_torch.core.energy import average_comparison, compare_sym_asym
    from repro_torch.core.floorplan import SystolicArrayGeometry, optimal_aspect_power
    from repro_torch.core.optimize import os_dataflow_geometry
    from repro_torch.core.pipeline import BatchStats, ProfileJob
    from repro_torch.core.switching import clear_profile_cache, combine_profiles
    from repro_torch.core.workloads import (
        RESNET50_TABLE1,
        conv_layer_job,
        profile_conv_layer,
        profile_network,
    )
    from repro_torch.kernels import _build
    from repro_torch.kernels.activity_profile import kernel as K
    from repro_torch.kernels.activity_profile.ref import profile_gemm_toggles_ref

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    wrappers = {name: getattr(K, name) for name in KERNELS}

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
    max_err = {name: 0 for name in KERNELS}

    def on_card(x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x, dtype=np.int32)).to(dev)

    def note(name, got, plain) -> None:
        err = max((abs(g - p) for g, p in zip(got, plain)), default=0)
        max_err[name] = max(max_err[name], err)

    def check_k1(a, w, rows, cols, b_h, b_v, what, small_case=False):
        """K1 vs its plain version (and, on a small case, vs the plain
        version in 7-step windows and the numpy oracle)."""
        a_t, w_t = on_card(a), on_card(w)
        got = K.ws_activity_toggles(a_t, w_t, rows, cols, b_h, b_v).tolist()
        plain = K.ws_activity_toggles_plain(a_t, w_t, rows, cols, b_h, b_v).tolist()
        note("ws_activity_toggles", got, plain)
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
        note("operand_stream_toggles", [got], [plain])
        check(got == plain == windows, f"K4 {what}: kernel {got} plain {plain} block_t=5 {windows}")
        return got

    def check_k3(strips_t, bits, what) -> None:
        got = K.strip_toggles(strips_t, bits).tolist()
        plain = K.strip_toggles_plain(strips_t, bits).tolist()
        note("strip_toggles", got, plain)
        check(got == plain, f"K3 {what}: kernel and plain version differ")

    def check_k2(arrays, b_v, what) -> None:
        got = K.ws_task_toggles(*arrays, b_v).tolist()
        plain = K.ws_task_toggles_plain(*arrays, b_v).tolist()
        note("ws_task_toggles", got, plain)
        check(got == plain, f"K2 {what}: kernel and plain version differ")
        check(min(got) >= 0, f"K2 {what}: a task flagged a bad index")

    def stacked(jobs):
        """The WS buckets and OS stream buckets the port's scheduler builds
        for ``jobs``, grouped by shape class as ``run_profile_batch`` does,
        as arrays on the card."""
        order: dict[tuple, list[int]] = {}
        for i, job in enumerate(jobs):
            order.setdefault(pipeline._bucket_key(job), []).append(i)
        bucket_map, buckets, pass_map = {}, [], {}
        stream_map, stream_buckets, stream_pass_map = {}, [], {}
        stats = BatchStats()
        for members in order.values():
            t_trim = max(-(-jobs[i].gemm_shape()[0] // 8) * 8 for i in members)
            for i in members:
                job = jobs[i]
                a, w = job.operands()
                if job.dataflow == "OS":
                    pipeline._schedule_os_job(
                        job, a, w, stream_map, stream_buckets, stream_pass_map, stats
                    )
                else:
                    pipeline._schedule_job(job, a, w, t_trim, bucket_map, buckets, pass_map, stats)
        ws = [
            (b, tuple(on_card(np.asarray(x)) for x in (
                np.stack(b.strips), np.stack(b.w_tiles), b.strip_ids, b.w_ids, b.valid_r)))
            for b in buckets
        ]
        os_ = [(b, on_card(np.stack(b.strips))) for b in stream_buckets]
        return ws, os_

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

    ragged_jobs = []
    for dataflow, cases in (("WS", RAGGED), ("OS", OS_RAGGED)):
        for m, k, n, rows, cols, b_h, b_v in cases:
            a = rng.integers(-32767, 32768, size=(m, k))
            w = rng.integers(-32767, 32768, size=(k, n))
            ragged_jobs.append(
                ProfileJob(rows=rows, cols=cols, b_h=b_h, b_v=b_v, a=a, w=w, dataflow=dataflow)
            )
    ws_buckets, os_buckets = stacked(ragged_jobs)
    for b, arrays in ws_buckets:
        what = f"ragged bucket {b.rows}x{b.cols} b_h={b.b_h} b_v={b.b_v} t_seg={b.t_seg}"
        check_k2(arrays, b.b_v, what)
        check_k3(arrays[0], b.b_h, what)
    for b, strips_t in os_buckets:
        check_k3(strips_t, b.bits, f"ragged OS stream bucket bits={b.bits} t_seg={b.t_seg}")

    operands = []
    table1_jobs = {
        dataflow: [conv_layer_job(layer, seed=i, dataflow=dataflow)
                   for i, layer in enumerate(RESNET50_TABLE1)]
        for dataflow in ("WS", "OS")
    }
    for job, layer in zip(table1_jobs["WS"], RESNET50_TABLE1):
        a, w = job.operands()
        operands.append((layer.name, a, w))
        check_k1(a, w, 32, 32, 16, 37, f"{layer.name} WS")
        check_k4(a.T, 16, f"{layer.name} OS A stream")
        check_k4(w, 16, f"{layer.name} OS W stream")
    ((_, ws_arrays),), _ = stacked(table1_jobs["WS"])
    _, ((_, os_strips),) = stacked(table1_jobs["OS"])
    check_k2(ws_arrays, 37, "Table-I WS bucket")
    check_k3(ws_arrays[0], 16, "Table-I WS strips")
    check_k3(os_strips, 16, "Table-I OS stream strips")
    print(f"Table-I buckets: WS {ws_arrays[2].shape[0]} tasks over strips "
          f"{tuple(ws_arrays[0].shape)} and tiles {tuple(ws_arrays[1].shape)}; "
          f"OS strips {tuple(os_strips.shape)}")
    print(f"kernels vs plain versions: equal on {len(CASES) + 1 + len(RESNET50_TABLE1)} WS and "
          f"{2 * (len(OS_CASES) + len(RESNET50_TABLE1))} OS per-GEMM inputs, "
          f"{len(ws_buckets) + 1} WS buckets and {len(os_buckets) + 1} OS stream buckets",
          flush=True)

    # -- phase 3: the main paths ---------------------------------------------
    ref = json.loads((ROOT / "src" / "repro_torch" / "data" / "table1_reference.json").read_text())
    geoms = {
        "WS": SystolicArrayGeometry.paper_32x32(),
        "OS": os_dataflow_geometry(16, 32, 32),
    }

    def check_profiles(path, dataflow, profiles):
        for layer, p, want in zip(RESNET50_TABLE1, profiles, ref["layers"]):
            counts = [
                round(p.a_h * p.h_transitions * p.b_h),
                round(p.a_v * p.v_transitions * p.b_v),
                p.h_transitions,
                p.v_transitions,
            ]
            print(f"  {path} {dataflow} {layer.name}: a_h={p.a_h!r} a_v={p.a_v!r} counts={counts}")
            check(counts == want[dataflow]["counts"],
                  f"{path} {dataflow} {layer.name}: counts {counts} "
                  f"reference {want[dataflow]['counts']}")
            check(p.as_dict() == want[dataflow]["profile"],
                  f"{path} {dataflow} {layer.name}: profile {p.as_dict()} "
                  f"reference {want[dataflow]['profile']}")
            if dataflow == "WS":
                check(p.a_v > p.a_h, f"{path} WS {layer.name}: a_v <= a_h")
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
            check(np.isfinite(got) and rel_close(got, exp),
                  f"{path} {dataflow} {what}: {got!r} reference {exp!r}")
        if dataflow == "WS":
            check(agg["interconnect_saving"] > 0 and agg["total_saving"] > 0,
                  f"{path}: the WS asymmetric floorplan saves nothing")
        print(f"{path} {dataflow} verdict: W/H*={aspect!r} interconnect saving="
              f"{agg['interconnect_saving']!r} total saving={agg['total_saving']!r} "
              f"({len(pairs)} floats within {REL_TOL} of the reference)", flush=True)

    def per_gemm_path(dataflow):
        return [
            profile_conv_layer(layer, seed=i, backend="auto", dataflow=dataflow)
            for i, layer in enumerate(RESNET50_TABLE1)
        ]

    def batched_path(dataflow):
        return profile_network(RESNET50_TABLE1, dataflow=dataflow, backend="auto",
                               return_stats=True)

    launches = {}
    main_ms = {}
    for path, expected in (("per-GEMM", ("ws_activity_toggles", "operand_stream_toggles")),
                           ("batched", ("ws_task_toggles", "strip_toggles"))):
        clear_profile_cache()
        for fn in wrappers.values():
            fn.launches = 0
        for dataflow in ("WS", "OS"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if path == "per-GEMM":
                profiles = per_gemm_path(dataflow)
            else:
                profiles, stats = batched_path(dataflow)
            torch.cuda.synchronize()
            main_ms[path, dataflow] = (time.perf_counter() - t0) * 1e3
            check_profiles(path, dataflow, profiles)
            if path == "batched":
                got = {key: getattr(stats, key) for key in BATCH_STATS_FIELDS}
                print(f"  batched {dataflow} scheduler: {got}")
                check(got == ref["batch_stats"][dataflow],
                      f"batched {dataflow}: stats {got} reference {ref['batch_stats'][dataflow]}")
                check(stats.serial_fallbacks == stats.degraded == stats.skipped == 0
                      and not stats.failure_report,
                      f"batched {dataflow}: fallbacks or failures {stats.as_dict()}")
        counts = {name: fn.launches for name, fn in wrappers.items()}
        print(f"{path} path: WS {main_ms[path, 'WS']:.1f} ms, OS {main_ms[path, 'OS']:.1f} ms; "
              f"launches {counts}", flush=True)
        for name in expected:
            check(counts[name] > 0, f"{name} was not launched on the {path} path")
            launches[name] = counts[name]

    # -- phase 4: times at the main paths' shapes ----------------------------
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

    totals = {name: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bound_by": {}} for name in KERNELS}

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

    # K2: the partial sums these tasks need, t_seg x valid_r x cols each
    # (time padding included: it is the kernel's input); K3: every value
    # read once.  The batched main path launches K2 once (WS) and K3 twice
    # (WS strips at b_h, OS strips).
    strips_t, tiles_t, ids_t, wids_t, vr_t = ws_arrays
    n_tasks = ids_t.shape[0]
    t_seg, cols = strips_t.shape[1] - 1, tiles_t.shape[2]
    task_sums = t_seg * cols * int(vr_t.sum())
    useful_sums = sum(int(np.prod(job.gemm_shape())) for job in table1_jobs["WS"])
    ms = median_ms(lambda: K.ws_task_toggles(*ws_arrays, 37), calls=20)
    plain = median_ms(lambda: K.ws_task_toggles_plain(*ws_arrays, 37), calls=2, bursts=3)
    k2_bytes = sum(x.numel() * x.element_size() for x in ws_arrays) + 8 * n_tasks
    bound, by = bound_ms(k2_bytes, OPS_PER_PARTIAL_SUM * task_sums)
    add("ws_task_toggles", ms, plain, bound, by)
    print(f"  K2 Table-I WS bucket, {n_tasks} tasks, {task_sums} partial sums "
          f"({useful_sums} in the GEMMs: bound {OPS_PER_PARTIAL_SUM * useful_sums / PEAK_OPS_PER_S * 1e3:.5f} ms): "
          f"{ms:.4f} ms, plain {plain:.4f} ms, bound {bound:.5f} ms ({by})")
    for strips_x, bits, what in ((strips_t, 16, "WS strips"), (os_strips, 16, "OS stream strips")):
        ms = median_ms(lambda: K.strip_toggles(strips_x, bits), calls=20)
        plain = median_ms(lambda: K.strip_toggles_plain(strips_x, bits), calls=2, bursts=3)
        values = strips_x.numel()
        bound, by = bound_ms(4 * values + 8 * strips_x.shape[0], OPS_PER_BUS_VALUE * values)
        add("strip_toggles", ms, plain, bound, by)
        print(f"  K3 Table-I {what} {tuple(strips_x.shape)}: {ms:.4f} ms, plain {plain:.4f} ms, "
              f"bound {bound:.6f} ms ({by})")

    # -- phase 5: where each main path's time goes -----------------------------
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for path, run in (("per-GEMM", per_gemm_path), ("batched", batched_path)):
        clear_profile_cache()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for dataflow in ("WS", "OS"):
                run(dataflow)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        # Device-side events only (kernels and copies); host ops that launched
        # them would count their time twice.  The profiler's own buffer
        # request is shown but is not the program's work.
        device_ms = {
            ev.key: (ev.self_device_time_total / 1e3, ev.count)
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0
        }
        busy_ms = sum(ms for key, (ms, _) in device_ms.items() if key not in PROFILER_OWN_EVENTS)
        print(f"trace of the {path} path (WS + OS, cache cleared, profiler on): wall "
              f"{wall_ms:.1f} ms, device busy {busy_ms:.4f} ms = {100 * busy_ms / wall_ms:.3f}% "
              f"of the wall time")
        for key, (ms, count) in sorted(device_ms.items(), key=lambda kv: -kv[1][0])[:10]:
            print(f"  device {ms:.4f} ms in {count} x {key[:90]}")

    meta = {
        "ws_activity_toggles": (
            "src/repro_torch/csrc/activity_profile.cu",
            "src/repro/kernels/activity_profile/kernel.py:149",
        ),
        "ws_task_toggles": (
            "src/repro_torch/csrc/activity_batch.cu",
            "src/repro/kernels/activity_profile/kernel.py:332",
        ),
        "strip_toggles": (
            "src/repro_torch/csrc/activity_batch.cu",
            "src/repro/kernels/activity_profile/kernel.py:298",
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
