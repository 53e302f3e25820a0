#!/usr/bin/env python3
"""Build variants of K1 (``ws_activity_toggles``), K2 (``ws_task_toggles``)
and K3 (``strip_toggles``) and time them on a CUDA card.

    python3 tools/k1_variants.py [--sass PATH] [--kernels K1 K2 K3]

Each variant is ``csrc/activity_profile.cu`` (K1), ``csrc/activity_batch.cu``
(K2) or ``csrc/toggle_count.cu`` (K3) with a few constants edited (run
length, warps per block, the high-word packing at b_v = 37, K2's launch
bound, K3's least time chunk), built with the port's ``nvcc`` flags into
``build/k1_variants/``.  Every variant must give the plain version's counts
on the ResNet50 Table-I inputs (32x32 array, b_h 16, b_v 37): K1 on the six
layers, K2 on the batched path's WS bucket (3776 tasks, t_seg 128), K3 on
its WS strips (720 of 129 x 32) and OS strips (496 of 129 x 64).  K1 and K2
are then timed there with CUDA events (median of 5 bursts of 20 calls,
after a warm-up); K3, whose call costs the host more than the card, by its
device time: ``torch.profiler``'s device events over 20 calls, the L2
flushed (a 128 MiB read) before each and the flush left out.  Two turns.
ptxas's register and spill lines are printed per variant; ``--sass PATH``
writes the unedited K1 source's SASS (``cuobjdump -sass``) to PATH.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# name -> (old, new) edits of csrc/activity_profile.cu
K1_VARIANTS = {
    "as built": [],
    "runs of 7": [("constexpr int kSteps = 15;", "constexpr int kSteps = 7;")],
    "runs of 31": [("constexpr int kSteps = 15;", "constexpr int kSteps = 31;")],
    "runs of 7, 8 warps": [("constexpr int kSteps = 15;", "constexpr int kSteps = 7;"),
                           ("constexpr int kWarps = 4;", "constexpr int kWarps = 8;")],
    "no high-word packing": [("launch(ws_activity_toggles_kernel<5>);",
                              "launch(ws_activity_toggles_kernel<32>);")],
}
# name -> (old, new) edits of csrc/activity_batch.cu; the Table-I bucket
# (t_seg 128) takes the long runs
K2_ALL_LONG = ("const bool short_runs = steps % kLongRun != 0 && steps % kLongRun <= kShortRun;",
               "const bool short_runs = false;")
K2_VARIANTS = {
    "as built (runs of 16)": [],
    "runs of 8": [("constexpr int kLongRun = 16;", "constexpr int kLongRun = 8;")],
    "runs of 15": [("constexpr int kLongRun = 16;", "constexpr int kLongRun = 15;"), K2_ALL_LONG],
    "runs of 16, no 64-register bound": [("__launch_bounds__(kLanes * kTaskWarps, 8)",
                                          "__launch_bounds__(kLanes * kTaskWarps)")],
}
# name -> (old, new) edits of csrc/toggle_count.cu
K3_CHUNK = "constexpr long long kStripMinChunk = 4;"
K3_VARIANTS = {
    "as built (chunks of 4 or more)": [],
    "chunks of 8 or more": [(K3_CHUNK, "constexpr long long kStripMinChunk = 8;")],
    "chunks of 16 or more (K5's)": [(K3_CHUNK, "constexpr long long kStripMinChunk = 16;")],
    "chunks of 32 or more": [(K3_CHUNK, "constexpr long long kStripMinChunk = 32;")],
}
KERNELS = {
    # kernel: (source, entry, variants)
    "K1": ("activity_profile", "ws_activity_toggles", K1_VARIANTS),
    "K2": ("activity_batch", "ws_task_toggles", K2_VARIANTS),
    "K3": ("toggle_count", "strip_toggles", K3_VARIANTS),
}


def table1_ws_bucket(dev):
    """The stacked arrays of the batched path's one Table-I WS bucket (as
    ``run_profile_batch`` builds it), on ``dev``."""
    import numpy as np
    import torch

    from repro_torch.core import pipeline
    from repro_torch.core.pipeline import BatchStats
    from repro_torch.core.workloads import RESNET50_TABLE1, conv_layer_job

    jobs = [conv_layer_job(layer, seed=i) for i, layer in enumerate(RESNET50_TABLE1)]
    t_trim = max(-(-job.gemm_shape()[0] // 8) * 8 for job in jobs)
    bucket_map, buckets, pass_map, stats = {}, [], {}, BatchStats()
    for job in jobs:
        a, w = job.operands()
        pipeline._schedule_job(job, a, w, t_trim, bucket_map, buckets, pass_map, stats)
    (b,) = buckets
    return tuple(torch.from_numpy(np.ascontiguousarray(np.asarray(x), dtype=np.int32)).to(dev)
                 for x in (np.stack(b.strips), np.stack(b.w_tiles), b.strip_ids, b.w_ids, b.valid_r))


def table1_os_strips(dev):
    """The batched path's one Table-I OS stream bucket's strips, on ``dev``."""
    import numpy as np
    import torch

    from repro_torch.core import pipeline
    from repro_torch.core.pipeline import BatchStats
    from repro_torch.core.workloads import RESNET50_TABLE1, conv_layer_job

    stream_map, stream_buckets, pass_map, stats = {}, [], {}, BatchStats()
    for i, layer in enumerate(RESNET50_TABLE1):
        job = conv_layer_job(layer, seed=i, dataflow="OS")
        a, w = job.operands()
        pipeline._schedule_os_job(job, a, w, stream_map, stream_buckets, pass_map, stats)
    (b,) = stream_buckets
    return torch.from_numpy(np.ascontiguousarray(np.stack(b.strips), dtype=np.int32)).to(dev)


def main() -> None:
    import numpy as np
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--sass", type=Path, help="write the unedited K1 source's SASS here")
    parser.add_argument("--kernels", nargs="+", choices=sorted(KERNELS), default=sorted(KERNELS),
                        help="the kernels whose variants to build and time (default: all)")
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("tools/k1_variants.py: needs a CUDA card")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.workloads import RESNET50_TABLE1, conv_layer_job
    from repro_torch.kernels import _build
    from repro_torch.kernels.activity_profile import kernel as K

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    out_dir = ROOT / "build" / "k1_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for kernel, (source_name, entry, variants) in KERNELS.items():
        if kernel not in opts.kernels:
            continue
        source = (_build.CSRC / f"{source_name}.cu").read_text()
        for name, edits in variants.items():
            text = source
            for old, new in edits:
                if text.count(old) != 1:
                    sys.exit(f"{kernel} variant {name!r}: {old!r} is not in the source once")
                text = text.replace(old, new)
            stem = f"{kernel}_" + re.sub(r"\W+", "_", name)
            (out_dir / f"{stem}.cu").write_text(text)
            lib = out_dir / f"{stem}.so"
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(lib),
                   str(out_dir / f"{stem}.cu")]
            procs[kernel, name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                    stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for (kernel, name), (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"{kernel} variant {name!r} did not build:\n{log}")
        source_name, entry, _ = KERNELS[kernel]
        # ptxas reports each entry function: its stack and spills, then its registers
        regs, spills, current = [], [], ""
        for line in log.splitlines():
            found = re.search(r"Compiling entry function '(\S+)'", line)
            if found:
                current = found.group(1)
            elif f"{entry}_kernel" in current and "Used" in line:
                regs.append(line.split("Used")[1].split(",")[0].strip())
            elif f"{entry}_kernel" in current and "spill stores" in line:
                spills.append(line.strip())
        print(f"{kernel} {name}: {', '.join(sorted(set(regs)))}; {' / '.join(sorted(set(spills)))}")
        handle = ctypes.CDLL(str(lib))
        fn = getattr(handle, entry)
        fn.argtypes, fn.restype = _build.SOURCES[source_name][entry]
        libs[kernel, name] = fn
    if opts.sass and "K1" in opts.kernels:
        cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
        opts.sass.parent.mkdir(parents=True, exist_ok=True)
        opts.sass.write_text(subprocess.run([cuobjdump, "-sass", str(procs["K1", "as built"][1])],
                                            capture_output=True, text=True, check=True).stdout)

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    stream = torch._C._cuda_getCurrentRawStream(0)
    # (kernel, input name, callable that launches a variant, the plain version's counts)
    cases = []
    k1_out = torch.empty(2, dtype=torch.int64, device=dev)
    for i, layer in enumerate(RESNET50_TABLE1):
        a, w = conv_layer_job(layer, seed=i).operands()
        a_t = torch.from_numpy(a.astype(np.int32)).to(dev)
        w_t = torch.from_numpy(w.astype(np.int32)).to(dev)

        def k1(fn, a_t=a_t, w_t=w_t):
            (m, k), n = a_t.shape, w_t.shape[1]
            return fn(a_t.data_ptr(), w_t.data_ptr(), k1_out.data_ptr(), m, k, n, 32, 32, 16, 37,
                      stream)

        cases.append(("K1", layer.name, k1, k1_out,
                      K.ws_activity_toggles_plain(a_t, w_t, 32, 32, 16, 37).tolist()))
    arrays = table1_ws_bucket(dev)
    (num_strips, t1, rows), (num_tiles, _, cols) = arrays[0].shape, arrays[1].shape
    k2_out = torch.empty(arrays[2].shape[0], dtype=torch.int64, device=dev)

    def k2(fn):
        return fn(*(x.data_ptr() for x in arrays), k2_out.data_ptr(), k2_out.shape[0], num_strips,
                  num_tiles, t1, rows, cols, 37, stream)

    cases.append(("K2", f"Table-I WS bucket, {k2_out.shape[0]} tasks", k2, k2_out,
                  K.ws_task_toggles_plain(*arrays, 37).tolist()))
    for strips, what in ((arrays[0], "WS strips"), (table1_os_strips(dev), "OS strips")):
        k3_out = torch.empty(strips.shape[0], dtype=torch.int64, device=dev)

        def k3(fn, strips=strips, k3_out=k3_out):
            return fn(strips.data_ptr(), k3_out.data_ptr(), *strips.shape, 16, stream)

        cases.append(("K3", f"Table-I {what} {tuple(strips.shape)}", k3, k3_out,
                      K.strip_toggles_plain(strips, 16).tolist()))

    def median_ms(call, calls=20, bursts=5):
        times = []
        for burst in range(bursts + 1):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(calls):
                call()
            end.record()
            end.synchronize()
            if burst:
                times.append(start.elapsed_time(end) / calls)
        return statistics.median(times)

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    # 128 MiB > the 50 MB L2, read as row sums (no reduction across blocks)
    flush = torch.zeros((32 << 10, 1024), dtype=torch.int32, device=dev)

    def device_events(prof):
        return {ev.key: ev.self_device_time_total / 1e3 for ev in prof.key_averages()
                if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0}

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        flush.sum(dim=1)
        torch.cuda.synchronize()
    flush_keys = set(device_events(prof)) | {"Activity Buffer Request"}

    def device_ms(call, calls=20):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                flush.sum(dim=1)
                call()
            torch.cuda.synchronize()
        return sum(ms for key, ms in device_events(prof).items() if key not in flush_keys) / calls

    for turn in range(2):
        for (kernel, name), fn in libs.items():
            times = []
            for case_kernel, what, run, out, want in cases:
                if case_kernel != kernel:
                    continue
                if run(fn):
                    sys.exit(f"{kernel} variant {name!r}: launch failed on {what}")
                if out.tolist() != want:
                    sys.exit(f"{kernel} variant {name!r} on {what}: counts differ from the plain "
                             f"version's")
                times.append(device_ms(lambda: run(fn)) if kernel == "K3" else
                             median_ms(lambda: run(fn)))
            print(f"turn {turn} {kernel} {name:34s} {sum(times):.5f} ms: "
                  + " ".join(f"{ms:.5f}" for ms in times))


if __name__ == "__main__":
    main()
