#!/usr/bin/env python3
"""The lane counters L1 (``ws_lane_toggles``) and L2 (``stream_lane_toggles``)
alone on a CUDA card: a short check of a new build before ``chip_smoke.py``.

    python3 tools/lane_probe.py

Builds ``csrc/lane_toggles.cu`` (and K1's source, which the checks use),
prints ptxas's registers and spills and the POPC, VOTE, REDUX and SHFL
counts of each lane kernel's SASS, then holds L1 and L2 against their
plain versions bit for bit: L1 on the six ResNet50 Table-I GEMMs at b_v =
37 (its lane sums also K1's v count) and on edge shapes at rows 8, 32 and
48; L2 on each layer's WS A, OS A^T and OS W streams at buses of 8, 16 and
33 bits (at 16 bits its lane sums also K4's count) and on edge streams at
buses of 1-64 bits.  Times: L1 per layer by CUDA events (20 calls after a
warm-up), and each L2 stream's device time by ``torch.profiler`` over 20
calls with the L2 cache flushed by a read before each (kernel and memset).
Exits non-zero on any mismatch.
"""

from __future__ import annotations

import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SASS_OPS = {"POPC": r"\bPOPC\b", "VOTE": r"\bVOTE\b", "REDUX": r"\bREDUX\b", "SHFL": r"\bSHFL\."}
# (M, K, N, b_v), each at rows 8, 32 and 48; (T, L) streams
L1_EDGES = [(40, 70, 33, b_v) for b_v in (1, 16, 32, 33, 37, 64)] + [
    (m, 40, 65, 37) for m in (2, 3, 16, 17, 46)] + [
    (20, 33, n, 37) for n in (1, 31, 33, 130, 300)] + [(100, 64, 64, 64), (31, 100, 129, 40)]
L2_EDGES = [(2, 1), (3, 7), (37, 300), (481, 5), (482, 300), (961, 33), (1000, 257),
            (2000, 5000), (16, 600_000)]
L2_EDGE_BITS = (1, 8, 16, 32, 33, 64)


def main() -> None:
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        sys.exit("tools/lane_probe.py: needs a CUDA card")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.workloads import RESNET50_TABLE1, conv_layer_job
    from repro_torch.kernels import _build
    from repro_torch.kernels.activity_profile import kernel as K

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(),
          f"| torch {torch.__version__}", flush=True)
    for name, log in _build.build(["lane_toggles", "activity_profile"]).items():
        for line in log.splitlines():
            if name == "lane_toggles" and ("registers" in line or "spill" in line):
                print(f"  ptxas[{name}] {line.strip()}")
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", str(_build._target("lane_toggles")[1])],
                          capture_output=True, text=True, check=True).stdout
    for part in sass.split("Function : ")[1:]:
        counts = {op: len(re.findall(pattern, part)) for op, pattern in SASS_OPS.items()}
        print(f"  sass {part.split()[0][:90]}: {counts}")

    dev = torch.device("cuda", 0)

    def on_card(x):
        return torch.from_numpy(np.ascontiguousarray(x, dtype=np.int32)).to(dev)

    def events_ms(fn, calls=20):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / calls

    flush = torch.zeros((32768, 1024), dtype=torch.int32, device=dev)  # 128 MiB

    def device_ms(fn, calls=20):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                flush.sum(dim=1)
                fn()
            torch.cuda.synchronize()
        return {ev.key[:60]: ev.self_device_time_total / 1e3 / calls for ev in prof.key_averages()
                if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0
                and ("lane" in ev.key or "Memset" in ev.key)}

    bad = []

    def same(kernel, plain, args, what):
        got, want = kernel(*args).tolist(), plain(*args).tolist()
        if got != want:
            bad.append(what)
            print(f"  MISMATCH {what}: kernel {got} plain {want}", flush=True)
        return got

    l1_total = 0.0
    for i, layer in enumerate(RESNET50_TABLE1):
        a, w = conv_layer_job(layer, seed=i, dataflow="WS").operands()
        a_t, w_t = on_card(a), on_card(w)
        lanes = same(K.ws_lane_toggles, K.ws_lane_toggles_plain, (a_t, w_t, 32, 37), layer.name)
        if sum(lanes) != K.ws_activity_toggles(a_t, w_t, 32, 32, 16, 37).tolist()[1]:
            bad.append(f"{layer.name} L1 sum")
        ms = events_ms(lambda: K.ws_lane_toggles(a_t, w_t, 32, 37))
        l1_total += ms
        print(f"  {layer.name} L1 {a.shape[0]}x{a.shape[1]}x{w.shape[1]}: {ms:.4f} ms", flush=True)
        for x, what in ((a, "WS A"), (a.T, "OS A^T"), (w, "OS W")):
            x_t = on_card(x)
            for bits in (8, 16, 33):
                lanes = same(K.stream_lane_toggles, K.stream_lane_toggles_plain, (x_t, bits),
                             f"{layer.name} {what} b={bits}")
                if bits == 16 and sum(lanes) != int(K.operand_stream_toggles(x_t, 16).item()):
                    bad.append(f"{layer.name} {what} L2 sum")
            print(f"  {layer.name} L2 {what} {x.shape}: device "
                  f"{device_ms(lambda: K.stream_lane_toggles(x_t, 16))}", flush=True)
    print(f"L1, six layers: {l1_total:.4f} ms (CUDA events)")
    rng = np.random.default_rng(0)
    for m, k, n, b_v in L1_EDGES:
        a = rng.choice([-32767, 32767, -1, 0, 1, 12345], size=(m, k))
        w = rng.choice([-32767, 32767, -1, 0, 1, -23456], size=(k, n))
        for rows in (8, 32, 48):
            same(K.ws_lane_toggles, K.ws_lane_toggles_plain, (on_card(a), on_card(w), rows, b_v),
                 f"L1 edge {(m, k, n)} rows={rows} b_v={b_v}")
    for t_len, lanes_ in L2_EDGES:
        x_t = on_card(rng.integers(-32767, 32768, size=(t_len, lanes_)))
        for bits in L2_EDGE_BITS:
            same(K.stream_lane_toggles, K.stream_lane_toggles_plain, (x_t, bits),
                 f"L2 edge {(t_len, lanes_)} b={bits}")
    print(f"edge cases: L1 {3 * len(L1_EDGES)}, L2 {len(L2_EDGES) * len(L2_EDGE_BITS)}; "
          f"mismatches {len(bad)}")
    if bad:
        sys.exit(1)


if __name__ == "__main__":
    main()
