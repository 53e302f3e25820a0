#!/usr/bin/env python3
"""Build variants of K1 (``ws_activity_toggles``) and time them on a CUDA card.

    python3 tools/k1_variants.py [--sass PATH]

Each variant is ``csrc/activity_profile.cu`` with a few constants edited
(run length kSteps, warps per block kWarps, the high-word packing at
b_v = 37), built with the port's ``nvcc`` flags into
``build/k1_variants/``.  Every variant must give the plain version's
counts on the six ResNet50 Table-I layers (32x32 array, b_h 16, b_v 37);
each is then timed there with CUDA events (median of 5 bursts of 20 calls,
after a warm-up), twice in turn.  ptxas's register and spill lines are
printed per variant; ``--sass PATH`` writes the unedited source's SASS
(``cuobjdump -sass``) to PATH.
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
VARIANTS = {
    "as built": [],
    "runs of 7": [("constexpr int kSteps = 15;", "constexpr int kSteps = 7;")],
    "runs of 31": [("constexpr int kSteps = 15;", "constexpr int kSteps = 31;")],
    "runs of 7, 8 warps": [("constexpr int kSteps = 15;", "constexpr int kSteps = 7;"),
                           ("constexpr int kWarps = 4;", "constexpr int kWarps = 8;")],
    "no high-word packing": [("launch(ws_activity_toggles_kernel<5>);",
                              "launch(ws_activity_toggles_kernel<32>);")],
}


def main() -> None:
    import numpy as np
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--sass", type=Path, help="write the unedited source's SASS here")
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("tools/k1_variants.py: needs a CUDA card")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.workloads import RESNET50_TABLE1, conv_layer_job
    from repro_torch.kernels import _build
    from repro_torch.kernels.activity_profile import kernel as K

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    source = (_build.CSRC / "activity_profile.cu").read_text()
    out_dir = ROOT / "build" / "k1_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in VARIANTS.items():
        text = source
        for old, new in edits:
            if text.count(old) != 1:
                sys.exit(f"variant {name!r}: {old!r} is not in the source once")
            text = text.replace(old, new)
        stem = re.sub(r"\W+", "_", name)
        (out_dir / f"{stem}.cu").write_text(text)
        lib = out_dir / f"{stem}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(out_dir / f"{stem}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"variant {name!r} did not build:\n{log}")
        regs = sorted({line.split("Used")[1].split(",")[0].strip()
                       for line in log.splitlines() if "ws_activity" not in line and "Used" in line})
        spills = sorted({line.strip() for line in log.splitlines() if "spill stores" in line})
        print(f"{name}: {', '.join(regs)}; {' / '.join(spills)}")
        handle = ctypes.CDLL(str(lib))
        handle.ws_activity_toggles.argtypes = _build.SOURCES["activity_profile"]["ws_activity_toggles"][0]
        handle.ws_activity_toggles.restype = ctypes.c_int
        libs[name] = handle
    if opts.sass:
        cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
        opts.sass.parent.mkdir(parents=True, exist_ok=True)
        opts.sass.write_text(subprocess.run([cuobjdump, "-sass", str(procs["as built"][1])],
                                            capture_output=True, text=True, check=True).stdout)

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    layers = []
    for i, layer in enumerate(RESNET50_TABLE1):
        a, w = conv_layer_job(layer, seed=i).operands()
        a_t = torch.from_numpy(a.astype(np.int32)).to(dev)
        w_t = torch.from_numpy(w.astype(np.int32)).to(dev)
        layers.append((layer.name, a_t, w_t, K.ws_activity_toggles_plain(a_t, w_t, 32, 32, 16, 37).tolist()))
    out = torch.empty(2, dtype=torch.int64, device=dev)

    def run(handle, a_t, w_t):
        (m, k), n = a_t.shape, w_t.shape[1]
        err = handle.ws_activity_toggles(a_t.data_ptr(), w_t.data_ptr(), out.data_ptr(), m, k, n,
                                         32, 32, 16, 37, torch._C._cuda_getCurrentRawStream(0))
        if err:
            sys.exit(f"launch failed with CUDA error {err}")

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

    for turn in range(2):
        for name, handle in libs.items():
            per_layer = []
            for layer, a_t, w_t, want in layers:
                run(handle, a_t, w_t)
                if out.tolist() != want:
                    sys.exit(f"variant {name!r} on {layer}: {out.tolist()}, plain version {want}")
                per_layer.append(median_ms(lambda: run(handle, a_t, w_t)))
            print(f"turn {turn} {name:22s} six layers {sum(per_layer):.4f} ms: "
                  + " ".join(f"{ms:.4f}" for ms in per_layer))


if __name__ == "__main__":
    main()
