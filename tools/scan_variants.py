#!/usr/bin/env python3
"""Build variants of L3 (``csrc/selective_scan.cu``) and time them on a CUDA
card at Jamba-Mini's width (batch 1, S 7680, d_inner 8192, N 16, bf16).

    python3 tools/scan_variants.py [--turns 2]

Each variant is the source with a few lines edited, built with the port's
``nvcc`` flags into ``build/scan_variants/`` and called through its C
entry on seeded inputs made on the card.  Per variant: ptxas's registers
and spills, the time of one launch (CUDA events, median of 3 bursts of 10
launches after a warm-up) and its relative L2 from the built kernel's
output (variants that drop work are timing probes and read far off).
Variants are run in turns, in order and then in reverse, ``--turns``
times.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "scan_variants"

# name -> [(old, new)] edits of the source
VARIANTS = {
    "built": [],
    "no_scan_exp": [("h[0] = fmaf(exp2_sfu(deltas[g] * a2[0]),", "h[0] = fmaf((deltas[g] * a2[0]),"),
                    ("h[1] = fmaf(exp2_sfu(deltas[g] * a2[1]),", "h[1] = fmaf((deltas[g] * a2[1]),")],
    "no_staging_math": [("return x > 20.f ? x : log1pf(exp2_sfu(x * kLog2e));", "return x;"),
                        ("return __fdividef(x, 1.f + exp2_sfu(-x * kLog2e));", "return x;")],
    "min_blocks_3": [("__global__ void __launch_bounds__(kThreads, 4)",
                      "__global__ void __launch_bounds__(kThreads)")],
}


def build(name: str, edits: list) -> tuple[Path, str]:
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    src = (_build.CSRC / "selective_scan.cu").read_text()
    for old, new in edits:
        if old not in src:
            raise SystemExit(f"variant {name}: {old!r} not in the source")
        src = src.replace(old, new)
    OUT.mkdir(parents=True, exist_ok=True)
    path = OUT / f"{name}.cu"
    path.write_text(src)
    lib = OUT / f"{name}.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(lib), str(path)]
    return lib, cmd


def main() -> None:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--turns", type=int, default=2)
    parser.add_argument("--seq", type=int, default=7680)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("tools/scan_variants.py: needs a CUDA card")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    jobs = {name: build(name, edits) for name, edits in VARIANTS.items()}
    procs = {name: subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for name, (_, cmd) in jobs.items()}
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(f"{name}: build failed\n{log}")
            continue
        regs = re.findall(r"Used (\d+) registers", log)
        spills = re.findall(r"(\d+) bytes spill stores", log)
        print(f"{name}: registers {regs}, spill stores {spills}")
        fn = ctypes.CDLL(str(jobs[name][0])).selective_scan_fwd
        fn.argtypes, fn.restype = _build.SOURCES["selective_scan"]["selective_scan_fwd"]
        fns[name] = fn

    dev = torch.device("cuda", 0)
    s, di, n = args.seq, 8192, 16
    gen = torch.Generator(device=dev).manual_seed(5)

    def draw(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    bf = torch.bfloat16
    u, dt, z = (draw(1, s, di).to(bf) for _ in range(3))
    b, c = (draw(1, s, n).to(bf) for _ in range(2))
    a, d, bias = -torch.exp(draw(di, n, scale=2.0)), 1 + 0.1 * draw(di), draw(di, scale=3.0)
    stream = torch.cuda.current_stream().cuda_stream
    strides = [st for x in (u, dt, z, b, c) for st in x.stride()[:2]]

    def call(fn, y):
        err = fn(u.data_ptr(), dt.data_ptr(), z.data_ptr(), b.data_ptr(), c.data_ptr(),
                 a.data_ptr(), d.data_ptr(), bias.data_ptr(), y.data_ptr(), 1, s, di, *strides, 0,
                 stream)
        assert err == 0, err

    outs = {name: torch.empty_like(u) for name in fns}
    for name, fn in fns.items():
        call(fn, outs[name])
    torch.cuda.synchronize()
    built = outs["built"].float()
    times = {name: [] for name in fns}
    order = list(fns)
    for turn in range(args.turns):
        for name in (order if turn % 2 == 0 else order[::-1]):
            bursts = []
            for _ in range(3):
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(10):
                    call(fns[name], outs[name])
                end.record()
                end.synchronize()
                bursts.append(start.elapsed_time(end) / 10)
            times[name].append(statistics.median(bursts))
    for name in fns:
        rel = ((outs[name].float() - built).norm() / built.norm()).item()
        print(f"{name}: {' / '.join(f'{t:.4f}' for t in times[name])} ms a launch; "
              f"relative L2 from built {rel:.3e}")


if __name__ == "__main__":
    main()
