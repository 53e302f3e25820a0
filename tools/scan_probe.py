#!/usr/bin/env python3
"""L3 (Mamba's fused selective scan) on a CUDA card: its build, a check at
Jamba-Mini's width, and one Mamba layer on either scan route.

    python3 tools/scan_probe.py [--seq 7680]

Prints the card's name and power limit, ptxas's registers, shared memory
and spills for the kernel, then, at d_inner 8192, N 16, batch 1 and
``--seq`` tokens in bf16:

* L3 against its plain version (relative L2) and its time (CUDA events
  over a burst, the L2 flushed before each launch) beside its bound
  (``portbench/ssm_counts.py``: bytes at 3.35 TB/s or float32 operations
  at 67 TFLOP/s);
* one whole Mamba layer of Jamba-Mini (``models/ssm.mamba_apply``: in_proj,
  the convolution, x_proj, the inner norms, dt_proj, the scan, out_proj),
  its scan on the chunked PyTorch route and on L3, timed in turns with
  events, with the two outputs' relative L2.
"""

from __future__ import annotations

import argparse
import dataclasses
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _time_ms(fn, reps: int, flush=None) -> float:
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        if flush is not None:
            flush()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def main() -> None:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seq", type=int, default=7680)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("tools/scan_probe.py: needs a CUDA card")
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from portbench import ssm_counts
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels import _build
    from repro_torch.kernels.selective_scan import kernel as SS
    from repro_torch.models import ssm

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    for line in _build.build(["selective_scan"]).get("selective_scan", "").splitlines():
        if "registers" in line or "spill" in line or "stack" in line:
            print("ptxas:", line.strip())
    dev = torch.device("cuda", 0)
    cfg = dataclasses.replace(get_arch("jamba_v01_52b"), mamba_inner_norms=True)
    di, n, s = cfg.mamba_expand * cfg.d_model, cfg.mamba_d_state, args.seq
    gen = torch.Generator(device=dev).manual_seed(5)

    def draw(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    bf = torch.bfloat16
    ops = (draw(1, s, di).to(bf), draw(1, s, di).to(bf), draw(1, s, di).to(bf),
           draw(1, s, n).to(bf), draw(1, s, n).to(bf), -torch.exp(draw(di, n, scale=2.0)),
           1 + 0.1 * draw(di), draw(di, scale=3.0))
    got = SS.selective_scan_fwd(*ops).float()
    plain = SS.selective_scan_fwd_plain(*(o.float() for o in ops))
    print(f"L3 bf16 against its plain version in float32: relative L2 "
          f"{((got - plain).norm() / plain.norm()).item():.3e}")
    flush_buf = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    l3_ms = _time_ms(lambda: SS.selective_scan_fwd(*ops), 20, flush=flush_buf.zero_)
    model = {"d_model": cfg.d_model, "mamba_expand": cfg.mamba_expand, "mamba_d_state": n}
    bound_ms = 1e3 * ssm_counts.scan_bound_s(model, 1, s, {"hbm_bytes_per_s": 3.35e12})
    print(f"L3 at (1, {s}, {di}, {n}): {l3_ms:.4f} ms a launch (L2 flushed), bound "
          f"{bound_ms:.4f} ms ({100 * bound_ms / l3_ms:.1f}% of it); bytes "
          f"{ssm_counts.scan_bytes(model, 1, s) / 1e9:.4f} GB, operations "
          f"{ssm_counts.scan_ops(model, 1, s) / 1e9:.4f} G")

    p = ssm.Mamba(torch.Generator(device=dev).manual_seed(3), cfg, None, dtype=bf,
                  device=dev).stage(None)
    with torch.no_grad():
        p["A_log"].copy_(draw(di, n, scale=2.0))
        p["dt_bias"].copy_(draw(di, scale=3.0))
    x = draw(1, s, cfg.d_model).to(bf)
    real_route = ssm.scan_route

    def layer(route):
        ssm.scan_route = lambda *operands: route
        try:
            with torch.inference_mode():
                return ssm.mamba_apply(p, x, cfg)
        finally:
            ssm.scan_route = real_route

    fused, chunked = layer("kernel").float(), layer("chunked").float()
    print(f"one Mamba layer, L3 against the chunked route: relative L2 "
          f"{((fused - chunked).norm() / chunked.norm()).item():.3e}")
    times = {"chunked": [], "kernel": []}
    for route in ("chunked", "kernel", "kernel", "chunked"):
        times[route].append(_time_ms(lambda: layer(route), 5))
    print("one Mamba layer (bf16, B 1, S %d): chunked route %s ms, L3 route %s ms"
          % (s, " / ".join(f"{t:.3f}" for t in times["chunked"]),
             " / ".join(f"{t:.3f}" for t in times["kernel"])))


if __name__ == "__main__":
    main()
