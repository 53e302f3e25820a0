#!/usr/bin/env python3
"""How reliably ``torch.profiler`` records the K7 launches of a model forward.

    python3 tools/trace_counts.py [--layers 36] [--traces 10]

Builds Qwen3-8B at its published widths in bf16 (``--layers`` of its 36;
weights drawn on the card from seed 0), runs ``forward(last_only=True)`` at
B = 4, S = 2048 on the K7 route, and traces it ``--traces`` times with each
of two activity sets: CPU + CUDA (as ``chip_smoke.py`` traces) and CUDA
alone.  Per trace it prints the K7 bf16 kernel records the trace holds
(``flash_attention_tc_kernel``), the launches the wrapper counted in the
same forward, and the device records in all.  Prints the card's name and
power limit first.
"""

from __future__ import annotations

import argparse
import dataclasses
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=36)
    ap.add_argument("--traces", type=int, default=10)
    args = ap.parse_args()

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels.flash_attention import kernel as FA
    from repro_torch.models import model as M

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    cfg = dataclasses.replace(get_arch("qwen3_8b"), n_layers=args.layers).with_dtypes(
        "bfloat16", "bfloat16")
    gen = torch.Generator(device=dev).manual_seed(0)
    params, _ = M.init_params(cfg, gen)
    tokens = torch.randint(0, cfg.vocab_size, (4, 2048), generator=gen, device=dev)
    M.forward(cfg, params, tokens, last_only=True)  # builds K7, warms up
    torch.cuda.synchronize()
    for label, activities in (("cpu+cuda", [ProfilerActivity.CPU, ProfilerActivity.CUDA]),
                              ("cuda", [ProfilerActivity.CUDA])):
        seen = []
        for _ in range(args.traces):
            before = FA.flash_attention_fwd.tc_launches
            with profile(activities=activities) as prof:
                M.forward(cfg, params, tokens, last_only=True)
                torch.cuda.synchronize()
            launched = FA.flash_attention_fwd.tc_launches - before
            events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
            k7 = sum(e.count for e in events if "flash_attention_tc" in e.key)
            seen.append((k7, launched, sum(e.count for e in events)))
        print(f"{label}: (K7 records, K7 launches, device records) per trace: {seen}", flush=True)


if __name__ == "__main__":
    main()
