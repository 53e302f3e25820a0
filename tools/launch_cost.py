#!/usr/bin/env python3
"""Host cost of one K5 (``stream_toggles``) call on a CUDA card, piece by piece,
and of one K3 (``strip_toggles``) call.

    python3 tools/launch_cost.py

Each line is the mean host time of many back-to-back calls after a warm-up
(microseconds; the card is drained at the end of each line and the time
with the drain is the same where the host is the bound).  The stream is
ResNet50 Table-I layer L1's transposed activations, 256 x 3136 int32, on a
16-bit bus.  Besides the whole wrapper it times the wrapper's parts, and a
launch that builds a ``torch.cuda.Stream`` and always enters the device
context, to compare with ``_engine.launch``.  K3 runs on 720 strips of 129 x
32 int32 (the shape of the Table-I WS strips), whole and as its C entry
alone, looked up in whichever source holds it, so that the tool runs
unchanged in another tree of the repository.
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("tools/launch_cost.py: needs a CUDA card")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build, _engine
    from repro_torch.kernels.activity_profile import kernel as K
    from repro_torch.kernels.bitops import bus_mask
    from repro_torch.kernels.toggle_count import kernel as TC

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t_len, lanes = 256, 3136
    x = torch.randint(-1000, 1000, (t_len, lanes), dtype=torch.int32, device=dev)
    out = torch.empty(1, dtype=torch.int64, device=dev)
    fn = _build.load("toggle_count").stream_toggles
    mask = bus_mask(16) & (2**64 - 1)
    args = (x.data_ptr(), out.data_ptr(), t_len, lanes, 4, mask)

    def stream_object_launch():
        with torch.cuda.device(dev):
            fn(*args, torch.cuda.current_stream(dev).cuda_stream)

    def device_context():
        with torch.cuda.device(dev):
            pass

    cases = [
        ("stream_toggles (the whole wrapper)", lambda: TC.stream_toggles(x, 16)),
        ("_engine.launch", lambda: _engine.launch("toggle_count", "stream_toggles", dev, *args)),
        ("launch through a torch.cuda.Stream and the device context", stream_object_launch),
        ("the C entry alone (memset + kernel launch)",
         lambda: fn(*args, torch._C._cuda_getCurrentRawStream(0))),
        ("torch.cuda.current_stream(dev).cuda_stream", lambda: torch.cuda.current_stream(dev).cuda_stream),
        ("torch._C._cuda_getCurrentRawStream(0)", lambda: torch._C._cuda_getCurrentRawStream(0)),
        ("with torch.cuda.device(dev)", device_context),
        ("torch.cuda.current_device()", torch.cuda.current_device),
        ("torch.empty(1, int64) on the card", lambda: torch.empty(1, dtype=torch.int64, device=dev)),
        ("torch.zeros(1, int64) on the card", lambda: torch.zeros(1, dtype=torch.int64, device=dev)),
        ("the wrapper's checks", lambda: TC._check_stream(x, 16)),
    ]
    strips = torch.randint(-1000, 1000, (720, 129, 32), dtype=torch.int32, device=dev)
    k3_out = torch.empty(720, dtype=torch.int64, device=dev)
    k3_source = next(name for name, entries in _build.SOURCES.items() if "strip_toggles" in entries)
    k3 = _build.load(k3_source).strip_toggles
    cases += [
        ("strip_toggles (K3, the whole wrapper)", lambda: K.strip_toggles(strips, 16)),
        (f"the K3 C entry alone ({k3_source}.cu)",
         lambda: k3(strips.data_ptr(), k3_out.data_ptr(), 720, 129, 32, 16,
                    torch._C._cuda_getCurrentRawStream(0))),
    ]
    calls = 3000
    for name, call in cases:
        for _ in range(200):
            call()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            call()
        host = (time.perf_counter() - t0) / calls * 1e6
        torch.cuda.synchronize()
        drained = (time.perf_counter() - t0) / calls * 1e6
        print(f"{name:60s} {host:8.2f} us a call ({drained:.2f} with the drain)")


if __name__ == "__main__":
    main()
