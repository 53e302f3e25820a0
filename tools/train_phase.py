#!/usr/bin/env python3
"""``chip_smoke.py``'s phase 7, the training path, alone on one card.

    python3 tools/train_phase.py

Runs ``chip_smoke.training_path_check`` with the settings ``chip_smoke.main``
gives it (cuBLAS's workspace fixed before CUDA starts, TF32 off) and every
kernel launch count of the port reset before it and read after: the ten
reduced archs against ``train_reference.json``, crash and restart bit for
bit, and Qwen3-8B at full width with 2 layers.  Prints the card's name and
power limit and numpy's version first (the pipeline's Zipf stream depends
on it).  It builds no kernel: the training path launches none.  Exits
non-zero on any mismatch, as the phase does.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

COUNTS = ("launches", "tc_launches", "tf32_launches", "prep_launches")


def main() -> None:
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("tools/train_phase.py runs on a CUDA card")
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as C
    from repro_torch.kernels.activity_profile import kernel as K
    from repro_torch.kernels.flash_attention import kernel as FA
    from repro_torch.kernels.toggle_count import kernel as TC
    from repro_torch.kernels.ws_matmul import kernel as WM

    torch.backends.cuda.matmul.allow_tf32 = False
    wrappers = [getattr(K, name) for name in C.KERNELS[:4]]
    wrappers += [TC.stream_toggles, WM.ws_gemm, FA.flash_attention_fwd]

    def reset_counts() -> None:
        for fn in wrappers:
            for attr in COUNTS:
                if hasattr(fn, attr):
                    setattr(fn, attr, 0)

    def read_counts() -> dict:
        return {f"{fn.__name__}.{attr}": getattr(fn, attr) for fn in wrappers for attr in COUNTS
                if hasattr(fn, attr)}

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"card: {smi} | torch {torch.__version__} | numpy {np.__version__}", flush=True)
    out = C.training_path_check(dev=torch.device("cuda", 0), smi=smi, reset_counts=reset_counts,
                                read_counts=read_counts)
    print({key: value for key, value in out.items() if key != "launches"})


if __name__ == "__main__":
    main()
