#!/usr/bin/env python3
"""``chip_smoke.py``'s model-stack phases alone on one card: 6 (the model
path), 7 (training) and 8 (the mesh path, which holds its forward to phase
6's and prints its dry-run roofline beside phase 7's measured step, so it
runs both first).

    python3 tools/model_phases.py          # phases 6, 7 and 8
    python3 tools/model_phases.py 7        # phase 7 alone

Runs the phases with ``chip_smoke``'s own launch counters and timers and
the settings ``chip_smoke.main`` gives them (cuBLAS's workspace fixed
before CUDA starts, TF32 off), and builds the kernels first where phase 6
runs (K7 runs on phases 6 and 8; phase 7 launches none).  Prints the
card's name and power limit and numpy's version first (phase 7's Zipf
stream depends on it).  Exits non-zero on any mismatch, as the phases do.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("phases", nargs="*", type=int, choices=(6, 7, 8))
    phases = set(ap.parse_args().phases or (6, 7, 8))
    if 8 in phases:
        phases |= {6, 7}
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("tools/model_phases.py runs on a CUDA card")
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as C
    from repro_torch.kernels import _build

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = C.card_line()
    print(f"card: {smi} | torch {torch.__version__} cuda {torch.version.cuda} | "
          f"numpy {np.__version__}", flush=True)
    results = {}
    if 6 in phases:
        t0 = time.perf_counter()
        _build.build()
        print(f"build: {time.perf_counter() - t0:.2f} s", flush=True)
        results[6] = C.model_path_check(dev=dev, smi=smi)
        torch.cuda.empty_cache()
    if 7 in phases:
        results[7] = C.training_path_check(dev=dev, smi=smi)
        print({key: value for key, value in results[7].items() if key != "launches"})
        torch.cuda.empty_cache()
    if 8 in phases:
        mesh = C.mesh_path_check(dev=dev, smi=smi, model=results[6], training=results[7])
        print({key: value for key, value in mesh.items() if key != "dryrun"})


if __name__ == "__main__":
    main()
