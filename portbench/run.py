"""Run one cell of the port's benchmark on the card:

    python -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Prints one JSON result as the last line of
standard output; exits with another code than 0, printing no result,
where there is no CUDA device or the run fails.  Build and kernel caches
stay inside the checkout, under ``build/``.
"""

import time

T0 = time.perf_counter()  # set-up is timed from here

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "portbench"
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
sys.path.insert(0, str(ROOT / "src"))

if __name__ == "__main__":
    from portbench.harness import main

    sys.exit(main(t0=T0))
