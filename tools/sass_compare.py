#!/usr/bin/env python3
"""Compare the SASS of kernels between this checkout and another tree.

    python3 tools/sass_compare.py OTHER_ROOT SOURCE KERNEL [KERNEL ...]

Builds ``src/repro_torch/csrc/SOURCE.cu`` of this checkout and of the tree
at OTHER_ROOT (for example a ``git archive`` of the parent commit) with the
port's ``nvcc`` flags into ``build/sass_compare/``, dumps both with
``cuobjdump -sass`` and compares, for every function whose name holds one
of the KERNEL names, its instructions with the addresses and encodings
taken out.  Prints one line per function: its instruction count and
"same", or the first instruction that differs.  Exits 1 if a function
differs or is on one side only.  Needs ``nvcc`` and ``cuobjdump`` (the
CUDA toolkit), not a card.
"""

from __future__ import annotations

import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels._build import NVCC_FLAGS, _nvcc  # noqa: E402

OUT = ROOT / "build" / "sass_compare"


def sass(root: Path, source: str, tag: str) -> dict[str, list[str]]:
    """Each function of ``root``'s build of ``source`` -> its instructions."""
    OUT.mkdir(parents=True, exist_ok=True)
    lib = OUT / f"{source}-{tag}.so"
    src = root / "src" / "repro_torch" / "csrc" / f"{source}.cu"
    subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(lib), str(src)], check=True,
                   capture_output=True, text=True, timeout=600)
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([cuobjdump, "-sass", str(lib)], check=True, capture_output=True,
                          text=True, timeout=120).stdout
    functions = {}
    for part in text.split("Function : ")[1:]:
        name, body = part.split("\n", 1)
        lines = []
        for line in body.splitlines():
            line = re.sub(r"/\*[0-9a-f]{4,}\*/", "", line)  # address
            line = re.sub(r"/\* 0x[0-9a-f]+ \*/", "", line).strip()  # encoding
            if line and not line.startswith(("..", ".section", "Fatbin", "code for")):
                lines.append(line)
        # the anonymous namespace's name holds a hash of the file
        functions[re.sub(r"_GLOBAL__N__[0-9a-f]+_", "_GLOBAL__N__", name.strip())] = lines
    return functions


def main() -> None:
    if len(sys.argv) < 4:
        sys.exit(__doc__)
    other, source, kernels = Path(sys.argv[1]).resolve(), sys.argv[2], sys.argv[3:]
    mine, theirs = sass(ROOT, source, "this"), sass(other, source, "other")
    failed = False
    for name in sorted(set(mine) | set(theirs)):
        if not any(k in name for k in kernels):
            continue
        a, b = mine.get(name), theirs.get(name)
        if a is None or b is None:
            print(f"{source} {name[:100]}: only in {'the other tree' if a is None else 'this checkout'}")
            failed = True
        elif a == b:
            print(f"{source} {name[:100]}: {len(a)} instructions, same")
        else:
            i = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))
            print(f"{source} {name[:100]}: {len(a)} against {len(b)} instructions, first "
                  f"difference at {i}: {a[i] if i < len(a) else '-'!r} against "
                  f"{b[i] if i < len(b) else '-'!r}")
            failed = True
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
