"""Build the CUDA sources under ``csrc/`` and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
into ``build/repro_torch/<name>-<digest>.so`` at the root of the checkout
(the digest is of the source, every ``csrc/*.cuh`` header and the flags,
so an edited source or header builds anew), then loaded with ``ctypes``.
No PyTorch header is included, which keeps a build to seconds.  Nothing is built when this module is imported: ``load`` builds at
first use, and ``build`` starts one ``nvcc`` per source, all at once.
A failed build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["SOURCES", "build", "load"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "--ptxas-options=-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_U64 = ctypes.c_uint64
_F = ctypes.c_float
# C signature of every entry point: (argtypes, restype) by source and name.
SOURCES: dict[str, dict[str, tuple[list, type]]] = {
    "activity_profile": {
        # a, w, out, m, k, n, rows, cols, b_h, b_v, stream
        "ws_activity_toggles": ([_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P], _I),
    },
    "activity_batch": {
        # strips, w_tiles, strip_ids, w_ids, valid_r, out,
        # num_tasks, num_strips, num_tiles, t1, rows, cols, b_v, stream
        "ws_task_toggles": ([_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P], _I),
    },
    "toggle_count": {
        # x, out, t_len, lanes, elem_bytes, mask, stream
        "stream_toggles": ([_P, _P, _L, _L, _I, _U64, _P], _I),
        # strips, out, num_strips, t1, lanes, bits, stream
        "strip_toggles": ([_P, _P, _I, _I, _I, _I, _P], _I),
    },
    "lane_toggles": {
        # a, w, out, m, k, n, rows, b_v, stream
        "ws_lane_toggles": ([_P, _P, _P, _I, _I, _I, _I, _I, _P], _I),
        # x, out, t_len, lanes, bits, stream
        "stream_lane_toggles": ([_P, _P, _L, _L, _I, _P], _I),
    },
    "ws_matmul": {
        # a, w, planes, out, m, k, n, dtype (0 int8, 1 int16, 2 bf16, 3 f32), stream
        "ws_gemm_tc": ([_P, _P, _P, _P, _I, _I, _I, _I, _P], _I),
        # a, w, a_planes, w_planes, m, k, n, kp, dtype, stream
        "gemm_operand_planes": ([_P, _P, _P, _P, _I, _I, _I, _I, _I, _P], _I),
    },
    "flash_attention": {
        # q, k, v, o, batch, heads, kv_heads, s_len, head_dim, causal, window,
        # scale, stream (bf16)
        "flash_attention_tc": ([_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _P], _I),
        # q, k, v, planes, o, batch, heads, kv_heads, s_len, head_dim, causal,
        # window, scale, stream (f32: the prep kernel, then three TF32 products)
        "flash_attention_tf32": ([_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _P], _I),
        # k, v, k_planes, vt_planes, bkv, s_len, head_dim, stream
        "attention_operand_planes": ([_P, _P, _P, _P, _I, _I, _I, _P], _I),
    },
    "selective_scan": {
        # u, dt, z, b, c, a, dskip, dt_bias, y, batch, seq, d_inner, the batch and
        # token strides of u, dt, z, b and c, dtype (0 bf16, 1 f32), stream
        "selective_scan_fwd": ([_P] * 9 + [_I, _I, _I] + [_L] * 10 + [_I, _P], _I),
    },
    "rms_norm": {
        # x, weight, cos, sin, y, rows, n1, n2, x's three leading strides, the
        # tables' batch and token strides, d, eps, dtype (0 bf16, 1 f32),
        # weight type (-1 none), rope, stream
        "rms_norm_rows": ([_P] * 5 + [_L, _I, _I] + [_L] * 5 + [_I, _F, _I, _I, _I, _P], _I),
    },
}

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _target(name: str) -> tuple[Path, Path]:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return src, BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(names=None) -> dict[str, str]:
    """Compile the named sources (default: all) that are not built yet, one
    ``nvcc`` process per source, all started together.  Returns the
    compiler's output for each source it compiled (register and spill
    counts from ptxas)."""
    names = list(SOURCES) if names is None else list(names)
    pending = {name: _target(name) for name in names}
    pending = {name: t for name, t in pending.items() if not t[1].exists()}
    logs = {}
    if pending:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = {}
        for name, (src, lib) in pending.items():
            tmp = lib.with_suffix(f".{os.getpid()}.tmp")
            procs[name] = (
                subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                    stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT,
                    text=True,
                ),
                tmp,
                lib,
            )
        failures = []
        for name, (proc, tmp, lib) in procs.items():
            log, _ = proc.communicate()
            logs[name] = log
            if proc.returncode != 0:
                failures.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
                continue
            os.replace(tmp, lib)  # atomic, so a concurrent loader never sees half a file
        if failures:
            raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed, with
    ``argtypes``/``restype`` set on every entry point."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_target(name)[1]))
            for fn, (argtypes, restype) in SOURCES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            _LIBS[name] = lib
        return lib
