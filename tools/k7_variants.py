#!/usr/bin/env python3
"""Build variants of K7's f32 kernel (``flash_attention_tf32``) and time
them on a CUDA card, with their error against a float64 rendering.

    python3 tools/k7_variants.py [--turns 2]

Each variant is ``csrc/flash_attention.cu`` with a few lines edited, built
with the port's ``nvcc`` flags into ``build/k7_variants/`` and called
through its C entry (the prep kernel and the kernel) on seeded f32 inputs
made on the card at the two attention cases of ``chip_smoke.py``: Qwen3-8B
prefill (H 32, KV 8, D 128, S 4096, causal) and Mixtral-8x7B (S 8192,
window 4096); and at a small case with logits in the tens (q scaled by
10, H 8, KV 2, S 300). Per variant and case: the largest |kernel -
float64| beside the plain f32 version's (both against the plain version
run in float64), and at the two model cases the time of one call (CUDA
events, median of 3 bursts of 10 calls after a warm-up). Variants are run
in turns, in order and then in reverse, ``--turns`` times. ptxas's
registers and spills of each variant's kernel are printed.
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

# P V of a key tile into a fresh accumulator, half of D at a time (N = D / 2,
# so the two accumulators fit beside Q's small plane), added to O on the
# CUDA cores; the tensor cores' f32 sum then spans one tile, not the row.
PV_AS_BUILT = """#pragma unroll
      for (int i = 0; i < D / 2; ++i) o_acc[i] *= alpha[(i >> 1) & 1];

      // O += P_s V_b + P_b V_s + P_b V_b: kKeys / 8 k slices each
      fence_regs(o_acc);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < kKeys / 8; ++j) wgmma_tf32_rs(o_acc, p_s[j], v_desc(v_b, j), 1);
#pragma unroll
      for (int j = 0; j < kKeys / 8; ++j) wgmma_tf32_rs(o_acc, p_b[j], v_desc(v_s, j), 1);
#pragma unroll
      for (int j = 0; j < kKeys / 8; ++j) wgmma_tf32_rs(o_acc, p_b[j], v_desc(v_b, j), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o_acc);
"""
PV_PER_TILE = """      constexpr int kParts = D >= 64 ? 2 : 1;
      constexpr int kPart = D / kParts / 2;
#pragma unroll
      for (int part = 0; part < kParts; ++part) {
        float pv[kPart];
        const int off = part * (D / kParts) * 128;
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < kKeys / 8; ++j) wgmma_tf32_rs(pv, p_s[j], v_desc(v_b + off, j), j > 0);
#pragma unroll
        for (int j = 0; j < kKeys / 8; ++j) wgmma_tf32_rs(pv, p_b[j], v_desc(v_s + off, j), 1);
#pragma unroll
        for (int j = 0; j < kKeys / 8; ++j) wgmma_tf32_rs(pv, p_b[j], v_desc(v_b + off, j), 1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(pv);
#pragma unroll
        for (int i = 0; i < kPart; ++i)
          o_acc[part * kPart + i] = fmaf(o_acc[part * kPart + i], alpha[(i >> 1) & 1], pv[i]);
      }
"""
# Q_b K_b into its own accumulator, added to the small products on the
# CUDA cores.
S_AS_BUILT = """      float s[kKeys / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) wgmma_tf32_rs(s, q_s[kk], k_desc(k_b, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) wgmma_tf32_ss(s, q_desc(kk), k_desc(k_s, kk), 1);
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) wgmma_tf32_ss(s, q_desc(kk), k_desc(k_b, kk), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
"""
S_BIG_APART = """      float s[kKeys / 2], s_big[kKeys / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) wgmma_tf32_rs(s, q_s[kk], k_desc(k_b, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) wgmma_tf32_ss(s, q_desc(kk), k_desc(k_s, kk), 1);
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) wgmma_tf32_ss(s_big, q_desc(kk), k_desc(k_b, kk), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(s_big);
#pragma unroll
      for (int i = 0; i < kKeys / 2; ++i) s[i] += s_big[i];
"""
# name -> (old, new) edits of csrc/flash_attention.cu; an edit whose old
# text is not in the source (the source already holds the new) is skipped,
# so the list names each variant's whole design.
VARIANTS = {
    "as built": [],
    "O += P V in the tensor cores' accumulator": [(PV_PER_TILE, PV_AS_BUILT)],
    "P V per tile, added on the CUDA cores": [(PV_AS_BUILT, PV_PER_TILE)],
    "and Q_b K_b apart": [(PV_AS_BUILT, PV_PER_TILE), (S_AS_BUILT, S_BIG_APART)],
}
ENTRY = "flash_attention_tf32"
CASES = (
    # name, heads, kv heads, sequence, window, q scale, timed
    ("Qwen3-8B prefill", 32, 8, 4096, None, 1.0, True),
    ("Mixtral-8x7B", 32, 8, 8192, 4096, 1.0, True),
    ("logits in the tens", 8, 2, 300, None, 10.0, False),
)
HEAD_DIM = 128


def main() -> None:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--turns", type=int, default=2, help="turns over the variants (default 2)")
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("tools/k7_variants.py: needs a CUDA card")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel as FA

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    out_dir = ROOT / "build" / "k7_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    source = (_build.CSRC / "flash_attention.cu").read_text()
    procs = {}
    for name, edits in VARIANTS.items():
        text = source
        for old, new in edits:
            if text.count(old) == 1:
                text = text.replace(old, new)
            elif text.count(new) != 1:
                sys.exit(f"variant {name!r}: an edit's old text is not in the source once")
        stem = re.sub(r"\W+", "_", name)
        (out_dir / f"{stem}.cu").write_text(text)
        lib = out_dir / f"{stem}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(lib),
               str(out_dir / f"{stem}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), lib)
    fns = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"variant {name!r} did not build:\n{log}")
        lines, current = [], ""
        for line in log.splitlines():
            found = re.search(r"Compiling entry function '(\S+)'", line)
            if found:
                current = found.group(1)
            elif f"{ENTRY}_kernelILi128" in current and ("Used" in line or "spill" in line):
                lines.append(line.replace("ptxas info    :", "").strip())
        print(f"{name} (D = 128): {'; '.join(lines)}")
        fn = getattr(ctypes.CDLL(str(lib)), ENTRY)
        fn.argtypes, fn.restype = _build.SOURCES["flash_attention"][ENTRY]
        fns[name] = fn

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    stream = torch._C._cuda_getCurrentRawStream(0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(18)
    inputs = []
    for case, h, kv, s, window, q_scale, timed in CASES:
        q = q_scale * torch.randn(1, h, s, HEAD_DIM, generator=gen, device=dev)
        k, v = (torch.randn(1, kv, s, HEAD_DIM, generator=gen, device=dev) for _ in range(2))
        exact = FA.flash_attention_fwd_plain(q.double(), k.double(), v.double(), window=window)
        plain_err = (FA.flash_attention_fwd_plain(q, k, v, window=window).double() - exact).abs().max().item()
        sp = -(-s // FA.PLANE_KEYS) * FA.PLANE_KEYS
        planes = torch.empty(2 * kv * HEAD_DIM * (s + sp), dtype=torch.float32, device=dev)
        out = torch.empty_like(q)
        win = 2**31 - 1 if window is None else window

        def call(fn, q=q, k=k, v=v, planes=planes, out=out, h=h, kv=kv, s=s, win=win):
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), planes.data_ptr(), out.data_ptr(),
                     1, h, kv, s, HEAD_DIM, 1, win, HEAD_DIM ** -0.5, stream)
            if err:
                sys.exit(f"{ENTRY} failed with CUDA error {err}")

        inputs.append((case, timed, call, out, exact, plain_err))

    def median_ms(call, calls=10, bursts=3):
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

    names = list(VARIANTS)
    for turn in range(opts.turns):
        for name in names if turn % 2 == 0 else names[::-1]:
            parts = []
            for case, timed, call, out, exact, plain_err in inputs:
                call(fns[name])
                torch.cuda.synchronize()
                err = (out.double() - exact).abs().max().item()
                text = f"{case}: |kernel - float64| {err:.4g} ({err / plain_err:.2f}x the plain f32's {plain_err:.4g})"
                if timed:
                    text += f", {median_ms(lambda: call(fns[name])):.4f} ms"
                parts.append(text)
            print(f"turn {turn + 1} {name}: " + "; ".join(parts), flush=True)


if __name__ == "__main__":
    main()
