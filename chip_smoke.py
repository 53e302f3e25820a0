#!/usr/bin/env python3
"""Run the port's main paths once on one CUDA card and check them end to end.

    python3 chip_smoke.py

Phases (any mismatch exits non-zero; nothing is caught):

1. Print the card (``nvidia-smi`` name and power limit) and its integer
   rates (SM count and maximum SM clock), build the CUDA kernels from
   ``src/repro_torch/csrc`` (one ``nvcc`` per source, all started
   together), print the build time and each kernel's registers and spills,
   and check with ``cuobjdump -sass`` that the tensor-core kernels hold
   ``HGMMA`` (bf16), ``IGMMA`` (int8) and, in K6 and K7's f32 kernel, TF32
   ``HGMMA`` instructions; print the ``POPC``, ``SHFL``, 128-bit ``LDG``
   and ``REDUX`` counts of K1, K2, K3 and K5, and the ``POPC``, ``VOTE`` and
   ``REDUX`` counts of the lane counters L1 and L2 (none may hold a
   shuffle, and K3 and K5 must hold 16-byte loads); K1, K2, K3, K5, L1, L2
   and K7's f32 kernel may not spill.
2. Hold each kernel against its plain PyTorch version on the card, element
   for element: K1 and K4 (K4's wrapper launches K5's kernel) on the
   reference test matrices and on every ResNet50 Table-I layer (and the
   numpy oracle on the small cases), K1 also on its edge cases at the int16
   extremes; K2 and K3 on the stacked buckets the port's scheduler builds
   for the reference's ragged WS and OS job sets, and on the Table-I WS
   bucket (3776 tasks over 720 strips) and OS stream bucket (496 strips),
   K2 also on its edge buckets (every run layout, valid_r of 0, partial and
   full, bad ids, operands at the int16 extremes), K3 also at the edges of
   its column walk (lanes 1, 3, 5 and 7, t1 = 2, one strip, misaligned
   bases); K5, K6
   and K7 at the shapes of the reference's ``tests/test_kernels.py``
   (integers exact, f32 attention within 1e-5), K5 also on misaligned
   bases, T = 2 and 3, 600,000 lanes and an int32 stream on every bus of
   33-64 bits, each K6 and K7 case through
   ``ws_gemm`` and ``flash_attention_fwd`` on the route its type and shape
   pick, whose counter must move. K6 runs every type on the tensor cores
   (kernel ``ws_gemm_tc``, with its prep kernel ``gemm_operand_planes``,
   held against its plain version bit for bit): int8, int16 and bf16 with
   K and N multiples of 8 on the "tc" route, f32 (three TF32 products) and
   the other bf16 on the "tf32" route, also at ragged shapes, on offset
   views, near f32's largest value and with inf and NaN entries. K7 runs
   both types on the tensor cores: bf16 (``flash_attention_tc``) and f32
   as three TF32 products (``flash_attention_tf32``, after its prep kernel
   ``attention_operand_planes``, held against its plain version bit for
   bit), f32 also on offset views.
3. The two main paths, on the paper's 32x32 array with int16 operands, WS
   and OS, each with every kernel count set to 0 just before it and read
   just after:
   * per GEMM: ``profile_conv_layer(backend="auto")`` per layer (K1, K4);
   * batched: ``profile_network(RESNET50_TABLE1, backend="auto",
     return_stats=True)`` (K2, K3).
   Each path's profiles must equal the JAX package's, committed in
   ``src/repro_torch/data/table1_reference.json``, and ``combine_profiles``
   -> ``optimal_aspect_power`` -> ``compare_sym_asym`` per layer ->
   ``average_comparison`` must match the file to 1e-12 relative.  The
   batched path's scheduler statistics must equal the reference's, with no
   serial fallback, degraded or skipped job and an empty failure report.
   Every kernel of a path must have been launched in its run.
   Then the kernel library's path, with the same count discipline, through
   its entry points (``stream_toggle_count``, ``stream_toggle_count_i64``,
   ``stream_activity``, ``ws_matmul``, ``flash_attention``):
   * K5 recounts all 24 Table-I toggle counts of the file (WS and OS,
     horizontal and vertical, per layer) from the operand streams and, for
     WS vertical, from each layer's (M, K*N) 37-bit partial-sum stream
     built on the card; each must equal the file's exactly, and each
     stream's activity the file's profile's.
   * K6 runs the six Table-I GEMMs at int16 and at int8, bit-exact against
     its plain version (wrapped mod 2^32), and the int16 product must equal
     the wrapped sum of each tile's bottom partial sums; and one bf16
     product at Qwen3-8B's MLP width (4096 tokens x 4096 x 12288), within
     1e-5 * (|a| @ |w|) elementwise.  Every one must take the tensor cores
     ("tc" route).
   * K7 runs Qwen3-8B prefill (H=32, KV=8, D=128, S=4096, causal) and
     Mixtral-8x7B (S=8192, window 4096) in bf16, within rtol 1.6e-2 and
     atol 1e-3 of its plain version (f32 math, query chunks of 1024 rows),
     on the tensor cores.
   Then the design-space path (phase 3c), with the same count discipline:
   * lane-resolved profiles (``profile_gemm(..., lane_detail=True,
     backend="cuda")``, cache cleared) of the six layers, WS b_v=37 and OS,
     each with the counts set to 0 just before it: L2 and L1 once each
     (WS) or L2 twice (OS), and no other kernel; the lane sums must equal
     the file's counts and K1's (WS) or K4's (OS) counts on the same
     operands, each layer's first k tile must give the CPU lane pass's
     lanes, and L1 and L2 must equal their plain versions bit for bit on
     each layer's operands and on their edge cases (``LANE_EDGE_CASES``,
     ``STREAM_LANE_EDGE_CASES``; L1's lane sums also K1's v counts); each
     profile's wall time, launches and peak device memory are printed
     beside what the PyTorch lane passes cost;
   * the path itself, each step timed: ``measured_design_activities`` (K2,
     K3) over the example grid (rows 16/32, cols 8-128, b16, WS and OS,
     bus-invert off and on: 40 points) and the first three layers, whose
     activities and scheduler statistics must equal the file's (the JAX
     package's) and whose activities must lie within 1e-12 of the numpy
     oracle's; ``measured_design_lane_activities`` of all six layers on a
     BI-free grid (rows 16/32, cols 32/64, b16, WS and OS);
     ``evaluate_design_space`` and its Pareto set, and
     ``evaluate_layout_design_space`` over six layout families with the
     measured lanes, each with ``engine="cuda"`` held to ``engine="numpy"``
     within 1e-10 (the golden-section argmin within 1e-7, the power at it
     within 1e-10); and the paper's savings through the segment engine
     (W/H* = 3.78, 9.1% +/- 0.5 and 2.1% +/- 0.5 saved).
   Then the serving path (phase 3d, ``serving_path_check``), with the same
   count discipline: K2 and K3 against their plain versions on the buckets
   the scheduler builds for the path's own jobs (48 jobs: 16 clipped
   operand classes x 3 activity classes), then
   ``codesign("mixtral_8x7b", "decode_heavy")`` at Mixtral-8x7B's full
   published widths (72 GEMM shape classes, the 40-point ``DEFAULT_SPACE``
   x 4 ``DEFAULT_FAMILIES``, profiling clip (128, 512, 256)): K2 and K3 on
   the card, the objective in float64 on the card.  The job set, the
   measured activities (bit for bit) and the scheduler's statistics must
   equal ``src/repro_torch/data/serving_reference.json`` (the JAX
   package's), ``j_per_mac``, ``j_per_mac_robust`` and
   ``j_per_token_robust`` lie within 1e-10 of its float64 values, and the
   best, decode and prefill cells equal its.  The same objective through
   the checkpointed sweep (chunks of 8 points): a healthy run is all on
   the "cuda" rung; resumed and interrupted-then-resumed runs equal the
   uninterrupted one bit for bit; chunked equals unchunked bit for bit (a
   field that does not is named and held within 1e-12); a chunk poisoned
   through ``runtime.faults`` is recorded on the "numpy" rung and agrees
   with the plain result within 1e-10.  Prints the path's wall by step,
   traces of the activities and the objective (device busy, K2 and K3
   device time) and the objective's warm (point x layout) cells/s beside
   ``engine="numpy"``.
4. Time each kernel at the main paths' shapes with CUDA events (warm-up,
   then the median of repeated calls) beside its plain version, its bound
   and, where one PyTorch call computes the same function, that call.  The
   toggle counters' bound is the largest of their bytes, their 32-bit
   integer ops and their popcounts at this card's rates, and names the
   binding term; K5 is summed apart over its 12 partial-sum streams and its
   36 operand streams.  K3, K4 and K6's prep kernel, whose calls cost the
   host more than the card, are also timed by their device time, read from
   ``torch.profiler`` over a burst of calls with the L2 flushed before
   each.  K6 is timed in f32 on the "tf32" route at the Qwen3-8B MLP
   (seeded f32 operands, held to 1e-5 * (|a| @ |w|) there) beside
   ``torch.matmul`` in full f32, with the bound of three TF32 products and
   that of the f32 CUDA-core rate; K7 in f32 on its "tf32" route at both
   attention cases (seeded f32 inputs, held there to 1e-5 of its plain
   version and to the reference's 2e-5 of a float64 rendering), each beside
   SDPA in f32, with the same two bounds, and its prep kernel also by
   device time.  Time L1 and L2 at the six layers' lane-profile shapes
   (CUDA events, and device time with the L2 flushed) beside their plain
   versions, with the bound (bytes, or integer ops: a multiply-add a
   partial sum, an XOR and a full adder a transition word) and its binding
   term.  Time the lane profiles whole and the design-space path's
   PyTorch programs (``_evaluate_core``, ``_sweep_core``,
   ``_coeff_eval_core``): a call, its kernel launches, device time and
   peak memory, beside the numpy engine; and the layout evaluator's warm throughput in (point x
   layout) cells/s on the fleet grid of ``benchmarks/bench_layout.py``
   (1152 points x 8 families).
5. Trace each main path once more with ``torch.profiler`` and print the
   device's busy share and the device time of each kernel and copy; the
   design-space path too.
6. The model path (``model_path_check``), last, with the same count
   discipline: the ten reduced architectures in float32, parameters
   from the port's seeded numpy recipe, ``forward`` (K7 f32 where they
   attend) and stepwise ``decode_step`` at B = 2, S = 12 and ``forward`` at
   B = 1, S = 128, each within rtol = atol = 2e-3 of the JAX package's
   logits in ``src/repro_torch/data/models_reference.json``, and the K7
   route within 1e-4 of the torch route; then Qwen3-8B at its full
   published widths in bf16 (16.4 GB of weights drawn on the card):
   ``forward(last_only=True)`` at B = 4, S = 2048 on the K7 route (36 K7
   launches; of three ``torch.profiler`` traces of it, the one holding
   the most device records holds 36 K7 records) against the torch route
   within 3e-2 relative L2, then ``launch.serve.generate`` at
   B = 4, prompt 64, gen 16, whose ``prefill_with_cache`` logits lie
   within 3e-2 relative L2 of the forward's last position and whose tokens
   the prefill and decode steps give back; prints the forward, prefill and
   decode walls, tokens/s, the device's busy share in traces of the
   forward and the decode steps, peak device memory, and K7's time at the
   full-width shape beside SDPA ``is_causal`` and its bound.  The reduced
   Jamba's Mamba layers take L3 (f32), once a layer in each forward.
6b. L3 and the Mamba path (``mamba_path_check``), after phase 6's weights
   are freed, with the same count discipline: L3 at the Jamba cell's scan
   shape (B = 1, S = 7680, d_inner 8192, N 16, bf16, long-memory draws),
   one launch, within 2^-9 + 2e-5 relative L2 of its plain version, timed
   beside it with the benchmark's bound (``portbench/ssm_counts.py``);
   then one period of Jamba2-Mini (8 of 32 layers, all 16 experts, inner
   norms, no RoPE; 26.6 GB of weights drawn on the card) in bf16 through
   ``forward(last_only=True)`` at B = 1, S = 7680: 7 L3 launches, 1 K7
   bf16 launch and no other kernel, finite logits, its wall beside the
   same forward on the chunked scan.
6c. L4 (``norm_path_check``): the row norm at the long prompt's hidden
   rows (7680, 4096) bf16 and the q/k pass at Qwen3-8B's q and k of a
   7680-token prompt (read in place from the einsum's permuted views, with
   their per-head norms), each one launch, against its plain version (the
   norm at most one bf16 ulp apart, both within 1e-3 relative L2), timed
   beside it, beside the torch route's float32 chains, beside
   ``torch.nn.functional.rms_norm`` and beside the byte bound.  Phases 6,
   6b and 6c count L4 as a kernel of their paths; phase 6 runs its Qwen3-8B
   forward once more with the norms and RoPE on their torch route, which
   the mesh and training take, and phase 8 and phase 7's independent
   cross-entropy use that route.
7. The training path (``training_path_check``), after phase 6b's weights
   are freed, with the same count discipline: every count must read 0 (the
   loss takes the torch attention route; K7 has no backward).  The ten
   reduced architectures in float32 from the same seeded parameters, on
   the token streams recorded in ``src/repro_torch/data/train_reference.json``:
   three ``make_train_step`` AdamW steps at B = 2, S = 32 and one at
   S = 128, each step's ``loss``, ``ce``, ``aux``, ``grad_norm`` and ``lr``
   and each gradient leaf's norm at the first step within 2e-3 (relative)
   of the JAX package's; whether ``batch_at_step`` on this machine draws
   those streams is printed.  Crash and restart through
   ``launch.train.build`` (yi_6b reduced, 8 steps, a crash after step 5)
   must end in the straight run's state bit for bit, under
   ``torch.use_deterministic_algorithms`` (``CUBLAS_WORKSPACE_CONFIG`` is
   set before CUDA starts); Qwen3-8B reduced's loss must fall over 12
   steps.  Then Qwen3-8B at its published widths, 2 of 36 layers, in f32
   with remat "stage", B = 2, S = 2048: 4 steps with finite metrics and a
   positive gradient norm, step 1's ``ce`` within 1e-4 of
   ``F.cross_entropy`` on the forward's logits, the chunked
   cross-entropy (``loss_chunk`` 512) within 1e-5 of its loss and 1e-4 of
   its gradient norm; prints the step walls, tokens/s, peak memory, the
   6·N·D FLOP share of the f32 peak, and a traced step's busy share and
   top device operations.
8. The mesh path (``mesh_path_check``), after phase 7's state is freed,
   with the same count discipline: a one-rank NCCL process group
   (rendezvous through a ``FileStore`` in a temporary directory) and a
   1 x 1 ("data", "model") ``DeviceMesh`` on the card.  Qwen3-8B at its
   published widths in bf16, phase 6's weights (seed 0) placed by
   ``parallel.sharding.tree_shardings`` / ``place``, runs
   ``forward(last_only=True)`` at B = 4, S = 2048 under
   ``activation_sharding`` on phase 6's tokens: its logits must equal phase
   6's unsharded forward bit for bit, with K7 launched through
   ``local_map`` once a layer (36 records in the fullest of three
   ``torch.profiler`` traces).  Mixtral-8x7B at its published widths with 2
   of 32 layers in bf16, B = 2, S = 2048: on the mesh the MoE takes its
   sharded dispatch (``local_map`` dispatch and combine, the
   expert-parallel redistribution between them), whose logits must equal
   the single-device branch's bit for bit under
   ``torch.use_deterministic_algorithms``, and lie within MODEL_BF16_REL
   (relative L2) of the single-device torch attention route (K7 against
   its plain version at Mixtral's shape).  38 K7 launches and no other
   kernel.  Then ``python -m repro_torch.launch.dryrun`` in subprocesses
   on this machine's torch, Qwen3-8B ``decode_32k`` on the 16x16 mesh,
   Mixtral-8x7B ``decode_32k`` on the 2x16x16 mesh (512 fake ranks) and
   Mixtral-8x7B ``train_4k`` on the 16x16 mesh: each "ok", rank 0's
   placed argument bytes equal to the JAX package's shard bytes for the
   cell (``DRYRUN_CELLS``), its collectives counted, the MoE cells with an
   all-to-all; prints each record's H100 roofline terms.  (e) Beside them,
   ``python -m repro_torch.launch.dryrun --reduced-matrix``: the ten
   reduced archs' train, prefill and decode steps on an 8-rank (4, 2)
   fake mesh, each of which must trace on this machine's torch; each
   status is printed.  Last, phase 7's Qwen3-8B step (2 layers,
   f32, B = 2, S = 2048) through the same counters on a one-rank fake mesh,
   with the roofline at the f32 CUDA-core rate: its counted FLOPs beside
   6·N·D, its bound beside phase 7's measured step and its peak estimate
   (arguments + temp) beside phase 7's measured peak (printed, not gated).

The last lines are the ``kernels`` JSON object (every kernel; K6's
"tf32" route with no launch on a main path; K7's f32 route and its prep
kernel with their launches on the model path, their first; K2's and K3's
launches on the design-space and serving paths and K7's on the model path
beside their first main path's; K7 bf16's time at the model's shape;
every kernel's launches on the training path, 0, and on the mesh path,
K7 bf16's 38 and every other 0; L1 and L2 with their launches on the
design-space path, their first, and the XLA program each computes as
their "reference"; L3 with its launches on phase 6b's Jamba-width forward,
its first, its reduced launches on the model path, its time at the
Jamba cell's scan shape, and its "reference"; L4's two entry points with
their launches on the model path, their times at phase 6c's shapes, the
torch route's, and their "reference"), the ``nvidia-smi`` line and
``{"ok": true, "device": {...}}``.  Exits non-zero without a result when no
CUDA device is available or when the repository's ``src/`` is missing.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
REL_TOL = 1e-12
# Peak rates of one H100 SXM (NVIDIA's data sheet, dense, at the 700 W
# limit): HBM bytes/s; the float32 CUDA-core rate (K6 and K7 f32 as the
# CUDA cores would bound them); and the tensor-core rates for bf16, TF32
# (K6 and K7 f32: three TF32 products) and int8.
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
PEAK_INT8_OPS = 1979e12
# Results per clock on each SM of compute capability 9.0 (NVIDIA's CUDA C++
# table of arithmetic-instruction throughput): 32-bit
# integer add, logic op or multiply-add; popcount. The toggle counters
# (K1-K5) are bound by the larger of their bytes, their integer ops and
# their popcounts, at the SM count and maximum SM clock this card reports.
INT_OPS_PER_CLOCK_SM = 64
POPC_PER_CLOCK_SM = 16
# Device-side events the profiler records for itself.
PROFILER_OWN_EVENTS = ("Activity Buffer Request",)
KERNELS = (
    "ws_activity_toggles", "ws_task_toggles", "strip_toggles", "operand_stream_toggles",
    "stream_toggles", "ws_gemm_tf32", "flash_attention_tf32", "attention_operand_planes",
    "ws_gemm_tc", "gemm_operand_planes", "flash_attention_tc", "ws_lane_toggles",
    "stream_lane_toggles", "selective_scan_fwd", "rms_norm_fwd", "qk_rope_fwd",
)
# The f32 routes (K6 also bf16 with K or N not a multiple of 8) and K7's
# prep: timed at the main paths' shapes, launched on none of the profiling
# and kernel-library paths (K7's on the model path, phase 6).
OFF_PATH = ("ws_gemm_tf32", "flash_attention_tf32", "attention_operand_planes")
# The tensor-core kernels and the SASS instructions each must hold (TF32:
# HGMMA lines over tf32 operands, K6's and K7's "tf32" routes).
TC_SASS = {"ws_gemm_tc_kernel": ("HGMMA", "IGMMA", "TF32"),
           "flash_attention_tc_kernel": ("HGMMA",),
           "flash_attention_tf32_kernel": ("HGMMA", "TF32")}
# The redesigned toggle counters and the lane counters (source, kernel):
# their SASS is counted for popcounts, shuffles (none: registers blocked in
# time, REDUX sums), votes and 16-byte global loads (K5's lane groups, which
# K3 walks too), and ptxas must report no spill.
INT_SASS = (("activity_profile", "ws_activity_toggles_kernel"),
            ("activity_batch", "ws_task_toggles_kernel"),
            ("toggle_count", "stream_toggles_kernel"),
            ("toggle_count", "strip_toggles_kernel"),
            ("lane_toggles", "ws_lane_toggles_kernel"),
            ("lane_toggles", "stream_lane_toggles_kernel"))
WIDE_LOADS = ("stream_toggles_kernel", "strip_toggles_kernel")
# Kernels ptxas must report with no spill: the toggle counters and K7's f32
# kernel (Q's small plane, P's two planes and both accumulators live in
# registers).
NO_SPILL = INT_SASS + (("flash_attention", "flash_attention_tf32_kernel"),
                       ("rms_norm", "rms_norm_rows_kernel"))
SASS_OPS = {"POPC": r"\bPOPC\b", "SHFL": r"\bSHFL\.", "LDG.E.128": r"\bLDG\.E(?:\.\w+)*\.128\b",
            "REDUX": r"\bREDUX\b", "VOTE": r"\bVOTE\b"}
# Tolerances of the float kernels against their plain versions (f32 math
# in both; only the order of the sums differs): K6 within GEMM_REL_TOL *
# (|a| @ |w|) elementwise, since f32 rounding grows with the magnitudes
# summed; K7 in f32 within F32_TOL (rtol and atol), in bf16 within about
# two bf16 ulps of the output (2^-7 relative each), BF16_RTOL and BF16_ATOL.
GEMM_REL_TOL = 1e-5
F32_MAX = 3.4028234663852886e38  # the largest finite float32
L2_FLUSH_BYTES = 128 << 20  # more than the H100's 50 MB L2
F32_TOL = 1e-5
# K7 f32 at the model shapes against a float64 rendering: the reference's
# own f32 tolerance (rtol and atol, tests/test_kernels.py).
F32_REF_TOL = 2e-5
BF16_RTOL = 1.6e-2
BF16_ATOL = 1e-3
# Model widths (src/repro/configs/qwen3_8b.py, mixtral_8x7b.py): both have
# 32 query heads, 8 KV heads and head_dim 128; Qwen3-8B's MLP is
# d_model 4096 -> d_ff 12288; Mixtral-8x7B attends over a 4096-key window.
HEADS, KV_HEADS, HEAD_DIM = 32, 8, 128
QWEN3_D_MODEL, QWEN3_D_FF = 4096, 12288
ATTENTION_CASES = (
    # name, sequence, window
    ("Qwen3-8B prefill", 4096, None),
    ("Mixtral-8x7B", 8192, 4096),
)
MLP_TOKENS = 4096
WS_BUS_BITS = 37  # the WS partial-sum bus of the 32x32 array at int16
OPERAND_BUS = 16  # its operand bus
BATCH_STATS_FIELDS = (
    "jobs", "passes", "pass_reuse", "buckets", "tasks", "strips", "serial_fallbacks",
)
# The design-space path (phase 3c): the layout families of its lane-resolved
# evaluation and of bench_layout's fleet grid; the paper's measured
# activities (Section IV), whose segment-level verdict is W/H* = 3.78 and
# 9.1% / 2.1% saved; the fields each evaluator is held to on the card.
LANE_FAMILIES = ("uniform", "serpentine2", "serpentine4", "pods1x1", "pods2x2", "pods4x4")
FLEET_FAMILIES = ("uniform", "serpentine2", "serpentine4", "pods1x1", "pods2x2", "pods3x3",
                  "pods4x4", "pods8x8")
DS_EVAL_FIELDS = (
    "a_v_eff", "aspect_opt", "aspect_opt_gss", "bus_power_opt", "bus_power_sym", "aspect_robust",
    "max_regret", "bus_power_robust", "bus_power_square", "interconnect_saving", "total_saving",
    "area_um2", "bus_energy_per_mac_j", "neg_macs_per_cycle",
)
LAYOUT_EVAL_FIELDS = ("aspect_opt", "bus_power_opt", "aspect_robust", "bus_power_robust",
                      "overhead_w", "wirelength_um")
# engine="cuda" against engine="numpy": float64 on both, only the last bits
# of exp, log and sqrt and the order of sums differ.  The golden-section
# argmin of a smooth minimum is set only to about sqrt(eps): it is held
# within GSS_ARGMIN_RTOL, and the power shape at it within ENGINE_RTOL.
ENGINE_RTOL = 1e-10
GSS_ARGMIN_RTOL = 1e-7

# The reference test matrices: tests/test_activity_profile.py CASES / OS_CASES.
CASES = [
    (7, 5, 3, 32, 32, 16, 37),
    (64, 64, 48, 32, 32, 16, 37),
    (100, 37, 29, 16, 8, 8, 20),
    (33, 70, 10, 32, 32, 16, 64),
    (2, 1, 1, 8, 8, 16, 37),
    (17, 16, 16, 16, 16, 32, 32),
    (257, 40, 33, 16, 16, 37, 33),
    (1025, 96, 64, 32, 32, 16, 37),
]
OS_CASES = [
    (7, 5, 3, 32, 32, 16, 16),
    (64, 64, 48, 32, 32, 16, 16),
    (100, 37, 29, 16, 8, 8, 8),
    (33, 70, 10, 32, 32, 16, 64),
    (1, 2, 1, 8, 8, 16, 37),
    (17, 16, 16, 16, 16, 32, 32),
    (257, 40, 33, 16, 16, 37, 33),
    (12, 1025, 16, 8, 8, 16, 12),
]
# K1 at its edges (tests/test_torch_cuda.py K1_EDGE_CASES): M around one
# run of 15 transitions, K below rows and past one staged chunk, N off the
# 32-column groups, b_v on every high-word packing; operands at the int16
# extremes.
K1_EDGE_CASES = [
    (2, 40, 33, 32, 32, 16, 37),
    (14, 40, 33, 32, 32, 16, 37),
    (15, 40, 33, 32, 32, 16, 37),
    (16, 40, 33, 32, 32, 16, 37),
    (1025, 40, 33, 32, 32, 16, 37),
    (40, 20, 65, 32, 32, 16, 37),
    (40, 70, 100, 32, 16, 16, 37),
    (40, 100, 29, 48, 8, 16, 37),
    (40, 64, 64, 32, 32, 16, 20),
    (40, 64, 64, 32, 32, 16, 32),
    (40, 64, 64, 32, 32, 33, 33),
    (40, 64, 64, 32, 32, 16, 40),
    (40, 64, 64, 32, 32, 16, 45),
    (40, 64, 64, 32, 32, 64, 64),
]
# K5 at its edges: (shape, element offset into the allocation); an offset
# misaligns the base (lanes 1, 3, 5, 4097 walk one lane a thread, 4096 takes
# the scalar head, the 16-byte groups and the tail), T = 2 and 3, and lanes
# beyond the earlier design's grid stride.
# K2 at its edges (some of tests/test_torch_cuda.py's K2 cases): runs of 16
# (t_seg 16, 128) and of 8 (t_seg 8, 24), partial last runs (t_seg 1, 5,
# 37), rows past one staged chunk, cols off the 32-column groups, b_v on
# every high-word packing.
K2_EDGE_CASES = [
    # t_seg, rows, cols, b_v
    (8, 32, 32, 37), (16, 32, 32, 37), (24, 32, 32, 37), (128, 32, 32, 37),
    (1, 16, 8, 37), (5, 16, 40, 37), (37, 48, 64, 37), (64, 16, 40, 20),
    (64, 32, 32, 32), (64, 32, 32, 33), (64, 32, 32, 40), (64, 32, 32, 48),
    (64, 32, 32, 64),
]
# L1 and L2 at their edges (tests/test_torch_cuda.py L1_CASES, L2_CASES): L1 (M, K, N,
# rows, b_v) with b_v on each of 1, 16, 32, 33, 37 and 64, M = 2 and 3 and
# around one run of 15 transitions, K off rows and past one staged chunk of
# 32 rows, N = 1, N off the 32-column groups and past one block's 128
# columns; L2 (T, L) with T = 2 and 3, one lane, lanes past one block of
# 256 threads, T past many 15-step chunks with a short last group, and a
# stream of 10 M values, whose chunks are 30 steps, each on buses of 8, 16
# and 33 bits (the sign lane); operands at the int16 extremes.
LANE_EDGE_CASES = [
    (40, 70, 33, 32, 1), (40, 70, 33, 32, 16), (40, 70, 33, 32, 32), (40, 70, 33, 32, 33),
    (40, 70, 33, 32, 37), (40, 70, 33, 32, 64), (2, 40, 65, 32, 37), (3, 40, 65, 32, 37),
    (16, 45, 1, 32, 37), (17, 100, 130, 48, 37), (46, 20, 300, 16, 33),
]
STREAM_LANE_EDGE_CASES = [(2, 1), (3, 7), (37, 300), (482, 33), (1000, 257), (2000, 5000)]
# What the PyTorch lane passes that L1 and L2 replace cost on the six
# Table-I layers (PERF.md, the card's earlier runs): the v pass 316.6-327.5
# ms and 22350 launches a call; the design-space path's lane activities
# 1453.9 ms of a 2034.9 ms wall, 16.9% busy.
PLAIN_LANE_PASSES = ("v pass 316.6-327.5 ms and 22350 launches for the six layers; lane "
                     "activities 1453.9 ms of the design-space path's 2034.9, 16.9% busy")
K5_EDGE_CASES = [
    ((37, 1), 1), ((37, 3), 1), ((37, 5), 1), ((37, 4096), 1), ((37, 4097), 1),
    ((2, 1000), 0), ((3, 4096), 0), ((3, 7), 0), ((4, 600_000), 0),
]
# K3 at the edges of K5's column walk (tests/test_torch_cuda.py K3_EDGES):
# (strips, t1, lanes), each at element offset 0 and 1 (a misaligned base
# starts 16-byte rows with scalar head lanes): lanes 1, 3, 5 and 7 (scalar),
# 4, 8 and 32 (16-byte groups), t1 = 2, one strip and many, strips of
# several time chunks.
K3_EDGE_CASES = [(1, 2, 1), (1, 2, 3), (3, 2, 5), (1, 9, 3), (4, 17, 5), (2, 40, 4),
                 (7, 129, 8), (1, 300, 5), (720, 129, 32), (33, 1000, 7)]

# The reference's ragged batches: tests/test_profile_pipeline.py RAGGED /
# OS_RAGGED.
RAGGED = [
    (7, 5, 3, 16, 8, 16, 37),
    (33, 70, 10, 16, 8, 16, 37),
    (100, 37, 29, 16, 8, 8, 20),
    (64, 64, 48, 32, 32, 16, 37),
    (257, 40, 33, 16, 16, 37, 33),
    (300, 80, 70, 32, 32, 16, 64),
    (50, 24, 16, 8, 8, 8, 23),
]
OS_RAGGED = [
    (7, 5, 3, 16, 8, 16, 16),
    (33, 70, 10, 16, 8, 16, 12),
    (100, 37, 29, 16, 8, 8, 8),
    (257, 40, 33, 16, 16, 37, 33),
    (12, 300, 16, 8, 8, 16, 16),
]
# The reference's kernel-library cases: tests/test_kernels.py.
TOGGLE_SHAPES = [(2, 1), (17, 3), (100, 64), (257, 129), (512, 256), (1000, 7)]
GEMM_SHAPES = [(128, 128, 128), (1, 1, 1), (200, 300, 170), (127, 129, 255), (384, 256, 512)]
FLOAT_GEMM_SHAPES = [(130, 260, 140), (64, 512, 64)]
# bf16 shapes of the tensor-core route (K and N multiples of 8, ragged M).
TC_GEMM_SHAPES = [(130, 264, 136), (256, 512, 384)]
# Ragged shapes of the "tf32" route (f32, and bf16 with K or N not a
# multiple of 8): K in {1, 7, 33}, N in {1, 129}, M in {1, 130}, and one of
# several K slices and N tiles.
TF32_GEMM_SHAPES = [(1, 1, 1), (130, 7, 129), (130, 33, 1), (1, 33, 129), (130, 1, 129),
                    (1, 7, 1), (300, 4100, 520)]
ATTENTION_SMALL = [
    # b, h, kv, s, d, causal, window
    (1, 1, 1, 128, 64, True, None),
    (2, 4, 2, 200, 64, True, None),
    (1, 8, 1, 256, 128, True, None),
    (1, 2, 2, 256, 64, True, 16),
    (1, 2, 2, 300, 32, True, 128),
    (1, 2, 1, 512, 32, False, None),
    (1, 4, 2, 256, 128, False, 64),
]
# bf16 cases of the tensor-core attention: D 32/64/128, S 200 and 1000, GQA,
# windows 70 and 0, and non-causal S=256.
ATTENTION_BF16 = [
    # b, h, kv, s, d, causal, window
    (1, 8, 2, 1000, 128, True, None),
    (1, 8, 2, 1000, 64, True, 300),
    (1, 8, 2, 1000, 32, True, None),
    (2, 4, 2, 200, 64, True, 70),
    (1, 4, 1, 200, 128, True, 0),
    (1, 4, 2, 256, 32, False, None),
    (1, 4, 2, 256, 128, False, 64),
]


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def rel_close(got: float, want: float) -> bool:
    return abs(got - want) <= REL_TOL * max(abs(want), 1e-300)


def rel_l2(a, b) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def launch_counters() -> dict:
    """Each kernel's launch count: {name: (the wrapper that holds it, its
    attribute)}.  K6's and K7's routes count on the public wrapper;
    ``launches`` there is the sum of both GEMM (or attention) routes."""
    from repro_torch.kernels.activity_profile import kernel as K
    from repro_torch.kernels.flash_attention import kernel as FA
    from repro_torch.kernels.rms_norm import kernel as L4
    from repro_torch.kernels.selective_scan import kernel as SS
    from repro_torch.kernels.toggle_count import kernel as TC
    from repro_torch.kernels.ws_matmul import kernel as WM

    counters = {name: (getattr(K, name), "launches") for name in KERNELS[:4]}
    counters.update(
        stream_toggles=(TC.stream_toggles, "launches"),
        ws_gemm_tf32=(WM.ws_gemm, "tf32_launches"),
        ws_gemm_tc=(WM.ws_gemm, "tc_launches"),
        gemm_operand_planes=(WM.ws_gemm, "prep_launches"),
        flash_attention_tf32=(FA.flash_attention_fwd, "tf32_launches"),
        attention_operand_planes=(FA.flash_attention_fwd, "prep_launches"),
        flash_attention_tc=(FA.flash_attention_fwd, "tc_launches"),
        ws_lane_toggles=(K.ws_lane_toggles, "launches"),
        stream_lane_toggles=(K.stream_lane_toggles, "launches"),
        selective_scan_fwd=(SS.selective_scan_fwd, "launches"),
        rms_norm_fwd=(L4.rms_norm_fwd, "launches"),
        qk_rope_fwd=(L4.qk_rope_fwd, "launches"),
    )
    return counters


def reset_counts() -> None:
    for fn, attr in launch_counters().values():
        setattr(fn, attr, 0)
        fn.launches = 0


def read_counts() -> dict:
    return {name: getattr(fn, attr) for name, (fn, attr) in launch_counters().items()}


@contextlib.contextmanager
def torch_norms():
    """The models' norms and RoPE on their torch route (the float32
    chains), as the mesh and training paths take them: L4 sums its squares
    in another order, so a forward to be held bit for bit to one of those
    paths runs on this route."""
    from repro_torch.models import layers

    real = layers.norm_route
    layers.norm_route = lambda *tensors, rotate=False: "torch"
    try:
        yield
    finally:
        layers.norm_route = real


def host_timed(fn):
    """(fn's result, ms): the host clock around one call that ends in a
    synchronize."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = fn()
    torch.cuda.synchronize()
    return result, (time.perf_counter() - t0) * 1e3


def median_ms(fn, calls: int, bursts: int = 5) -> float:
    """Median over bursts of the mean per-call time of ``calls``
    back-to-back calls, after one warm-up burst.  Where a call's host
    work outlasts its kernel, the host's launch rate sets the time."""
    import torch

    times = []
    for burst in range(bursts + 1):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        if burst:
            times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def bound_ms(n_bytes: int, n_ops: int, ops_per_s: float = PEAK_OPS_PER_S) -> tuple[float, str]:
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# The serving path (phase 3d): the reference's README example at
# Mixtral-8x7B's full published widths; the sweep's chunk size; the fields
# of the objective held to the reference file and to each other.
SERVING_CHUNK = 8
SERVING_FIELDS = ("feasible", "aspect_lo", "aspect_hi", "aspect_opt", "bus_power_opt",
                  "aspect_robust", "bus_power_robust", "overhead_w", "wirelength_um",
                  "utilization", "j_per_mac", "j_per_mac_robust")


def serving_path_check(*, smi, stacked, check_k2, check_k3) -> dict:
    """Phase 3d: ``codesign("mixtral_8x7b", "decode_heavy")`` on the card
    against ``src/repro_torch/data/serving_reference.json`` (the JAX
    package's), K2 and K3 against their plain versions on the path's own
    strips, and the same objective through the checkpointed sweep.  Returns
    the path's kernel launches and wall time."""
    import tempfile

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.registry import get_arch
    from repro_torch.core import workloads as wl
    from repro_torch.core.objective import evaluate_fleet_objective
    from repro_torch.core.sweep import SweepConfig, SweepInterrupted
    from repro_torch.core.switching import clear_profile_cache
    from repro_torch.runtime import faults
    from repro_torch.serving import (
        DEFAULT_FAMILIES,
        DEFAULT_SPACE,
        codesign,
        get_preset,
        weighted_gemms,
    )

    ref = json.loads((ROOT / "src" / "repro_torch" / "data" / "serving_reference.json").read_text())
    arch, traffic, clip = ref["arch"], ref["traffic"], tuple(ref["clip"])
    grid = DEFAULT_SPACE.expand()

    # 1. K2 and K3 against their plain versions on the buckets the scheduler
    # builds for this path's jobs (outside the counted run).
    js = weighted_gemms(get_arch(arch), get_preset(traffic))
    jobs, _, n_unique, _ = wl._gemm_activity_jobs(grid, js.gemms, js.densities, None, clip, None)
    ws_buckets, os_buckets = stacked(jobs)
    for b, arrays in ws_buckets:
        what = f"serving bucket {b.rows}x{b.cols} b_h={b.b_h} b_v={b.b_v} t_seg={b.t_seg}"
        check_k2(arrays, b.b_v, what)
        check_k3(arrays[0], b.b_h, what)
    for b, strips_t in os_buckets:
        check_k3(strips_t, b.bits, f"serving OS stream bucket bits={b.bits} t_seg={b.t_seg}")
    print(f"  serving buckets: {len(jobs)} jobs ({n_unique} operand classes x "
          f"{len(jobs) // n_unique} activity classes): K2 = plain on {len(ws_buckets)} WS buckets "
          f"({sum(a[2].shape[0] for _, a in ws_buckets)} tasks), K3 = plain on those strips and "
          f"{len(os_buckets)} OS stream buckets "
          f"({sum(s_.shape[0] for _, s_ in os_buckets)} strips)", flush=True)

    # 2. The path through its entry point, counted, then its steps timed.
    clear_profile_cache()
    reset_counts()
    res, wall_ms = host_timed(lambda: codesign(arch, traffic, use_cache=False))
    counts = read_counts()
    for name in ("ws_task_toggles", "strip_toggles"):
        check(counts[name] > 0, f"{name} was not launched on the serving path")
    step_ms = {}
    js2, step_ms["job set"] = host_timed(lambda: weighted_gemms(get_arch(arch), get_preset(traffic)))
    (a_h, a_v, stats), step_ms["activities"] = host_timed(lambda: wl.measured_design_gemm_activities(
        grid, js2.gemms, densities=js2.densities, clip=clip, use_cache=False, return_stats=True))
    kw = dict(layouts=DEFAULT_FAMILIES, weights=js2.weights, macs_per_token=js2.macs_per_token)
    ev, step_ms["objective"] = host_timed(lambda: evaluate_fleet_objective(
        grid, a_h, a_v, js2.gemms, **kw))

    # 3. Against the JAX package's file.
    jr = ref["jobset"]
    got_js = res.jobset
    check([[g.name, g.m, g.k, g.n] for g in got_js.gemms] == jr["gemms"],
          "serving job set: GEMMs differ from the reference file's")
    check(got_js.weights.tolist() == jr["weights"] and got_js.mac_rate.tolist() == jr["mac_rate"]
          and list(got_js.densities) == jr["densities"] and list(got_js.regimes) == jr["regimes"]
          and got_js.macs_per_token == jr["macs_per_token"],
          "serving job set: weights, rates, densities or MACs/token differ from the file's")
    check(np.array_equal(a_h, ref["a_h"]) and np.array_equal(a_v, ref["a_v"]),
          "serving activities differ from the reference file's")
    got_stats = {key: getattr(stats, key) for key in BATCH_STATS_FIELDS}
    check(got_stats == ref["batch_stats"] and stats.degraded == stats.skipped == 0
          and not stats.failure_report,
          f"serving scheduler: stats {got_stats} reference {ref['batch_stats']}")
    err = {}
    for name, got in (("j_per_mac", res.eval.j_per_mac),
                      ("j_per_mac_robust", res.eval.j_per_mac_robust),
                      ("j_per_token_robust", res.eval.j_per_token_robust)):
        g, w = np.asarray(got, float), np.asarray(ref[name], float)
        ok = np.isfinite(w)
        check(bool((np.isfinite(g) == ok).all()), f"serving {name}: feasibility differs")
        err[name] = float(np.max(np.abs(g[ok] - w[ok]) / np.abs(w[ok])))
        check(err[name] <= ENGINE_RTOL, f"serving {name}: {err[name]!r} from the reference file")
    cells = {"best": list(res.best_cell),
             **{r: list(res.regime_cell(r)) for r in ("decode", "prefill")}}
    check(cells == {"best": ref["best_cell"], **ref["regime_cells"]},
          f"serving cells {cells}, reference {ref['best_cell']} {ref['regime_cells']}")
    for f in SERVING_FIELDS:
        check(np.asarray(getattr(ev, f)).tobytes() == np.asarray(getattr(res.eval, f)).tobytes(),
              f"serving {f}: the stepwise run differs from codesign's")
    print(f"  serving: {arch} x {traffic}, {len(got_js.gemms)} GEMM shape classes, "
          f"{got_js.macs_per_token:.6e} MAC/token; job set = file; activities = file (bit for "
          f"bit), scheduler {got_stats}; J/op within {err['j_per_mac']:.1e}, fleet J/op "
          f"{err['j_per_mac_robust']:.1e}, J/token {err['j_per_token_robust']:.1e} of the file; "
          f"best {res.describe_cell(res.best_cell)}, {res.j_per_token!r} J/token; decode and "
          f"prefill cells {cells['decode']} {cells['prefill']} = file", flush=True)

    # 4. The same evaluation through the checkpointed sweep.
    def sweep_eval(**sweep_kw):
        return evaluate_fleet_objective(grid, a_h, a_v, js2.gemms, **kw,
                                        sweep=SweepConfig(chunk_size=SERVING_CHUNK, **sweep_kw))

    n_chunks = -(-grid.n_points // SERVING_CHUNK)
    with tempfile.TemporaryDirectory() as tmp:
        cold, step_ms["sweep cold"] = host_timed(lambda: sweep_eval(store=f"{tmp}/a"))
        resumed, step_ms["sweep resumed"] = host_timed(lambda: sweep_eval(store=f"{tmp}/a"))
        try:
            sweep_eval(store=f"{tmp}/b", max_chunks=1)
            fail("serving sweep: max_chunks=1 did not interrupt")
        except SweepInterrupted as exc:
            check(exc.report.chunks_evaluated == 1, f"serving sweep interrupted: {exc.report.summary()}")
        finished = sweep_eval(store=f"{tmp}/b")
    check(cold.sweep_report.rung_counts() == {"cuda": n_chunks} and not cold.sweep_report.failures,
          f"serving sweep: {cold.sweep_report.summary()}")
    check(resumed.sweep_report.chunks_resumed == n_chunks,
          f"serving sweep resumed: {resumed.sweep_report.summary()}")
    check(finished.sweep_report.chunks_resumed == 1
          and finished.sweep_report.chunks_evaluated == n_chunks - 1,
          f"serving sweep after the interruption: {finished.sweep_report.summary()}")
    for f in SERVING_FIELDS:
        for other, what in ((resumed, "resumed"), (finished, "interrupted and resumed")):
            check(np.asarray(getattr(cold, f)).tobytes() == np.asarray(getattr(other, f)).tobytes(),
                  f"serving sweep {what}: {f} differs from the uninterrupted sweep")
    # chunked against unchunked: bit for bit where that holds, else within
    # 1e-12, the field named
    chunked_note = []
    for f in SERVING_FIELDS:
        g, w = np.asarray(getattr(cold, f)), np.asarray(getattr(ev, f))
        if g.tobytes() == w.tobytes():
            continue
        ok = np.isfinite(w)
        d = float(np.max(np.abs(g[ok] - w[ok]) / np.abs(w[ok])))
        check(bool((np.isfinite(g) == ok).all()) and d <= REL_TOL,
              f"serving sweep: chunked {f} {d!r} from unchunked")
        chunked_note.append(f"{f} {d:.1e}")
    with faults.injected([faults.FaultSpec("nan", match="cuda:j_per_mac|chunk2", max_fires=1)]):
        poisoned = sweep_eval()
    rep = poisoned.sweep_report
    check(rep.rung_counts() == {"cuda": n_chunks - 1, "numpy": 1}
          and rep.failures.actions() == {"degraded:numpy": 1}
          and [r.rung for r in rep.records if r.index == 2] == ["numpy"],
          f"serving sweep, poisoned chunk 2: {rep.summary()}")
    for f in ("j_per_mac", "j_per_mac_robust", "bus_power_robust"):
        g, w = np.asarray(getattr(poisoned, f)), np.asarray(getattr(ev, f))
        ok = np.isfinite(w)
        d = float(np.max(np.abs(g[ok] - w[ok]) / np.abs(w[ok])))
        check(bool((np.isfinite(g) == ok).all()) and d <= ENGINE_RTOL,
              f"serving sweep, poisoned chunk 2: {f} {d!r} from the plain result")
    print(f"  serving sweep ({n_chunks} chunks of {SERVING_CHUNK} points): healthy "
          f"{cold.sweep_report.rung_counts()}; resume = uninterrupted, bit for bit; max_chunks=1 "
          f"interrupted and resumed = uninterrupted, bit for bit; chunked vs unchunked: "
          + ("bit for bit" if not chunked_note else "bit for bit but " + ", ".join(chunked_note))
          + f"; poisoned chunk 2 recorded on {rep.rung_counts()}, {rep.failures.actions()}, "
          "within 1e-10 of the plain result", flush=True)

    # 5. Where the activities' and the objective's time goes, and the
    # objective's warm throughput beside engine="numpy".
    events = {}
    for label, fn in (("activities", lambda: wl.measured_design_gemm_activities(
            grid, js2.gemms, densities=js2.densities, clip=clip, use_cache=False)),
                      ("objective", lambda: evaluate_fleet_objective(grid, a_h, a_v, js2.gemms, **kw))):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            traced_ms = (time.perf_counter() - t0) * 1e3
        ev_ = {e.key: (e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
               and e.key not in PROFILER_OWN_EVENTS}
        events[label] = ev_
        busy = sum(ms for ms, _ in ev_.values())
        kernels = {k: v for k, v in ev_.items() if "toggles" in k}
        print(f"  serving {label} trace: wall {traced_ms:.1f} ms (profiler on), device busy "
              f"{busy:.4f} ms = {100 * busy / traced_ms:.3f}%, {sum(n for _, n in ev_.values())} "
              f"device events; " + (", ".join(f"{k[:40]} {ms:.4f} ms in {n}" for k, (ms, n)
                                               in sorted(kernels.items())) or "no toggle kernel"))
    n_cells = grid.n_points * len(DEFAULT_FAMILIES)
    warm = sorted(host_timed(lambda: evaluate_fleet_objective(grid, a_h, a_v, js2.gemms, **kw))[1]
                  for _ in range(5))[2]
    warm_np = sorted(host_timed(lambda: evaluate_fleet_objective(
        grid, a_h, a_v, js2.gemms, engine="numpy", **kw))[1] for _ in range(3))[1]
    print(f"  serving objective, warm ({len(js2.gemms)} GEMMs x {grid.n_points} points x "
          f"{len(DEFAULT_FAMILIES)} families): {warm:.3f} ms a call, {n_cells / warm * 1e3:,.0f} "
          f"(point x layout) cells/s on the card; engine='numpy' {warm_np:.3f} ms, "
          f"{n_cells / warm_np * 1e3:,.0f} cells/s | {smi}")
    print(f"serving path (codesign, cache cleared): {wall_ms:.1f} ms; steps: " + ", ".join(
        f"{label} {ms:.1f}" for label, ms in step_ms.items()) + f" ms; launches {counts} | {smi}",
          flush=True)
    return {"launches": {k: counts[k] for k in ("ws_task_toggles", "strip_toggles")},
            "wall_ms": wall_ms}


# The model path (phase 6): the ten reduced archs in float32 against the
# JAX package's logits (src/repro_torch/data/models_reference.json, at the
# reference's decode-against-forward tolerance), then Qwen3-8B at its full
# published widths (src/repro/configs/qwen3_8b.py: 36 layers, d 4096, GQA
# 32/8, head_dim 128, qk-norm, vocab 151936) in bf16: a forward at B x S,
# then serving's generate.  K7 against the torch route: float32 within
# MODEL_ROUTE_TOL (rtol and atol; TF32 three-product attention against an
# f32 softmax), bf16 within MODEL_BF16_REL in relative L2 (three times the
# bf16 rendering's own distance from float32 at depth 36, 1.1e-2 on the
# CPU); prefill_with_cache against forward's last position likewise.
MODEL_FILE_TOL = 2e-3
MODEL_ROUTE_TOL = 1e-4
MODEL_BF16_REL = 3e-2
MODEL_ARCH = "qwen3_8b"
MODEL_BATCH, MODEL_SEQ = 4, 2048
SERVE_PROMPT, SERVE_GEN = 64, 16


def model_path_check(*, dev, smi) -> dict:
    """Phase 6: the model stack on the card through its entry points
    (``models.model.forward``, ``decode_step``, ``launch.serve.generate``).
    Returns the path's K7 launches and K7's time at the full-width shape."""
    import base64

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.registry import ARCH_IDS, get_arch
    from repro_torch.kernels.flash_attention import kernel as FA
    from repro_torch.launch.serve import generate
    from repro_torch.models import model as M

    ref = json.loads((ROOT / "src" / "repro_torch" / "data" / "models_reference.json").read_text())

    def logits_of(doc):
        return torch.from_numpy(np.frombuffer(base64.b64decode(doc["f32_base64"]), dtype="<f4")
                                .reshape(doc["shape"]).copy())

    def reduced_case(arch):
        doc = ref["archs"][arch]
        cfg = get_arch(arch).reduced()
        cfg = dataclasses.replace(cfg, capacity_factor=doc["capacity_factor"])
        params = M.from_reference_params(cfg, M.seeded_numpy_params(cfg, ref["seed"]), device=dev)
        toks = torch.tensor(doc["tokens"], dtype=torch.int32, device=dev)
        long_toks = torch.tensor(doc["long_tokens"], dtype=torch.int32, device=dev)
        return doc, cfg, params, toks, long_toks

    def reduced_run(cfg, params, toks, long_toks):
        fwd, _ = M.forward(cfg, params, toks, last_only=True)
        long_fwd, _ = M.forward(cfg, params, long_toks, last_only=True)
        cache, _ = M.init_cache(cfg, toks.shape[0], toks.shape[1], device=dev)
        for t in range(toks.shape[1]):
            dec, cache = M.decode_step(cfg, params, cache, toks[:, t:t + 1], t)
        return {"forward": fwd, "long_forward": long_fwd, "decode": dec}

    cases = {arch: reduced_case(arch) for arch in ARCH_IDS}
    cfg = get_arch(MODEL_ARCH).with_dtypes("bfloat16", "bfloat16")
    t0 = time.perf_counter()
    params, _ = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weight_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    gen = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (MODEL_BATCH, MODEL_SEQ), generator=gen, device=dev,
                           dtype=torch.int32)
    prompt = tokens[:, :SERVE_PROMPT].contiguous()

    # 1. The path, counted: the reduced archs on the default route (K7 f32
    # where they attend), then Qwen3-8B's forward (K7 bf16) and generate.
    reset_counts()
    outs = {arch: reduced_run(*case[1:]) for arch, case in cases.items()}
    torch.cuda.reset_peak_memory_stats()
    (full, _), forward_ms = host_timed(lambda: M.forward(cfg, params, tokens, last_only=True))
    served, generate_ms = host_timed(lambda: generate(cfg, params, prompt, SERVE_GEN))
    peak = torch.cuda.max_memory_allocated()
    counts = read_counts()
    attn_layers = {arch: c[1].n_stages * sum(m == "attn" for m, _ in c[1].stage_pattern)
                   for arch, c in cases.items()}
    mamba_layers = {arch: c[1].n_stages * sum(m == "mamba" for m, _ in c[1].stage_pattern)
                    for arch, c in cases.items()}
    want_tf32 = 2 * sum(attn_layers.values())
    check(counts["flash_attention_tf32"] == counts["attention_operand_planes"] == want_tf32,
          f"model path: K7 f32 launched {counts['flash_attention_tf32']} times (prep "
          f"{counts['attention_operand_planes']}), want {want_tf32} (two forwards per reduced arch)")
    check(counts["flash_attention_tc"] == cfg.n_layers,
          f"model path: K7 bf16 launched {counts['flash_attention_tc']} times, want {cfg.n_layers}")
    # L3 on the reduced Mamba layers (f32, N 16, d_inner a multiple of 16),
    # once a layer in each forward; decode steps carry the state themselves
    want_scan = 2 * sum(mamba_layers.values())
    check(counts["selective_scan_fwd"] == want_scan,
          f"model path: L3 launched {counts['selective_scan_fwd']} times, want {want_scan} (two "
          f"forwards per reduced arch)")
    # L4 on every RMSNorm and the q/k passes whose rows it takes
    check(counts["rms_norm_fwd"] > 0 and counts["qk_rope_fwd"] > 0, f"model path: L4 launched "
          f"{counts['rms_norm_fwd']} row norms and {counts['qk_rope_fwd']} q/k passes")
    others = {k: v for k, v in counts.items() if v and not k.startswith(("flash_attention",
                                                                          "attention_operand",
                                                                          "selective_scan",
                                                                          "rms_norm", "qk_rope"))}
    check(not others, f"model path launched other kernels: {others}")

    # 2. The reduced archs against the JAX package's logits, and against the
    # torch route on the same card.
    worst = {}
    for arch, (doc, cfg_r, params_r, toks, long_toks) in cases.items():
        for key, got in outs[arch].items():
            want = logits_of(doc[key]).to(dev)
            check(tuple(got.shape) == tuple(want.shape) and bool(torch.isfinite(got).all()),
                  f"{arch} {key}: shape {tuple(got.shape)} or non-finite logits")
            err = (got - want).abs()
            check(bool((err <= MODEL_FILE_TOL + MODEL_FILE_TOL * want.abs()).all()),
                  f"{arch} {key}: max |card - reference| {err.max().item()!r} beyond rtol = atol = "
                  f"{MODEL_FILE_TOL}")
            worst[arch, key] = err.max().item()
        if attn_layers[arch]:
            plain, _ = M.forward(cfg_r, params_r, long_toks, last_only=True, attention="torch")
            err = (outs[arch]["long_forward"] - plain).abs()
            check(bool((err <= MODEL_ROUTE_TOL + MODEL_ROUTE_TOL * plain.abs()).all()),
                  f"{arch}: K7 route against torch route {err.max().item()!r} beyond "
                  f"{MODEL_ROUTE_TOL}")
            worst[arch, "route"] = err.max().item()
    print(f"  model path, reduced archs (float32, K7 tf32 on {sum(map(bool, attn_layers.values()))} "
          f"attention archs): max |card - JAX reference| by arch (forward, decode, S=128 forward; "
          f"within {MODEL_FILE_TOL}) and |K7 route - torch route| (within {MODEL_ROUTE_TOL}): "
          + "; ".join(f"{arch} {worst[arch, 'forward']:.2e} {worst[arch, 'decode']:.2e} "
                      f"{worst[arch, 'long_forward']:.2e}"
                      + (f" route {worst[arch, 'route']:.2e}" if (arch, 'route') in worst else "")
                      for arch in cases), flush=True)
    del cases, outs

    # 3. Qwen3-8B at full width: the torch route, prefill_with_cache and the
    # generated tokens.
    check(tuple(full.shape) == (MODEL_BATCH, cfg.vocab_size) and full.dtype == torch.bfloat16
          and bool(torch.isfinite(full).all()), f"{MODEL_ARCH}: forward logits {full.shape} "
          f"{full.dtype} or non-finite")
    _, warm_ms = host_timed(lambda: M.forward(cfg, params, tokens, last_only=True))
    (plain, _), plain_ms = host_timed(lambda: M.forward(cfg, params, tokens, last_only=True,
                                                        attention="torch"))
    route_rel = rel_l2(full, plain)
    # the same forward with the norms and RoPE on their torch route: phase 8
    # holds the mesh to it bit for bit
    with torch_norms():
        (torch_norms_logits, _), torch_norms_ms = host_timed(
            lambda: M.forward(cfg, params, tokens, last_only=True))
    norms_rel = rel_l2(full, torch_norms_logits)
    check(norms_rel <= MODEL_BF16_REL, f"{MODEL_ARCH}: L4 against the norms' torch route, "
          f"relative L2 {norms_rel!r} beyond {MODEL_BF16_REL}")
    check(route_rel <= MODEL_BF16_REL, f"{MODEL_ARCH}: K7 route against torch route, relative "
          f"L2 {route_rel!r} beyond {MODEL_BF16_REL}")
    argmax_agree = (full.argmax(-1) == plain.argmax(-1)).float().mean().item()
    # prefill as generate runs it (cache for prompt + gen), then the gen
    # decode steps along the generated tokens, timed: each step's argmax
    # must be generate's next token
    (pre_logits, cache), prefill_ms = host_timed(lambda: M.prefill_with_cache(
        cfg, params, prompt, cache_seq_len=SERVE_PROMPT + SERVE_GEN))
    short, _ = M.forward(cfg, params, prompt, last_only=True)
    prefill_rel = rel_l2(pre_logits, short)
    check(prefill_rel <= MODEL_BF16_REL, f"{MODEL_ARCH}: prefill_with_cache against forward's "
          f"last position, relative L2 {prefill_rel!r} beyond {MODEL_BF16_REL}")
    check(tuple(served.shape) == (MODEL_BATCH, SERVE_GEN) and served.dtype == torch.int32
          and bool(((served >= 0) & (served < cfg.vocab_size)).all()),
          f"{MODEL_ARCH}: generated tokens {tuple(served.shape)} {served.dtype} out of range")

    def decode_steps():
        return [M.decode_step(cfg, params, cache, served[:, i:i + 1], SERVE_PROMPT + i)[0].argmax(-1)
                for i in range(SERVE_GEN)]

    steps, decode_ms = host_timed(decode_steps)
    replayed = torch.stack([pre_logits.argmax(-1)] + steps[:-1], dim=1).to(torch.int32)
    check(torch.equal(replayed, served), f"{MODEL_ARCH}: prefill and decode steps replayed along "
          f"generate's tokens do not give them back")

    def traced(fn) -> tuple[float, float, int, dict]:
        """(wall ms with the profiler on, device busy ms, device events,
        K7 bf16 launches) of one call of ``fn``."""
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
                  and e.self_device_time_total > 0 and e.key not in PROFILER_OWN_EVENTS]
        k7 = {e.key: e.count for e in events if "flash_attention_tc" in e.key}
        return (wall, sum(e.self_device_time_total for e in events) / 1e3,
                sum(e.count for e in events), k7)

    # the decode steps again (the same tokens into the same slots), traced
    dec_wall, dec_busy, dec_events, _ = traced(decode_steps)
    del cache, short

    # 4. K7's launches in a traced forward, and its time at this shape beside
    # SDPA (is_causal, K and V repeated to the query heads outside the
    # timing) and its plain version; bound: 4 * D operations per visible
    # (query, key) pair at the bf16 tensor-core rate, or q, k, v and the
    # output moved once.
    # torch.profiler on this card loses a block of records in about one
    # trace in twelve (tools/trace_counts.py): of three traces of the same
    # forward, those holding fewer device records than the fullest lost
    # some and are no evidence; the fullest must hold one K7 record a layer.
    traces = [traced(lambda: M.forward(cfg, params, tokens, last_only=True)) for _ in range(3)]
    fullest = max(t[2] for t in traces)
    for _, _, n_events, k7_seen in traces:
        k7_count = sum(k7_seen.values())
        check(k7_count == cfg.n_layers if n_events == fullest else k7_count <= cfg.n_layers,
              f"{MODEL_ARCH}: the profiler saw K7 bf16 {k7_seen} in a forward of {n_events} device "
              f"records (fullest {fullest}), want {cfg.n_layers}")
    fwd_wall, fwd_busy, fwd_events, k7_traced = next(t for t in traces if t[2] == fullest)
    h, kv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = torch.randn(MODEL_BATCH, h, MODEL_SEQ, d, generator=gen, device=dev, dtype=torch.bfloat16)
    k, v = (torch.randn(MODEL_BATCH, kv, MODEL_SEQ, d, generator=gen, device=dev,
                        dtype=torch.bfloat16) for _ in range(2))
    got = FA.flash_attention_fwd(q, k, v, causal=True)
    want = FA.flash_attention_fwd_plain(q, k, v, causal=True)
    err = (got.float() - want.float()).abs()
    check(bool((err <= BF16_ATOL + BF16_RTOL * want.float().abs()).all()),
          f"K7 bf16 at the model shape: max |kernel - plain| {err.max().item()!r}")
    k_rep, v_rep = k.repeat_interleave(h // kv, dim=1), v.repeat_interleave(h // kv, dim=1)
    k7_ms = median_ms(lambda: FA.flash_attention_fwd(q, k, v, causal=True), calls=20)
    sdpa_ms = median_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k_rep, v_rep, is_causal=True), calls=20)
    k7_plain_ms = median_ms(lambda: FA.flash_attention_fwd_plain(q, k, v, causal=True), calls=1,
                            bursts=3)
    visible = MODEL_SEQ * (MODEL_SEQ + 1) // 2
    flops = 4 * d * h * MODEL_BATCH * visible
    k7_bound, k7_by = bound_ms(2 * (2 * q.numel() + k.numel() + v.numel()), flops, PEAK_BF16_FLOPS)
    del q, k, v, k_rep, v_rep, got, want

    gb = 1024 ** 3
    print(f"  {MODEL_ARCH} bf16 full width ({cfg.n_layers} layers, d {cfg.d_model}, GQA {h}/{kv}, "
          f"head_dim {d}, vocab {cfg.vocab_size}; {weight_bytes / 1e9:.2f} GB of weights drawn on the "
          f"card in {init_s:.2f} s): forward(last_only) B={MODEL_BATCH} S={MODEL_SEQ} on the K7 route "
          f"{forward_ms:.1f} ms the first call, {warm_ms:.1f} ms warm "
          f"({MODEL_BATCH * MODEL_SEQ / warm_ms * 1e3:,.0f} tokens/s), torch route {plain_ms:.1f} ms; relative L2 between the routes {route_rel!r} (within "
          f"{MODEL_BF16_REL}), argmax agreement {argmax_agree:.3f}; the norms and RoPE on their "
          f"torch route {torch_norms_ms:.1f} ms, relative L2 {norms_rel!r} from L4's; traced forward: wall "
          f"{fwd_wall:.1f} ms (profiler on), device busy {fwd_busy:.1f} ms = "
          f"{100 * fwd_busy / fwd_wall:.1f}%, {fwd_events} device events, K7 {k7_traced}; device "
          f"records in three traces {[t[2] for t in traces]}, K7 records "
          f"{[sum(t[3].values()) for t in traces]} | {smi}")
    print(f"  serving: generate B={MODEL_BATCH} prompt {SERVE_PROMPT} gen {SERVE_GEN}: "
          f"{generate_ms:.1f} ms; prefill_with_cache {prefill_ms:.1f} ms "
          f"({MODEL_BATCH * SERVE_PROMPT / prefill_ms * 1e3:,.1f} tokens/s; relative L2 against "
          f"forward's last position {prefill_rel!r}, within {MODEL_BF16_REL}), decode "
          f"{decode_ms:.1f} ms for {SERVE_GEN} steps ({MODEL_BATCH * SERVE_GEN / decode_ms * 1e3:,.1f}"
          f" tokens/s, {decode_ms / SERVE_GEN:.2f} ms a step; traced: wall {dec_wall:.1f} ms, device "
          f"busy {dec_busy:.1f} ms = {100 * dec_busy / dec_wall:.1f}%, "
          f"{dec_events / SERVE_GEN:.0f} device events a step); peak device memory "
          f"{peak / gb:.2f} GiB over the forward and generate (weights {weight_bytes / gb:.2f} GiB)"
          f" | {smi}")
    print(f"  K7 bf16 at the model shape (B={MODEL_BATCH}, H={h}, KV={kv}, S={MODEL_SEQ}, D={d}, "
          f"causal): {k7_ms:.4f} ms ({flops / k7_ms / 1e9:.1f} TFLOP/s, {100 * k7_bound / k7_ms:.1f}% "
          f"of the bound), SDPA is_causal {sdpa_ms:.4f} ms, plain {k7_plain_ms:.4f} ms, bound "
          f"{k7_bound:.5f} ms ({k7_by}) | {smi}", flush=True)
    launches = {name: counts[name] for name in ("flash_attention_tf32", "attention_operand_planes",
                                                "flash_attention_tc", "selective_scan_fwd",
                                                "rms_norm_fwd", "qk_rope_fwd")}
    print(f"model path launches {launches}", flush=True)
    return {
        "launches": launches,
        "k7": {"ms": k7_ms, "library_ms": sdpa_ms, "plain_ms": k7_plain_ms, "bound_ms": k7_bound,
               "bound_by": k7_by, "shape": [MODEL_BATCH, h, kv, MODEL_SEQ, d]},
        "wall_ms": {"forward": forward_ms, "forward_warm": warm_ms, "generate": generate_ms, "prefill": prefill_ms,
                    "decode": decode_ms},
        "busy_share": {"forward": fwd_busy / fwd_wall, "decode": dec_busy / dec_wall},
        "peak_bytes": peak,
        # phase 8 holds the mesh path's forward to this one, bit for bit
        "forward_logits": torch_norms_logits.cpu(),
        "tokens": tokens.cpu(),
    }


# L3 and the Mamba path (phase 6b): L3 alone at the Jamba cell's scan shape
# (B 1, S 7680, d_inner 8192, N 16, bf16, the long-memory draws of
# tests/test_torch_cuda.py) against its plain version within L3_BF16_REL in
# relative L2 (both scan in f32 and round y to bf16 once: half a bf16 ulp,
# 2^-9, plus f32's order of sums), timed beside that plain version, with the
# benchmark's bound (portbench/ssm_counts.py: bytes at 3.35 TB/s or f32
# CUDA-core operations); then one period of Jamba2-Mini (8 of its 32 layers:
# 7 Mamba, 1 attention, 4 MoE of 16 experts) at its published widths in bf16
# through ``model.forward``, one L3 launch a Mamba layer, timed beside the
# same forward on the chunked scan.  The two routes' logits are printed, not
# gated: they round the scan's output at different points, and at the
# registry's init (A = -1..-16, a state forgets within a few tokens) two
# bf16 renderings of 8 layers differ by 3-6% at reduced widths on the CPU,
# as much as a state dropped every 64 tokens; L3's numbers are held in step
# 1, and the model's at width by the benchmark's Jamba cell.
MAMBA_ARCH = "jamba_v01_52b"
MAMBA_LAYERS = 8
MAMBA_BATCH, MAMBA_SEQ = 1, 7680
L3_BF16_REL = 2.0 ** -9 + 2e-5


def mamba_path_check(*, dev, smi) -> dict:
    """Phase 6b: L3 against its plain version and timed at Jamba's width,
    then a Jamba-width forward with L3 counted and timed.  Returns L3's launches on
    the model path, its largest difference from the plain version and its
    times."""
    import torch

    from portbench import ssm_counts
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels.selective_scan import kernel as SS
    from repro_torch.models import model as M
    from repro_torch.models import ssm

    cfg = dataclasses.replace(get_arch(MAMBA_ARCH), n_layers=MAMBA_LAYERS, mamba_inner_norms=True,
                              rope_kind="none", renormalize_topk=False,
                              capacity_factor=8.0).with_dtypes("bfloat16", "bfloat16")
    b, s, di, n = MAMBA_BATCH, MAMBA_SEQ, cfg.mamba_expand * cfg.d_model, cfg.mamba_d_state
    gen = torch.Generator(device=dev).manual_seed(11)

    def draw(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    # 1. L3 alone, against its plain version on the same operands.
    ops = (draw(b, s, di).bfloat16(), draw(b, s, di).bfloat16(), draw(b, s, di).bfloat16(),
           draw(b, s, n).bfloat16(), draw(b, s, n).bfloat16(), -torch.exp(draw(di, n, scale=2.0)),
           1 + 0.1 * draw(di), draw(di, scale=3.0))
    reset_counts()
    got = SS.selective_scan_fwd(*ops)
    check(read_counts()["selective_scan_fwd"] == 1, "L3: one call did not count one launch")
    want = SS.selective_scan_fwd_plain(*ops)
    check(got.dtype == torch.bfloat16 and got.shape == want.shape
          and bool(torch.isfinite(got).all()), f"L3: y {got.dtype} {tuple(got.shape)} or non-finite")
    rel = rel_l2(got, want)
    max_err = (got.float() - want.float()).abs().max().item()
    check(rel <= L3_BF16_REL, f"L3 at B={b} S={s} d_inner={di} N={n} bf16: relative L2 {rel!r} "
          f"from its plain version, beyond {L3_BF16_REL}")
    ms = median_ms(lambda: SS.selective_scan_fwd(*ops), calls=20)
    plain_ms = median_ms(lambda: SS.selective_scan_fwd_plain(*ops), calls=1, bursts=2)
    widths = {"d_model": cfg.d_model, "mamba_expand": cfg.mamba_expand, "mamba_d_state": n}
    bound, by = bound_ms(ssm_counts.scan_bytes(widths, b, s), ssm_counts.scan_ops(widths, b, s),
                         ssm_counts.F32_FLOPS_PER_S)
    print(f"  L3 at B={b} S={s} d_inner={di} N={n} bf16: relative L2 from its plain version "
          f"{rel:.3e} (within {L3_BF16_REL:.3e}), max |diff| {max_err:.3e}; {ms:.4f} ms a call, "
          f"plain {plain_ms:.1f} ms, bound {bound:.5f} ms ({by}), {100 * bound / ms:.1f}% of it "
          f"| {smi}", flush=True)
    del ops, got, want

    # 2. One period of Jamba2-Mini through the model path: L3 once a Mamba
    # layer, K7 bf16 once an attention layer, no other kernel; then the same
    # forward on the chunked scan.
    mamba_layers = cfg.n_stages * sum(m == "mamba" for m, _ in cfg.stage_pattern)
    attn_layers = cfg.n_stages * sum(m == "attn" for m, _ in cfg.stage_pattern)
    t0 = time.perf_counter()
    params, _ = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weight_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen, device=dev, dtype=torch.int32)
    reset_counts()
    (fused, _), first_ms = host_timed(lambda: M.forward(cfg, params, tokens, last_only=True))
    counts = read_counts()
    check(counts["selective_scan_fwd"] == mamba_layers,
          f"{MAMBA_ARCH} {MAMBA_LAYERS} layers: L3 launched {counts['selective_scan_fwd']} times, "
          f"want {mamba_layers} (one a Mamba layer)")
    check(counts["flash_attention_tc"] == attn_layers,
          f"{MAMBA_ARCH}: K7 bf16 launched {counts['flash_attention_tc']} times, want {attn_layers}")
    others = {k: v for k, v in counts.items() if v and k not in ("selective_scan_fwd",
                                                                  "flash_attention_tc",
                                                                  "rms_norm_fwd")}
    check(not others, f"{MAMBA_ARCH}: the forward launched other kernels: {others}")
    _, warm_ms = host_timed(lambda: M.forward(cfg, params, tokens, last_only=True))
    real_route = ssm.scan_route
    ssm.scan_route = lambda *operands: "chunked"
    try:
        (chunked, _), chunked_ms = host_timed(lambda: M.forward(cfg, params, tokens, last_only=True))
    finally:
        ssm.scan_route = real_route
    check(read_counts()["selective_scan_fwd"] == 2 * mamba_layers,
          f"{MAMBA_ARCH}: L3 launched on the chunked route")
    check(tuple(fused.shape) == (b, cfg.vocab_size) and bool(torch.isfinite(fused).all()),
          f"{MAMBA_ARCH}: logits {tuple(fused.shape)} or non-finite on L3's route")
    route_rel = rel_l2(fused, chunked)
    print(f"  {MAMBA_ARCH} bf16 full width, {MAMBA_LAYERS} of 32 layers ({mamba_layers} Mamba, "
          f"{attn_layers} attention, {cfg.num_experts} experts; {weight_bytes / 1e9:.2f} GB of "
          f"weights drawn on the card in {init_s:.2f} s): forward(last_only) B={b} S={s} "
          f"{first_ms:.1f} ms the first call, {warm_ms:.1f} ms warm, {chunked_ms:.1f} ms on the "
          f"chunked scan; relative L2 between the routes {route_rel:.3e} (not gated); "
          f"launches L3 {counts['selective_scan_fwd']}, K7 bf16 "
          f"{counts['flash_attention_tc']} | {smi}", flush=True)
    return {"launches": {"selective_scan_fwd": counts["selective_scan_fwd"]}, "max_abs_err": max_err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "shape": [b, s, di, n]}


# L4 (phase 6c): the row norm at the long prompt's hidden rows (7680, 4096)
# bf16, and the q/k pass at Qwen3-8B's q (1, 32, 7680, 128) and k
# (1, 8, 7680, 128) with their per-head norms, read in place from the
# einsum's permuted views, each against its plain version (the card tests'
# limits: at most one bf16 ulp apart for the norm, NORM_BF16_REL relative L2
# for both), then timed beside the plain version, the torch route's float32
# chains (``layers.rms_norm``'s nine launches; ``rms_norm`` then
# ``apply_rope``), torch.nn.functional.rms_norm (one PyTorch call, which the
# port never makes) and the byte bound: x read and y written once, with the
# weights and, for the rotation, the (S, 64) float32 cos and sin tables.
NORM_ROWS, NORM_WIDTH, NORM_HEAD_DIM = 7680, 4096, 128
NORM_HEADS, NORM_KV_HEADS = 32, 8
NORM_BF16_REL = 1e-3
L4_KERNEL = "rms_norm_rows_kernel"


def norm_path_check(*, dev, smi) -> dict:
    """Phase 6c: L4 against its plain version and timed at the cells'
    shapes.  Returns, for each entry point, its largest difference from the
    plain version and its times."""
    import torch
    import torch.nn.functional as F
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.rms_norm import kernel as L4
    from repro_torch.models import layers

    gen = torch.Generator(device=dev).manual_seed(13)

    def draw(*shape, scale=3.0, shift=0.0):
        return (shift + scale * torch.randn(shape, generator=gen, device=dev)).bfloat16()

    s, d, hd = NORM_ROWS, NORM_WIDTH, NORM_HEAD_DIM
    x, w = draw(s, d), draw(d, scale=0.3, shift=1.0)
    # the einsum's (B, S, H, hd) products seen as (B, H, S, hd)
    q = draw(1, s, NORM_HEADS, hd).permute(0, 2, 1, 3)
    k = draw(1, s, NORM_KV_HEADS, hd).permute(0, 2, 1, 3)
    wq, wk = draw(hd, scale=0.3, shift=1.0), draw(hd, scale=0.3, shift=1.0)
    cos, sin = layers.rope_angles(torch.arange(s, device=dev).expand(1, s), hd, 1e6)

    def qk():
        return L4.qk_rope_fwd(q, wq, cos, sin), L4.qk_rope_fwd(k, wk, cos, sin)

    def qk_plain():
        return L4.qk_rope_fwd_plain(q, wq, cos, sin), L4.qk_rope_fwd_plain(k, wk, cos, sin)

    reset_counts()
    got, (got_q, got_k) = L4.rms_norm_fwd(x, w), qk()
    counts = read_counts()
    check(counts["rms_norm_fwd"] == 1 and counts["qk_rope_fwd"] == 2,
          f"L4: three calls counted {counts['rms_norm_fwd']} row norms and "
          f"{counts['qk_rope_fwd']} q/k passes")
    want, (want_q, want_k) = L4.rms_norm_fwd_plain(x, w), qk_plain()
    ulps = (got.view(torch.int16).int() - want.view(torch.int16).int()).abs().max().item()
    errors = {"rms_norm_fwd": (rel_l2(got, want), (got.float() - want.float()).abs().max().item()),
              "qk_rope_fwd": (max(rel_l2(got_q, want_q), rel_l2(got_k, want_k)),
                              max((a.float() - b.float()).abs().max().item()
                                  for a, b in ((got_q, want_q), (got_k, want_k))))}
    check(got.is_contiguous() and got_q.is_contiguous() and got_k.is_contiguous(),
          "L4: an output is not contiguous")
    check(ulps <= 1 and errors["rms_norm_fwd"][0] <= NORM_BF16_REL, f"L4 row norm at ({s}, {d}) "
          f"bf16: {ulps} ulp apart, relative L2 {errors['rms_norm_fwd'][0]!r} from its plain version")
    check(errors["qk_rope_fwd"][0] <= NORM_BF16_REL, f"L4 q/k pass: relative L2 "
          f"{errors['qk_rope_fwd'][0]!r} from its plain version, beyond {NORM_BF16_REL}")
    del got, got_q, got_k, want, want_q, want_k

    def chain_qk():
        return layers.qk_norm_rope(q, k, wq, wk, cos, sin)

    # Read before each traced call, so that each finds its rows in device
    # memory and not in the 50 MB L2 that the last call's 63 MB left warm
    # (a warm read measured the row norm above its byte bound).
    l2_flush = torch.zeros((L2_FLUSH_BYTES // 4096, 1024), dtype=torch.int32, device=dev)

    def kernel_ms(fn, calls: int = 20) -> float:
        """L4's device time a call of ``fn`` from device memory: its
        kernels' records in a ``torch.profiler`` trace of ``calls`` calls,
        the L2 flushed before each.  A call's host work (the wrapper's
        checks, about as long as a q/k kernel) bounds the event timing of
        back-to-back calls; the trace sees the kernels."""
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                l2_flush.sum(dim=1)
                fn()
            torch.cuda.synchronize()
        total = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA and L4_KERNEL in e.key) / 1e3 / calls
        check(total > 0, "torch.profiler recorded no device time of L4")
        return total

    norm_bytes = 2 * x.numel() * x.element_size() + w.numel() * w.element_size()
    qk_bytes = (2 * (q.numel() + k.numel()) * q.element_size() + 2 * hd * w.element_size()
                + 2 * cos.numel() * cos.element_size())
    out = {}
    for name, kernel, plain, chain, library, n_bytes in (
            ("rms_norm_fwd", lambda: L4.rms_norm_fwd(x, w), lambda: L4.rms_norm_fwd_plain(x, w),
             lambda: layers.rms_norm(x, w), lambda: F.rms_norm(x, (d,), w, 1e-6), norm_bytes),
            ("qk_rope_fwd", qk, qk_plain, chain_qk, None, qk_bytes)):
        ms = median_ms(kernel, calls=50)
        dev_ms = kernel_ms(kernel)
        plain_ms = median_ms(plain, calls=10)
        with torch_norms():
            chain_ms = median_ms(chain, calls=10)
        library_ms = median_ms(library, calls=50) if library is not None else None
        bound, by = bound_ms(n_bytes, 0)
        out[name] = {"ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms, "torch_route_ms": chain_ms,
                     "library_ms": library_ms, "bound_ms": bound, "bound_by": by,
                     "max_abs_err": errors[name][1]}
        shape = f"({s}, {d}) bf16" if name == "rms_norm_fwd" else (
            f"q (1, {NORM_HEADS}, {s}, {hd}) and k (1, {NORM_KV_HEADS}, {s}, {hd}) bf16, permuted "
            f"views, with their norms")
        print(f"  L4 {name} at {shape}: relative L2 from its plain version {errors[name][0]:.3e}"
              + (f" ({ulps} ulp at most)" if name == "rms_norm_fwd" else "")
              + f"; device {dev_ms:.4f} ms, {100 * bound / dev_ms:.1f}% of the bound {bound:.5f} ms "
              f"({by}); {ms:.4f} ms a call back to back (events); plain {plain_ms:.4f} ms, the "
              f"torch route's chain {chain_ms:.4f} ms"
              + (f", F.rms_norm {library_ms:.4f} ms" if library_ms is not None else "")
              + f" | {smi}", flush=True)
    out["shape"] = [s, d, NORM_HEADS, NORM_KV_HEADS, hd]
    return out


# The training path (phase 7): the ten reduced archs' training in float32
# against the JAX package's (src/repro_torch/data/train_reference.json, at
# phase 6's tolerance, relative), on the file's token streams (the
# pipeline draws them with numpy's Zipf sampler, whose stream another numpy
# version may change); crash and restart through
# launch.train.build, bit for bit; then Qwen3-8B at its full published
# widths with depth cut to TRAIN_LAYERS layers (36 layers of f32 parameters,
# gradients and AdamW moments, 16 bytes a parameter, do not fit one card),
# in the config's own f32 with remat "stage", at B x S = TRAIN_BATCH x
# TRAIN_SEQ (above attn_chunk = 1024: blockwise attention).  Its first step's
# cross-entropy is held to an independent one (the serving forward's f32
# logits through F.cross_entropy) within TRAIN_CE_RTOL, the same step with
# a chunked cross-entropy (loss_chunk TRAIN_LOSS_CHUNK) to its loss within
# TRAIN_CHUNK_RTOL (the reference's identity, tests/test_perf_variants.py)
# and to its gradient norm within TRAIN_CHUNK_GRAD_RTOL (the reference
# test's gradient tolerance).
TRAIN_ARCH = "qwen3_8b"
TRAIN_LAYERS = 2
TRAIN_BATCH, TRAIN_SEQ = 2, 2048
TRAIN_STEPS = 4
TRAIN_CE_RTOL = 1e-4
TRAIN_LOSS_CHUNK = 512
TRAIN_CHUNK_RTOL = 1e-5
TRAIN_CHUNK_GRAD_RTOL = 1e-4
TRAIN_RESUME_STEPS, TRAIN_CRASH_AT = 8, 5
TRAIN_FALL_STEPS, TRAIN_FALL_LR = 12, 1e-3


def training_path_check(*, dev, smi) -> dict:
    """Phase 7: the training path on the card through its entry points
    (``launch.steps.make_train_step``, ``launch.train.build`` and its
    coordinator), with every kernel count 0 before it and read after:
    training launches none of the port's kernels (K7 is forward only, and
    the loss takes the torch attention route)."""
    import tempfile

    import numpy as np
    import torch
    import torch.nn.functional as F
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs.registry import ARCH_IDS, get_arch
    from repro_torch.data.pipeline import DataConfig, batch_at_step
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import build
    from repro_torch.models import model as M
    from repro_torch.optim import adamw

    ref = json.loads((ROOT / "src" / "repro_torch" / "data" / "train_reference.json").read_text())
    metric_keys = ("loss", "ce", "aux", "grad_norm", "lr")

    def batches(cfg, seq, steps, batch=None):
        data = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                          global_batch=batch or ref["batch"], num_codebooks=cfg.num_codebooks,
                          seed=ref["seed"])
        return [{k: torch.from_numpy(v).to(dev) for k, v in batch_at_step(data, step).items()
                 if k != "positions"} for step in range(steps)]

    def recorded(stream):
        s = torch.tensor(stream, dtype=torch.int32, device=dev)
        return {"tokens": s[:, :-1], "labels": s[:, 1:]}

    def flat(tree, prefix=""):
        out = {}
        for key, value in tree.items():
            out.update(flat(value, f"{prefix}{key}/") if isinstance(value, dict)
                       else {prefix + key: value})
        return out

    def leaf_norms(cfg, params, batch):
        leaves = flat(params)
        loss, _ = M.loss_fn(cfg, params, batch)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        return {k: g.double().norm().item() for k, g in zip(leaves, grads)}

    def rel_err(got, want):
        return abs(got - want) / abs(want) if want else abs(got)

    reset_counts()
    t_phase = time.perf_counter()

    # 1. The ten reduced archs against the JAX package's training.
    worst, same_tokens = {}, True
    for arch in ARCH_IDS:
        doc = ref["archs"][arch]
        cfg = dataclasses.replace(get_arch(arch).reduced(), capacity_factor=doc["capacity_factor"])
        tree = M.seeded_numpy_params(cfg, ref["seed"])
        got = {}
        for part, seq, streams in (("steps", ref["seq"], doc["streams"]),
                                   ("long", ref["long_seq"], [doc["long"]["stream"]])):
            params = M.from_reference_params(cfg, tree, device=dev).stage(None)
            data = [recorded(stream) for stream in streams]
            same_tokens &= all(torch.equal(a[k], b[k]) for a, b in zip(
                data, batches(cfg, seq, len(streams))) for k in a)
            norms = leaf_norms(cfg, params, data[0])
            state = {"params": params, "opt_state": adamw.init_state(adamw.AdamWConfig(), params)}
            step_fn = make_train_step(cfg, adamw.AdamWConfig())
            metrics = []
            for batch in data:
                state, m = step_fn(state, batch)
                metrics.append({k: m[k].item() for k in metric_keys})
            want = doc["steps"] if part == "steps" else [doc["long"]]
            wnorms = doc["grad_norms"] if part == "steps" else doc["long"]["grad_norms"]
            check(set(norms) == set(wnorms), f"{arch} {part}: gradient leaves {sorted(norms)}")
            errs = [rel_err(m[k], w[k]) for m, w in zip(metrics, want) for k in metric_keys]
            errs += [rel_err(norms[k], wnorms[k]) for k in wnorms]
            check(all(map(np.isfinite, [v for m in metrics for v in m.values()])),
                  f"{arch} {part}: non-finite metrics {metrics}")
            got[part] = max(errs)
            check(got[part] <= MODEL_FILE_TOL, f"{arch} {part}: the card's training metrics and "
                  f"gradient leaf norms {max(errs)!r} from the JAX package's (relative), beyond "
                  f"{MODEL_FILE_TOL}: {metrics}")
        worst[arch] = got
    reduced_s = time.perf_counter() - t_phase
    print(f"  training path, reduced archs (float32, AdamW, B={ref['batch']}, the file's token "
          f"streams): "
          f"largest relative difference from the JAX package's metrics and gradient leaf norms "
          f"({ref['steps']} steps at S={ref['seq']}; 1 step at S={ref['long_seq']}; within "
          f"{MODEL_FILE_TOL}): " + "; ".join(f"{a} {w['steps']:.2e} {w['long']:.2e}"
                                             for a, w in worst.items())
          + f" ({reduced_s:.1f} s); batch_at_step here (numpy {np.__version__}) "
          + ("gives" if same_tokens else "does not give") + " the file's token streams",
          flush=True)

    # 2. Crash and restart on the card, bit for bit, under deterministic
    # algorithms (the embedding's backward accumulates; cuBLAS's workspace
    # is fixed in main, before CUDA starts); and the loss falls.
    torch.use_deterministic_algorithms(True)
    try:
        with tempfile.TemporaryDirectory(prefix="train_smoke_") as tmp:
            def run(sub, fail_at=None, **kw):
                coord = build("yi_6b", reduced=True, batch=2, seq=16, steps=TRAIN_RESUME_STEPS,
                              ckpt_dir=f"{tmp}/{sub}", device=dev, **kw)
                try:
                    coord.run(steps=TRAIN_RESUME_STEPS, fail_at_step=fail_at)
                except RuntimeError as exc:
                    check(fail_at is not None and str(exc) == f"injected failure at step {fail_at}",
                          f"crash run: {exc}")
                return coord

            straight = run("a")
            run("b", fail_at=TRAIN_CRASH_AT)
            resumed = run("b")
            like = straight.init_state_fn(device="meta")
            (s1, st1, _), (s2, st2, _) = (CheckpointManager(f"{tmp}/{d}").restore_latest(like)
                                          for d in ("a", "b"))
            leaves1, leaves2 = flat(st1), flat(st2)
            same = [k for k in leaves1 if torch.equal(leaves1[k], leaves2[k])]
            check(s1 == s2 == TRAIN_RESUME_STEPS and len(same) == len(leaves1) == len(leaves2),
                  f"crash at step {TRAIN_CRASH_AT} and restart: final steps {s1}, {s2}; "
                  f"{len(leaves1) - len(same)} of {len(leaves1)} leaves differ from the straight run")
            resumed_steps = [m["step"] for m in resumed.metrics_log]
            fall = build(TRAIN_ARCH, reduced=True, batch=2, seq=16, steps=TRAIN_FALL_STEPS,
                         ckpt_dir=f"{tmp}/c", lr=TRAIN_FALL_LR, device=dev)
            fall.run(steps=TRAIN_FALL_STEPS)
            losses = [m["loss"] for m in fall.metrics_log]
            check(losses[-1] < losses[0], f"{TRAIN_ARCH} reduced: the loss did not fall: {losses}")
    finally:
        torch.use_deterministic_algorithms(False)
    print(f"  crash and restart (yi_6b reduced, {TRAIN_RESUME_STEPS} steps, crash after step "
          f"{TRAIN_CRASH_AT}, restart replays steps {resumed_steps}): {len(leaves1)} state leaves equal "
          f"bit for bit; {TRAIN_ARCH} reduced at lr {TRAIN_FALL_LR}: loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f} over {TRAIN_FALL_STEPS} steps", flush=True)

    # 3. Qwen3-8B at full width, depth cut, in its own f32.
    cfg = dataclasses.replace(get_arch(TRAIN_ARCH), n_layers=TRAIN_LAYERS)
    check(cfg.param_dtype == cfg.compute_dtype == "float32" and cfg.remat == "stage"
          and cfg.loss_chunk == 0, f"{TRAIN_ARCH}: config dtypes {cfg.param_dtype}/"
          f"{cfg.compute_dtype}, remat {cfg.remat}, loss_chunk {cfg.loss_chunk}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0))[0].stage(None)
    opt_cfg = adamw.AdamWConfig()
    state = {"params": params, "opt_state": adamw.init_state(opt_cfg, params)}
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in flat(params).values())
    data = batches(cfg, TRAIN_SEQ, TRAIN_STEPS + 1, batch=TRAIN_BATCH)

    # an independent cross-entropy of the first batch at the initial
    # parameters: the serving forward's f32 logits through F.cross_entropy
    # (the norms on their torch route, as training takes them: no kernel of
    # the port runs on this path)
    with torch_norms():
        logits, _ = M.forward(cfg, params, data[0]["tokens"], attention="torch")
    ce_ind = F.cross_entropy(logits.reshape(-1, cfg.vocab_size),
                             data[0]["labels"].reshape(-1).long()).item()
    del logits
    # the chunked cross-entropy's loss and gradient norm, same parameters
    cfg_chunk = dataclasses.replace(cfg, loss_chunk=TRAIN_LOSS_CHUNK)
    loss_c, _ = M.loss_fn(cfg_chunk, params, data[0])
    grads_c = torch.autograd.grad(loss_c, list(flat(params).values()))
    loss_c, gnorm_c = loss_c.item(), adamw.global_norm(dict(enumerate(grads_c))).item()
    del grads_c

    step_fn = make_train_step(cfg, opt_cfg)
    walls, metrics = [], []
    for batch in data[:TRAIN_STEPS]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        metrics.append({k: m[k].item() for k in metric_keys})
    peak = torch.cuda.max_memory_allocated()
    for i, m in enumerate(metrics):
        check(all(np.isfinite(v) for v in m.values()) and m["grad_norm"] > 0,
              f"{TRAIN_ARCH} step {i + 1}: {m}")
    first = metrics[0]
    check(rel_err(first["ce"], ce_ind) <= TRAIN_CE_RTOL, f"{TRAIN_ARCH}: step 1's ce "
          f"{first['ce']!r} against F.cross_entropy's {ce_ind!r}, beyond {TRAIN_CE_RTOL}")
    check(rel_err(loss_c, first["loss"]) <= TRAIN_CHUNK_RTOL, f"{TRAIN_ARCH}: chunked loss "
          f"{loss_c!r} against {first['loss']!r}, beyond {TRAIN_CHUNK_RTOL}")
    check(rel_err(gnorm_c, first["grad_norm"]) <= TRAIN_CHUNK_GRAD_RTOL, f"{TRAIN_ARCH}: chunked "
          f"gradient norm {gnorm_c!r} against {first['grad_norm']!r}, beyond "
          f"{TRAIN_CHUNK_GRAD_RTOL}")

    # one more step, traced: the device's busy share and its top operations
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = step_fn(state, data[TRAIN_STEPS])
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0 and e.key not in PROFILER_OWN_EVENTS]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:5]
    counts = read_counts()
    check(not any(counts.values()), f"the training path launched kernels of the port: "
          f"{ {k: v for k, v in counts.items() if v} }")

    n_active = M.count_params_analytic(cfg, active_only=True, exclude_embed=True)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops = 6 * n_active * tokens
    warm_ms = statistics.median(walls[1:])
    gb = 1024 ** 3
    print(f"  {TRAIN_ARCH} training at full width ({cfg.n_layers} of 36 layers, d {cfg.d_model}, GQA "
          f"{cfg.num_heads}/{cfg.num_kv_heads}, head_dim {cfg.head_dim}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}; {n_params:,} f32 parameters drawn on the card with their moments in "
          f"{init_s:.2f} s), B={TRAIN_BATCH} S={TRAIN_SEQ}, remat {cfg.remat}, AdamW: step walls "
          f"{', '.join(f'{w:.1f}' for w in walls)} ms: first {walls[0]:.1f} ms, median of steps "
          f"2-{TRAIN_STEPS} {warm_ms:.1f} ms ({tokens / warm_ms * 1e3:,.0f} tokens/s); losses "
          f"{[m['loss'] for m in metrics]}, grad norms {[m['grad_norm'] for m in metrics]}; "
          f"step 1 ce {first['ce']!r}, "
          f"F.cross_entropy {ce_ind!r} (relative {rel_err(first['ce'], ce_ind):.2e}), chunked "
          f"({TRAIN_LOSS_CHUNK}) loss {loss_c!r} ({rel_err(loss_c, first['loss']):.2e}) and "
          f"gradient norm {gnorm_c!r} ({rel_err(gnorm_c, first['grad_norm']):.2e}); peak device "
          f"memory {peak / gb:.2f} GiB; model FLOPs 6*N*D = 6 * {n_active:,} * {tokens} = "
          f"{flops:.4e} a step, {flops / warm_ms / 1e9:.2f} TFLOP/s = "
          f"{100 * flops / warm_ms / 1e9 / (PEAK_OPS_PER_S / 1e12):.1f}% of the f32 CUDA-core peak "
          f"({PEAK_OPS_PER_S / 1e12:.0f} TFLOP/s); traced step: wall {traced_ms:.1f} ms "
          f"(profiler on), device busy {busy_ms:.1f} ms = {100 * busy_ms / traced_ms:.1f}% | {smi}",
          flush=True)
    print("  training step's top device operations: " + "; ".join(
        f"{e.self_device_time_total / 1e3:.1f} ms in {e.count} x {e.key[:70]}" for e in top),
        flush=True)
    print(f"training path launches {counts} ({time.perf_counter() - t_phase:.1f} s)", flush=True)
    return {"launches": counts, "step_ms": walls, "busy_share": busy_ms / traced_ms,
            "peak_bytes": peak}


# The mesh path (phase 8): the model stack on a one-rank NCCL DeviceMesh
# (1 x 1, ("data", "model")), its parameters placed by the sharding rules
# (parallel.sharding.tree_shardings / place) and its activations under
# activation_sharding, so that every shard hint, K7 through local_map and
# the MoE's sharded dispatch (local_map, the expert-parallel redistribution)
# run on the card: Qwen3-8B's forward against phase 6's unsharded one, and
# Mixtral-8x7B's (2 of 32 layers) against its single-device branch, bit for
# bit under deterministic algorithms, and against the torch attention route
# within MODEL_BF16_REL.  Then the dry run of three production cells (two
# decode, one training) on the fake process group in subprocesses (the
# torch of this machine), and phase 7's step through the dry run's counters beside its
# measured time and memory; and, beside them, every reduced arch's train,
# prefill and decode step on an 8-rank (4, 2) fake mesh
# (``python -m repro_torch.launch.dryrun --reduced-matrix``), each of which
# must trace on this torch.
MESH_MOE_ARCH, MESH_MOE_LAYERS = "mixtral_8x7b", 2
MESH_MOE_BATCH, MESH_MOE_SEQ = 2, 2048
# (arch, shape, multi-pod): the per-device argument bytes of the JAX
# package's shardings for the cell's inputs, the sum of
# NamedSharding.shard_shape times the item size (tests/test_torch_dryrun.py
# recomputes them from the JAX package)
DRYRUN_CELLS = {
    ("qwen3_8b", "decode_32k", False): 2_515_647_012,
    ("mixtral_8x7b", "decode_32k", True): 530_727_444,
    ("mixtral_8x7b", "train_4k", False): 1_983_171_076,
}
DRYRUN_TIMEOUT_S = 600
# the f32 rate of phase 7's step (CUDA cores; its products run in full f32)
PHASE7_PEAK_FLOPS = PEAK_OPS_PER_S
DRYRUN_PHASE7 = """
import json, sys, dataclasses
from repro_torch.analysis.roofline import HardwareModel, roofline
from repro_torch.configs.registry import ShapeSpec, get_arch
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.model import count_params_analytic

layers, batch, seq, peak = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), float(sys.argv[4])
cfg = dataclasses.replace(get_arch("qwen3_8b"), n_layers=layers)
shape = ShapeSpec("phase7", "train", seq, batch)
with D.fake_world(1):
    mesh = make_mesh((1, 1), ("data", "model"), device_type="cuda")
    counts, colls, traces = D.measure_cell(cfg, shape, mesh)
six_nd = 6.0 * count_params_analytic(cfg, active_only=True, exclude_embed=True) * batch * seq
hw = HardwareModel(name="h100_sxm_f32", peak_flops=peak)
rf = roofline(counts["flops"], counts["bytes_accessed"], counts["coll_bytes"], 1, six_nd, hw=hw)
print(json.dumps({"counts": counts, "six_nd": six_nd, "roofline": rf.as_dict(),
                  "trace_s": [t.seconds for t in traces]}))
"""


def mesh_path_check(*, dev, smi, model, training) -> dict:
    """Phase 8: the mesh path on the card (see above).  Returns the
    kernels' launches on it, the walls and the dry-run records."""
    import os
    import tempfile

    import torch
    import torch.distributed as dist
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import blocks
    from repro_torch.models import model as M
    from repro_torch.parallel import sharding as sh

    t_phase = time.perf_counter()
    qwen = get_arch(MODEL_ARCH).with_dtypes("bfloat16", "bfloat16")
    moe = dataclasses.replace(get_arch(MESH_MOE_ARCH).with_dtypes("bfloat16", "bfloat16"),
                              n_layers=MESH_MOE_LAYERS)

    def placed(cfg, seed, mesh):
        params, axes = M.init_params(cfg, torch.Generator(device=dev).manual_seed(seed))
        tree = params.stage(None)
        return tree, sh.place(tree, sh.tree_shardings(axes, tree, mesh))

    def tokens_on(t, mesh):
        return sh.place(t, sh.sharding_for(("batch", "seq"), tuple(t.shape), mesh))

    def k7_records(fn) -> tuple[int, int]:
        """(device records, K7 bf16 records) of one traced call."""
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
                  and e.self_device_time_total > 0 and e.key not in PROFILER_OWN_EVENTS]
        return (sum(e.count for e in events),
                sum(e.count for e in events if "flash_attention_tc" in e.key))

    with tempfile.TemporaryDirectory(prefix="mesh_smoke_") as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
                                rank=0, world_size=1, device_id=dev)
        try:
            mesh = make_mesh((1, 1), ("data", "model"))
            # (a) Qwen3-8B at full width, phase 6's weights (seed 0) and tokens
            _, q_params = placed(qwen, 0, mesh)
            q_tokens = tokens_on(model["tokens"].to(dev), mesh)

            def q_forward():
                with sh.activation_sharding(mesh):
                    return M.forward(qwen, q_params, q_tokens, last_only=True)[0]

            # (b) Mixtral-8x7B, 2 layers: the sharded MoE branch on the mesh
            # and the single-device branch, on the same weights and tokens
            m_tree, m_params = placed(moe, 0, mesh)
            gen = torch.Generator(device=dev).manual_seed(2)
            m_plain_tokens = torch.randint(0, moe.vocab_size, (MESH_MOE_BATCH, MESH_MOE_SEQ),
                                           generator=gen, device=dev, dtype=torch.int32)
            m_tokens = tokens_on(m_plain_tokens, mesh)

            def m_forward():
                with sh.activation_sharding(mesh):
                    return M.forward(moe, m_params, m_tokens, last_only=True)[0]

            # Qwen3-8B as phase 6 ran it; the MoE's two branches under
            # deterministic algorithms (its scatter-add accumulates)
            reset_counts()
            q_logits, q_ms = host_timed(q_forward)
            # the single-device forward is held to the capacity branch,
            # which the sharded branch reproduces bit for bit (the compact
            # path's other row blocks round otherwise)
            torch.use_deterministic_algorithms(True)
            compact_min_rows = blocks.COMPACT_MIN_ROWS
            try:
                m_logits, m_ms = host_timed(m_forward)
                counts = read_counts()
                blocks.COMPACT_MIN_ROWS = 2**62
                with torch_norms():  # the mesh's route of the norms and RoPE
                    m_plain, m_plain_ms = host_timed(
                        lambda: M.forward(moe, m_tree, m_plain_tokens, last_only=True)[0])
            finally:
                blocks.COMPACT_MIN_ROWS = compact_min_rows
                torch.use_deterministic_algorithms(False)
            # K7 at Mixtral's shape against its plain version: the torch route
            m_torch = M.forward(moe, m_tree, m_plain_tokens, last_only=True, attention="torch")[0]
            _, q_warm_ms = host_timed(q_forward)
            traces = [k7_records(q_forward) for _ in range(3)]
        finally:
            dist.destroy_process_group()

    check(sh.is_dtensor(q_logits) and sh.is_dtensor(m_logits), "mesh path: the logits are not "
          "DTensors: the forward did not run on the mesh")
    q_full, m_full = q_logits.full_tensor(), m_logits.full_tensor()
    want = model["forward_logits"].to(dev)
    check(torch.equal(q_full, want), f"{MODEL_ARCH} on the 1x1 mesh: logits differ from phase 6's "
          f"unsharded forward on the norms' torch route (max |diff| "
          f"{(q_full.float() - want.float()).abs().max().item()!r})")
    check(torch.equal(m_full, m_plain), f"{MESH_MOE_ARCH} on the 1x1 mesh (sharded MoE dispatch): "
          f"logits differ from the single-device branch (max |diff| "
          f"{(m_full.float() - m_plain.float()).abs().max().item()!r})")
    m_route_rel = rel_l2(m_full, m_torch)
    check(m_route_rel <= MODEL_BF16_REL, f"{MESH_MOE_ARCH} on the 1x1 mesh: K7 route against the "
          f"single-device torch route, relative L2 {m_route_rel!r} beyond {MODEL_BF16_REL}")
    want_k7 = qwen.n_layers + moe.n_layers
    check(counts["flash_attention_tc"] == want_k7, f"mesh path: K7 bf16 launched "
          f"{counts['flash_attention_tc']} times, want {want_k7} ({qwen.n_layers} + "
          f"{moe.n_layers} layers)")
    others = {k: v for k, v in counts.items() if v and k != "flash_attention_tc"}
    check(not others, f"mesh path launched other kernels: {others}")
    fullest = max(n for n, _ in traces)
    for n_events, k7_seen in traces:
        check(k7_seen == qwen.n_layers if n_events == fullest else k7_seen <= qwen.n_layers,
              f"{MODEL_ARCH} on the mesh: the profiler saw {k7_seen} K7 records in a forward of "
              f"{n_events} device records (fullest {fullest}), want {qwen.n_layers}")
    mesh_s = time.perf_counter() - t_phase
    print(f"  mesh path (one-rank NCCL mesh 1x1 data/model, parameters placed by the rules, "
          f"activation_sharding): {MODEL_ARCH} bf16 forward(last_only) B={MODEL_BATCH} "
          f"S={MODEL_SEQ} equal to phase 6's bit for bit, {q_ms:.1f} ms the first call, "
          f"{q_warm_ms:.1f} ms warm (phase 6 unsharded: {model['wall_ms']['forward_warm']:.1f} ms "
          f"warm), K7 records in three traces {[k for _, k in traces]} (device records "
          f"{[n for n, _ in traces]}); {MESH_MOE_ARCH} ({moe.n_layers} of 32 layers, bf16, "
          f"B={MESH_MOE_BATCH} S={MESH_MOE_SEQ}) sharded MoE dispatch equal to the single-device "
          f"branch bit for bit: {m_ms:.1f} ms on the mesh, {m_plain_ms:.1f} ms single-device "
          f"(deterministic algorithms), relative L2 {m_route_rel:.3e} from the torch route "
          f"(within {MODEL_BF16_REL}); launches {counts} ({mesh_s:.1f} s) | {smi}", flush=True)
    del q_params, m_params, m_tree, q_logits, m_logits, q_full, m_full, m_plain, m_torch, want
    torch.cuda.empty_cache()
    dryrun = dryrun_check(smi=smi, training=training)
    print(f"mesh path launches {counts} ({time.perf_counter() - t_phase:.1f} s)", flush=True)
    return {"launches": counts, "wall_ms": {"qwen_forward": q_ms, "qwen_forward_warm": q_warm_ms,
                                            "moe_forward": m_ms, "moe_single_device": m_plain_ms},
            "dryrun": dryrun}


def dryrun_check(*, smi, training) -> dict:
    """Phase 8 (c), (d) and (e): the dry run of DRYRUN_CELLS in subprocesses
    (status "ok", rank 0's placed argument bytes equal to the JAX
    package's shard bytes, collectives counted, an all-to-all in a MoE
    cell), phase 7's step through the same counters beside its measured
    time and memory, and the reduced matrix (every cell "ok"), all four
    subprocesses and the matrix's run together."""
    import os
    import tempfile

    from repro_torch.configs.registry import get_arch

    gb = 1024 ** 3
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("REPRO_TORCH_DRYRUN_DEVICES", None)
    records = {}
    with tempfile.TemporaryDirectory(prefix="dryrun_smoke_") as tmp:
        t0 = time.perf_counter()
        procs = {(arch, shape, pod): subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape,
             "--out", tmp] + (["--multi-pod"] if pod else []),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=ROOT)
            for arch, shape, pod in DRYRUN_CELLS}
        phase7 = subprocess.Popen(
            [sys.executable, "-c", DRYRUN_PHASE7, str(TRAIN_LAYERS), str(TRAIN_BATCH),
             str(TRAIN_SEQ), repr(PHASE7_PEAK_FLOPS)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=ROOT)
        matrix_proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--reduced-matrix"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=ROOT)
        for cell, proc in procs.items():
            out, err = proc.communicate(timeout=DRYRUN_TIMEOUT_S)
            check(proc.returncode == 0, f"dry run {cell}: exit {proc.returncode}: {out[-2000:]} "
                  f"{err[-3000:]}")
            arch, shape, pod = cell
            name = f"{arch}__{shape}__{'2x16x16' if pod else '16x16'}.json"
            records[cell] = json.loads((Path(tmp) / name).read_text())
        p7_out, p7_err = phase7.communicate(timeout=DRYRUN_TIMEOUT_S)
        check(phase7.returncode == 0, f"phase 7's step through the counters: {p7_err[-3000:]}")
        dry_s = time.perf_counter() - t0
        m_out, m_err = matrix_proc.communicate(timeout=DRYRUN_TIMEOUT_S)
        matrix_s = time.perf_counter() - t0
        check(bool(m_out.strip()), f"the reduced matrix printed nothing: {m_err[-3000:]}")
        matrix = json.loads(m_out.strip().splitlines()[-1])

    # (e) the reduced matrix on this machine's torch
    import torch

    failed = {cell: rec for cell, rec in matrix.items() if rec["status"] != "ok"}
    for cell, rec in matrix.items():
        print(f"  reduced matrix {cell}: {rec['status'][:200]}"
              + (f" ({rec['seconds']:.2f} s)" if rec["status"] == "ok" else ""), flush=True)
    for cell, rec in failed.items():
        print(f"  reduced matrix {cell} traceback:\n{rec['traceback']}", file=sys.stderr, flush=True)
    check(len(matrix) == 30 and not failed, f"reduced matrix on torch {torch.__version__}: "
          f"{len(failed)} of {len(matrix)} cells did not trace: {sorted(failed)}")
    print(f"  reduced matrix (10 archs x train, prefill, decode, 8-rank (4, 2) fake mesh, torch "
          f"{torch.__version__}): all {len(matrix)} cells traced, {matrix_s:.1f} s beside the "
          f"other dry runs", flush=True)

    for (arch, shape, pod), rec in records.items():
        check(rec["status"] == "ok", f"dry run {arch} {shape}: {rec.get('error')}")
        want_bytes = DRYRUN_CELLS[arch, shape, pod]
        check(rec["memory"]["argument_size_in_bytes"] == want_bytes, f"dry run {arch} {shape}: "
              f"argument bytes {rec['memory']['argument_size_in_bytes']} against the JAX "
              f"package's shard bytes {want_bytes}")
        check(rec["collectives"]["total_count"] > 0, f"dry run {arch} {shape}: no collective")
        if get_arch(arch).num_experts:
            check(rec["collectives"]["count_by_op"].get("all-to-all", 0) > 0,
                  f"dry run {arch} {shape}: the MoE cell made no all-to-all")
        r, m = rec["roofline"], rec["memory"]
        print(f"  dry run {arch} {shape} {rec['mesh']} ({rec['chips']} fake ranks, traced in "
              f"{rec['compile_s']:.1f} s: stages {rec['traced_stages']} in {rec['trace_s']} s): "
              f"H100 roofline t_compute {r['t_compute_s']:.4e} s, t_memory {r['t_memory_s']:.4e} s, "
              f"t_collective {r['t_collective_s']:.4e} s, dominant {r['dominant']}, fraction "
              f"{r['roofline_fraction']:.4f}; per device: FLOPs {r['flops_per_device']:.4e}, bytes "
              f"{r['bytes_per_device']:.4e}, collective bytes {r['coll_bytes_per_device']:.4e} in "
              f"{rec['collectives']['count_by_op']}; arguments {m['argument_size_in_bytes']:,} B "
              f"(rank 0's blocks, equal to the JAX package's shard sum), outputs "
              f"{m['output_size_in_bytes']:,} B, aliased {m['alias_size_in_bytes']:,} B, temp "
              f"{m['temp_size_in_bytes']:,} B", flush=True)

    # (d) phase 7's step through the same counters, beside its measured step
    p7 = json.loads(p7_out.strip().splitlines()[-1])
    c, r = p7["counts"], p7["roofline"]
    step_ms = statistics.median(training["step_ms"][1:])
    est_peak = c["argument_size_in_bytes"] + c["temp_size_in_bytes"]
    print(f"  phase 7's step ({MODEL_ARCH}, {TRAIN_LAYERS} layers, f32, B={TRAIN_BATCH} "
          f"S={TRAIN_SEQ}) through the dry run's counters on a one-rank fake mesh (traced in "
          f"{[round(s, 2) for s in p7['trace_s']]} s): counted FLOPs {c['flops']:.4e} beside "
          f"6*N*D {p7['six_nd']:.4e} ({c['flops'] / p7['six_nd']:.3f}x); roofline at the f32 rate "
          f"{PHASE7_PEAK_FLOPS / 1e12:.0f} TFLOP/s: t_compute {r['t_compute_s'] * 1e3:.1f} ms, "
          f"t_memory {r['t_memory_s'] * 1e3:.1f} ms (eager bytes {c['bytes_accessed']:.4e}), "
          f"bound {max(r['t_compute_s'], r['t_memory_s']) * 1e3:.1f} ms ({r['dominant']}) beside "
          f"the measured step {step_ms:.1f} ms (phase 7, this run); peak estimate (arguments + "
          f"temp) {est_peak / gb:.2f} GiB beside the measured {training['peak_bytes'] / gb:.2f} "
          f"GiB | {smi}", flush=True)
    print(f"dry runs and phase 7's counters: {dry_s:.1f} s", flush=True)
    return {f"{a}/{s}" + ("/multi-pod" if p else ""): rec["roofline"]
            for (a, s, p), rec in records.items()}


def main() -> None:
    import os

    # Phase 7's crash-and-restart check runs under deterministic algorithms,
    # which need cuBLAS's workspace fixed before CUDA starts (this is the
    # size PyTorch gives it on Hopper anyway).
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check runs on a CUDA card")
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"{ROOT / 'src' / 'repro_torch'} not found: run from a checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))

    import numpy as np

    from repro_torch.core import pipeline
    from repro_torch.core.design_space import (
        DesignSpace,
        evaluate_design_space,
        evaluate_layout_design_space,
        sweep_bus_power,
    )
    from repro_torch.core.energy import (
        average_comparison,
        calibration_split_arr,
        compare_sym_asym,
    )
    from repro_torch.core.floorplan import (
        BusActivity,
        SystolicArrayGeometry,
        bus_power_arr,
        optimal_aspect_power,
    )
    from repro_torch.core.optimize import _power_shape, os_dataflow_geometry
    from repro_torch.core.pipeline import BatchStats, ProfileJob
    from repro_torch.core.quant import quantize_symmetric
    from repro_torch.core.switching import clear_profile_cache, combine_profiles, profile_gemm
    from repro_torch.core.workloads import (
        RESNET50_TABLE1,
        conv_layer_job,
        conv_to_gemm,
        measured_design_activities,
        measured_design_lane_activities,
        profile_conv_layer,
        profile_network,
        synth_activations,
        synth_weights,
    )
    from repro_torch.kernels import _build
    from repro_torch.kernels.activity_profile import kernel as K
    from repro_torch.kernels.activity_profile import ops as AP
    from repro_torch.kernels.activity_profile.ref import profile_gemm_toggles_ref
    from repro_torch.kernels.bitops import bus_mask
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention import kernel as FA
    from repro_torch.kernels.toggle_count import (
        stream_activity,
        stream_toggle_count,
        stream_toggle_count_i64,
    )
    from repro_torch.kernels.toggle_count import kernel as TC
    from repro_torch.kernels.ws_matmul import kernel as WM
    from repro_torch.kernels.ws_matmul import ws_matmul
    from repro_torch.kernels.ws_matmul.ref import wrap_int32

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    # The plain versions' f32 products run in full f32 (PyTorch's default,
    # set here so that no environment changes it).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # -- phase 1: the card and the build ------------------------------------
    smi = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {smi} | torch {torch.__version__} cuda {torch.version.cuda} | {kind}", flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.split()[0])
    int_ops_per_s = INT_OPS_PER_CLOCK_SM * sms * clock_mhz * 1e6
    popc_per_s = POPC_PER_CLOCK_SM * sms * clock_mhz * 1e6
    print(f"integer rates: {sms} SMs at {clock_mhz:.0f} MHz (max SM clock): "
          f"{int_ops_per_s / 1e12:.3f} T 32-bit integer ops/s, {popc_per_s / 1e12:.3f} T popcounts/s")
    t0 = time.perf_counter()
    build_logs = _build.build()
    print(f"build: {time.perf_counter() - t0:.2f} s", flush=True)
    for name, log in build_logs.items():
        kernel = "?"
        for line in log.splitlines():
            found = re.search(r"Compiling entry function '(\S+)'", line)
            if found:
                kernel = found.group(1)
            elif "registers" in line or "spill" in line or "error" in line.lower():
                print(f"  nvcc[{name}] {kernel[:80]}: {line.strip()}")
                spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
                if spills and any(src == name and k in kernel for src, k in NO_SPILL):
                    check(spills.groups() == ("0", "0"), f"{kernel} spills: {line.strip()}")
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    for source in ("ws_matmul", "flash_attention"):
        sass = subprocess.run([cuobjdump, "-sass", str(_build._target(source)[1])],
                              capture_output=True, text=True, check=True, timeout=120).stdout
        for kernel, wanted in TC_SASS.items():
            parts = [part for part in sass.split("Function : ")[1:] if kernel in part.split()[0]]
            if not parts:
                continue
            counts = {op: sum(part.count(op) for part in parts) for op in ("HGMMA", "IGMMA")}
            counts["TF32"] = sum(len(re.findall(r"\bHGMMA\.\S*TF32", part)) for part in parts)
            print(f"  sass[{source}] {kernel}: {counts} over {len(parts)} instantiations")
            for op in wanted:
                check(counts[op] > 0, f"{kernel} holds no {op} instruction")
    for source, kernel in INT_SASS:
        sass = subprocess.run([cuobjdump, "-sass", str(_build._target(source)[1])],
                              capture_output=True, text=True, check=True, timeout=120).stdout
        parts = [part for part in sass.split("Function : ")[1:] if kernel in part.split()[0]]
        check(bool(parts), f"{kernel} not found in the SASS of {source}")
        for part in parts:
            counts = {op: len(re.findall(pattern, part)) for op, pattern in SASS_OPS.items()}
            print(f"  sass[{source}] {part.split()[0][:90]}: {counts}")
            check(counts["SHFL"] == 0, f"{kernel} holds shuffles")
            if kernel in WIDE_LOADS:
                check(counts["LDG.E.128"] > 0, f"{kernel} holds no 16-byte global load")

    # -- phase 2: kernels vs plain versions on the card ---------------------
    max_err = {name: 0 for name in KERNELS}

    def on_card(x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x, dtype=np.int32)).to(dev)

    def note(name, got, plain) -> None:
        err = max((abs(g - p) for g, p in zip(got, plain)), default=0)
        max_err[name] = max(max_err[name], err)

    def check_k1(a, w, rows, cols, b_h, b_v, what, small_case=False):
        """K1 vs its plain version (and, on a small case, vs the plain
        version in 7-step windows and the numpy oracle)."""
        a_t, w_t = on_card(a), on_card(w)
        got = K.ws_activity_toggles(a_t, w_t, rows, cols, b_h, b_v).tolist()
        plain = K.ws_activity_toggles_plain(a_t, w_t, rows, cols, b_h, b_v).tolist()
        note("ws_activity_toggles", got, plain)
        check(got == plain, f"K1 {what}: kernel {got} plain {plain}")
        if small_case:
            windows = K.ws_activity_toggles_plain(a_t, w_t, rows, cols, b_h, b_v, block_t=7).tolist()
            ref = list(profile_gemm_toggles_ref(a, w, rows, cols, b_h, b_v)[:2])
            check(got == windows == ref, f"K1 {what}: kernel {got} block_t=7 {windows} oracle {ref}")

    def check_k4(x, bits, what) -> int:
        """K4 vs its plain version, whole and in 5-step windows; it launches
        K5's kernel and counts on its own wrapper, not on K5's."""
        x_t = on_card(x)
        before = (K.operand_stream_toggles.launches, TC.stream_toggles.launches)
        got = int(K.operand_stream_toggles(x_t, bits).item())
        check((K.operand_stream_toggles.launches, TC.stream_toggles.launches)
              == (before[0] + (x_t.shape[0] > 1), before[1]),
              f"K4 {what}: launches counted on the wrong wrapper")
        plain = int(K.operand_stream_toggles_plain(x_t, bits).item())
        windows = int(K.operand_stream_toggles_plain(x_t, bits, block_t=5).item())
        note("operand_stream_toggles", [got], [plain])
        check(got == plain == windows, f"K4 {what}: kernel {got} plain {plain} block_t=5 {windows}")
        return got

    def check_k3(strips_t, bits, what) -> None:
        before = K.strip_toggles.launches
        got = K.strip_toggles(strips_t, bits).tolist()
        check(K.strip_toggles.launches == before + 1, f"K3 {what}: strip_toggles was not launched")
        plain = K.strip_toggles_plain(strips_t, bits).tolist()
        note("strip_toggles", got, plain)
        check(got == plain, f"K3 {what}: kernel and plain version differ")

    def check_k2(arrays, b_v, what, bad=()) -> None:
        """K2 vs its plain version; the tasks ``bad`` (and no other) have an
        out-of-range id and must read -1."""
        got = K.ws_task_toggles(*arrays, b_v).tolist()
        plain = K.ws_task_toggles_plain(*arrays, b_v).tolist()
        note("ws_task_toggles", got, plain)
        check(got == plain, f"K2 {what}: kernel and plain version differ")
        flagged = [i for i, x in enumerate(got) if x < 0]
        check(flagged == list(bad) and all(got[i] == -1 for i in bad),
              f"K2 {what}: tasks {flagged} flagged a bad index, expected {list(bad)}")

    def check_k5(x_t, bits, what) -> int:
        got = int(TC.stream_toggles(x_t, bits).item())
        plain = int(TC.stream_toggles_plain(x_t, bits).item())
        note("stream_toggles", [got], [plain])
        check(got == plain, f"K5 {what} bits={bits}: kernel {got} plain {plain}")
        return got

    def check_k6(a_t, w_t, what) -> torch.Tensor:
        """K6 on the route of its type and shape vs its plain version:
        integers bit for bit; floats within GEMM_REL_TOL * (|a| @ |w|)
        where the plain version is finite, and inf and NaN where it has
        them."""
        route = WM.gemm_route(a_t.dtype, *a_t.shape, w_t.shape[1])
        name, attr = ("ws_gemm_tc", "tc_launches") if route == "tc" else ("ws_gemm_tf32", "tf32_launches")
        what = f"{what} on the {route} route"
        before = getattr(WM.ws_gemm, attr)
        got = WM.ws_gemm(a_t, w_t)
        check(getattr(WM.ws_gemm, attr) == before + 1, f"K6 {what}: {name} was not launched")
        plain = WM.ws_gemm_plain(a_t, w_t)
        if got.numel() == 0:
            return got
        if a_t.dtype.is_floating_point:
            finite = torch.isfinite(plain)
            err = (got - plain).abs()[finite]
            within = err <= GEMM_REL_TOL * (a_t.float().abs() @ w_t.float().abs())[finite]
            ok = (torch.equal(torch.isfinite(got), finite) and bool(within.all())
                  and torch.equal(got[~finite].nan_to_num(), plain[~finite].nan_to_num()))
            if err.numel() == 0:
                err = torch.zeros(1, device=dev)
        else:
            err = (got.long() - plain.long()).abs()
            ok = torch.equal(got, plain)
        max_err[name] = max(max_err[name], err.max().item())
        check(ok, f"K6 {what}: max |kernel - plain| {err.max().item()!r}")
        return got

    def check_planes(a_t, w_t, what) -> None:
        """The prep kernel vs its plain version, bit for bit (f32 planes as
        int32, so that NaN compares too)."""
        got = WM.gemm_operand_planes(a_t, w_t)
        for g, p in zip(got, WM.gemm_operand_planes_plain(a_t, w_t)):
            if g.dtype == torch.float32:
                g, p = g.view(torch.int32), p.view(torch.int32)
            check(torch.equal(g, p), f"gemm_operand_planes {what}: kernel and plain version differ")

    def check_k7(q, k, v, causal, window, what) -> torch.Tensor:
        """K7 on the route of its type (bf16: "tc", f32: "tf32", both on the
        tensor cores) vs its plain version, within F32_TOL (f32) or
        BF16_RTOL and BF16_ATOL (bf16) of the plain output, elementwise."""
        tc = FA.attention_route(q.dtype) == "tc"
        name, attr = ("flash_attention_tc", "tc_launches") if tc else ("flash_attention_tf32", "tf32_launches")
        before = getattr(FA.flash_attention_fwd, attr)
        got = FA.flash_attention_fwd(q, k, v, causal=causal, window=window)
        check(getattr(FA.flash_attention_fwd, attr) == before + 1, f"K7 {what}: {name} was not launched")
        plain = FA.flash_attention_fwd_plain(q, k, v, causal=causal, window=window)
        rtol, atol = (F32_TOL, F32_TOL) if q.dtype == torch.float32 else (BF16_RTOL, BF16_ATOL)
        g, p = got.float(), plain.float()
        err = (g - p).abs()
        ok = bool(torch.isfinite(g).all()) and bool((err <= atol + rtol * p.abs()).all())
        max_err[name] = max(max_err[name], err.max().item())
        check(ok, f"K7 {what}: max |kernel - plain| {err.max().item()!r} beyond rtol {rtol} "
                  f"atol {atol}")
        return got

    def check_attention_planes(k, v, what) -> None:
        """K7's prep kernel vs its plain version, bit for bit (as int32)."""
        got = FA.attention_operand_planes(k, v)
        for g, p in zip(got, FA.attention_operand_planes_plain(k, v)):
            check(g.shape == p.shape and torch.equal(g.view(torch.int32), p.view(torch.int32)),
                  f"attention_operand_planes {what}: kernel and plain version differ")

    def stacked(jobs):
        """The WS buckets and OS stream buckets the port's scheduler builds
        for ``jobs``, grouped by shape class as ``run_profile_batch`` does,
        as arrays on the card."""
        order: dict[tuple, list[int]] = {}
        for i, job in enumerate(jobs):
            order.setdefault(pipeline._bucket_key(job), []).append(i)
        bucket_map, buckets, pass_map = {}, [], {}
        stream_map, stream_buckets, stream_pass_map = {}, [], {}
        stats = BatchStats()
        for members in order.values():
            t_trim = max(-(-jobs[i].gemm_shape()[0] // 8) * 8 for i in members)
            for i in members:
                job = jobs[i]
                a, w = job.operands()
                if job.dataflow == "OS":
                    pipeline._schedule_os_job(
                        job, a, w, stream_map, stream_buckets, stream_pass_map, stats
                    )
                else:
                    pipeline._schedule_job(job, a, w, t_trim, bucket_map, buckets, pass_map, stats)
        ws = [
            (b, tuple(on_card(np.asarray(x)) for x in (
                np.stack(b.strips), np.stack(b.w_tiles), b.strip_ids, b.w_ids, b.valid_r)))
            for b in buckets
        ]
        os_ = [(b, on_card(np.stack(b.strips))) for b in stream_buckets]
        return ws, os_

    rng = np.random.default_rng(0)
    for case in CASES:
        m, k, n, rows, cols, b_h, b_v = case
        a = rng.integers(-32767, 32768, size=(m, k))
        w = rng.integers(-32767, 32768, size=(k, n))
        check_k1(a, w, rows, cols, b_h, b_v, f"case {case}", small_case=True)
    a = np.full((64, 32), 32767, dtype=np.int64)
    a[::2] = -32767
    w = np.full((32, 8), 32767, dtype=np.int64)
    w[:, ::2] = -32767
    check_k1(a, w, 32, 8, 16, 37, "37-bit extremes", small_case=True)
    extremes = np.array([-32768, -32767, 32767])
    for case in K1_EDGE_CASES:
        m, k, n, rows, cols, b_h, b_v = case
        a, w = (np.where(rng.random(shape) < 0.5, rng.choice(extremes, shape),
                         rng.integers(-32768, 32768, size=shape)) for shape in ((m, k), (k, n)))
        check_k1(a, w, rows, cols, b_h, b_v, f"edge case {case}", small_case=True)
    for case in OS_CASES:
        m, k, n, rows, cols, b_h, b_v = case
        a = rng.integers(-32767, 32768, size=(m, k))
        w = rng.integers(-32767, 32768, size=(k, n))
        h_ref, v_ref, _, _ = profile_gemm_toggles_ref(a, w, rows, cols, b_h, b_v, dataflow="OS")
        n_tiles, m_tiles = -(-n // cols), -(-m // rows)
        got_h = check_k4(a.T, b_h, f"OS case {case} A stream") * n_tiles
        got_v = check_k4(w, b_v, f"OS case {case} W stream") * m_tiles
        check((got_h, got_v) == (h_ref, v_ref),
              f"K4 OS case {case}: {(got_h, got_v)} oracle {(h_ref, v_ref)}")

    ragged_jobs = []
    for dataflow, cases in (("WS", RAGGED), ("OS", OS_RAGGED)):
        for m, k, n, rows, cols, b_h, b_v in cases:
            a = rng.integers(-32767, 32768, size=(m, k))
            w = rng.integers(-32767, 32768, size=(k, n))
            ragged_jobs.append(
                ProfileJob(rows=rows, cols=cols, b_h=b_h, b_v=b_v, a=a, w=w, dataflow=dataflow)
            )
    for t_seg, rows, cols, b_v in K2_EDGE_CASES:
        # 40 tasks over 7 strips and 5 tiles: task 0 has valid_r 0, task 1
        # the full rows, task 2 half of them; tasks 3 and 4 a bad strip and
        # a bad tile id
        strips_np = np.where(rng.random((7, t_seg + 1, rows)) < 0.5,
                             rng.choice(extremes, (7, t_seg + 1, rows)),
                             rng.integers(-32768, 32768, size=(7, t_seg + 1, rows)))
        tiles_np = np.where(rng.random((5, rows, cols)) < 0.5, rng.choice(extremes, (5, rows, cols)),
                            rng.integers(-32768, 32768, size=(5, rows, cols)))
        ids, wids, vr = rng.integers(0, 7, 40), rng.integers(0, 5, 40), rng.integers(0, rows + 1, 40)
        vr[:3] = 0, rows, rows // 2
        ids[3], wids[4] = 7, -1
        arrays = tuple(on_card(x) for x in (strips_np, tiles_np, ids, wids, vr))
        check_k2(arrays, b_v, f"edge bucket t_seg={t_seg} rows={rows} cols={cols} b_v={b_v}",
                 bad=(3, 4))
        check(K.ws_task_toggles(*arrays, b_v)[0].item() == 0, "K2: a task with valid_r 0 counts")
    ws_buckets, os_buckets = stacked(ragged_jobs)
    for b, arrays in ws_buckets:
        what = f"ragged bucket {b.rows}x{b.cols} b_h={b.b_h} b_v={b.b_v} t_seg={b.t_seg}"
        check_k2(arrays, b.b_v, what)
        check_k3(arrays[0], b.b_h, what)
    for b, strips_t in os_buckets:
        check_k3(strips_t, b.bits, f"ragged OS stream bucket bits={b.bits} t_seg={b.t_seg}")
    for shape in K3_EDGE_CASES:
        for offset in (0, 1):
            flat = on_card(rng.integers(-32768, 32768, size=int(np.prod(shape)) + offset))
            strips_t = flat[offset:].view(shape)
            for bits in (1, 16, 33, 64):
                check_k3(strips_t, bits, f"edge strips {shape} offset {offset} bits={bits}")

    operands = []
    table1_jobs = {
        dataflow: [conv_layer_job(layer, seed=i, dataflow=dataflow)
                   for i, layer in enumerate(RESNET50_TABLE1)]
        for dataflow in ("WS", "OS")
    }
    for job, layer in zip(table1_jobs["WS"], RESNET50_TABLE1):
        a, w = job.operands()
        operands.append((layer.name, a, w))
        check_k1(a, w, 32, 32, 16, 37, f"{layer.name} WS")
        check_k4(a.T, 16, f"{layer.name} OS A stream")
        check_k4(w, 16, f"{layer.name} OS W stream")
    ((_, ws_arrays),), _ = stacked(table1_jobs["WS"])
    _, ((_, os_strips),) = stacked(table1_jobs["OS"])
    check_k2(ws_arrays, 37, "Table-I WS bucket")
    check_k3(ws_arrays[0], 16, "Table-I WS strips")
    check_k3(os_strips, 16, "Table-I OS stream strips")
    print(f"Table-I buckets: WS {ws_arrays[2].shape[0]} tasks over strips "
          f"{tuple(ws_arrays[0].shape)} and tiles {tuple(ws_arrays[1].shape)}; "
          f"OS strips {tuple(os_strips.shape)}")
    print(f"kernels vs plain versions: equal on "
          f"{len(CASES) + 1 + len(K1_EDGE_CASES) + len(RESNET50_TABLE1)} WS and "
          f"{2 * (len(OS_CASES) + len(RESNET50_TABLE1))} OS per-GEMM inputs, "
          f"{len(ws_buckets) + 1} WS buckets and {len(os_buckets) + 1} OS stream buckets, "
          f"K3 also on {2 * len(K3_EDGE_CASES)} edge strip stacks at 4 bus widths",
          flush=True)

    # K5, K6 and K7 at the reference's test shapes (tests/test_kernels.py),
    # plus the saturating int16 GEMM that wraps the 32-bit accumulator.
    for shape in TOGGLE_SHAPES:
        x32 = on_card(rng.integers(-(2**31), 2**31, size=shape))
        for bits in (8, 16, 32, 37, 48, 64):
            check_k5(x32, bits, f"int32 {shape}")
    for shape in ((40, 3), (257, 129)):
        x64 = torch.from_numpy(rng.integers(-(2**62), 2**62, size=shape)).to(dev)
        for bits in (8, 16, 32, 37, 48, 64):
            check_k5(x64, bits, f"int64 {shape}")
    for (t_len, lanes), offset in K5_EDGE_CASES:
        for dtype, hi in ((torch.int32, 2**31), (torch.int64, 2**62)):
            flat = torch.from_numpy(rng.integers(-hi, hi, size=t_len * lanes + offset)).to(dtype)
            x_t = flat.to(dev)[offset:].view(t_len, lanes)
            for bits in (16, 37, 64):
                check_k5(x_t, bits, f"{dtype} {(t_len, lanes)} offset {offset}")
    x32 = on_card(rng.integers(-(2**31), 2**31, size=(300, 129)))
    for bits in range(33, 65):
        check_k5(x32, bits, "int32 (300, 129) on a wide bus")
    # Integers on the tensor cores, through the planes, whose prep kernel is
    # held against its plain version too.
    for m, k, n in GEMM_SHAPES:
        for dtype in (torch.int8, torch.int16):
            info = torch.iinfo(dtype)
            a_t = torch.from_numpy(rng.integers(info.min, info.max + 1, size=(m, k))).to(dtype).to(dev)
            w_t = torch.from_numpy(rng.integers(info.min, info.max + 1, size=(k, n))).to(dtype).to(dev)
            check_planes(a_t, w_t, f"{dtype} {(m, k, n)}")
            check_k6(a_t, w_t, f"{dtype} {(m, k, n)}")
    sat_a = torch.full((130, 260), 32767, dtype=torch.int16)
    sat_a[::3] = -32767
    sat_w = torch.from_numpy(rng.choice([-32767, 32767], size=(260, 129))).to(torch.int16)
    exact = sat_a.long() @ sat_w.long()
    wrapped = check_k6(sat_a.to(dev), sat_w.to(dev), "saturating int16 (130, 260, 129)").cpu()
    check(exact.abs().max() > 2**31 and torch.equal(wrapped, wrap_int32(exact)),
          "K6: the saturating int16 GEMM does not wrap mod 2^32")
    # Floats: f32 and bf16 with K or N not a multiple of 8 on the "tf32"
    # route, the other bf16 shapes on the "tc" route; the "tf32" route also
    # at ragged shapes, on views at an offset of one element (data_ptr not
    # 16-byte aligned), near f32's largest value and with inf and NaN
    # entries. Its planes are held against their plain version too.
    float_routes = {"tc": 0, "tf32": 0}
    for m, k, n in FLOAT_GEMM_SHAPES + TC_GEMM_SHAPES + TF32_GEMM_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            a_t = torch.from_numpy(rng.normal(size=(m, k))).to(dtype).to(dev)
            w_t = torch.from_numpy(rng.normal(size=(k, n))).to(dtype).to(dev)
            check_k6(a_t, w_t, f"{dtype} {(m, k, n)}")
            float_routes[WM.gemm_route(dtype, m, k, n)] += 1
            if (m, k, n) in TF32_GEMM_SHAPES:
                check_planes(a_t, w_t, f"{dtype} {(m, k, n)}")
    for dtype in (torch.float32, torch.bfloat16):
        for m, k, n in ((130, 33, 129), (64, 64, 64)):
            flat_a = torch.from_numpy(rng.normal(size=m * k + 1)).to(dtype).to(dev)
            flat_w = torch.from_numpy(rng.normal(size=k * n + 1)).to(dtype).to(dev)
            a_t, w_t = flat_a[1:].view(m, k), flat_w[1:].view(k, n)
            check(a_t.data_ptr() % 16 != 0, "K6: the offset view is 16-byte aligned")
            check_k6(a_t, w_t, f"{dtype} {(m, k, n)} offset view")
            float_routes[WM.gemm_route(dtype, m, k, n)] += 1
    big = torch.from_numpy(F32_MAX * rng.uniform(0.5, 1.0, size=(130, 40))).float()
    big[:, 0] = F32_MAX
    big[::2] *= -1
    small = torch.from_numpy(rng.normal(size=(40, 129)) * 2.0**-20).float()
    check_planes(big.to(dev), small.to(dev), "f32 near the largest value")
    check_k6(big.to(dev), small.to(dev), "f32 (130, 40, 129) near the largest value")
    float_routes["tf32"] += 1
    for dtype in (torch.float32, torch.bfloat16):
        a = torch.from_numpy(rng.normal(size=(70, 33))).float()
        w = torch.from_numpy(rng.normal(size=(33, 40))).float()
        w[:, :4] = torch.round(w[:, :4])  # values that TF32 holds exactly, and zeros
        a[3, 5], a[7, 0], a[9, 9] = float("inf"), float("-inf"), float("nan")
        w[11, 6], w[2, 7] = float("inf"), float("-inf")
        a_t, w_t = a.to(dtype).to(dev), w.to(dtype).to(dev)
        check_planes(a_t, w_t, f"{dtype} with inf and NaN")
        got = check_k6(a_t, w_t, f"{dtype} (70, 33, 40) with inf and NaN")
        check(bool(got.isnan().any()) and bool(got.isinf().any()),
              f"K6 {dtype} with inf and NaN: no inf or no NaN in the result")
        float_routes["tf32"] += 1
    for b, h, kv, s_len, d, causal, window in ATTENTION_SMALL:
        q, k_, v = (torch.from_numpy(rng.normal(size=(b, heads, s_len, d))).float().to(dev)
                    for heads in (h, kv, kv))
        check_attention_planes(k_, v, f"{(b, kv, s_len, d)}")
        check_k7(q, k_, v, causal, window, f"f32 {(b, h, kv, s_len, d)} causal={causal} window={window}")
    # f32 on views at an offset of one element (data_ptr not 16-byte
    # aligned), and the prep on inf, NaN and values near f32's largest.
    for d in (32, 128):
        q, k_, v = (torch.from_numpy(rng.normal(size=heads * 150 * d + 1)).float().to(dev)[1:]
                    .view(1, heads, 150, d) for heads in (4, 2, 2))
        check(q.data_ptr() % 16 != 0, "K7: the offset view is 16-byte aligned")
        check_k7(q, k_, v, True, 60, f"f32 (1, 4, 2, 150, {d}) offset view")
    k_, v = (torch.from_numpy(rng.normal(size=(1, 2, 70, 64)) * 2.0 ** rng.integers(-40, 40, size=(1, 2, 70, 64)))
             .float() for _ in range(2))
    k_[0, 0, 0, 0], v[0, 1, 69, 63], k_[0, 1, 3, 5] = float("inf"), float("nan"), -F32_MAX
    check_attention_planes(k_.to(dev), v.to(dev), "with inf, NaN and -F32_MAX")
    for b, h, kv, s_len, d, causal, window in ATTENTION_BF16:
        q, k_, v = (torch.from_numpy(rng.normal(size=(b, heads, s_len, d))).to(torch.bfloat16).to(dev)
                    for heads in (h, kv, kv))
        got = check_k7(q, k_, v, causal, window,
                       f"bf16 {(b, h, kv, s_len, d)} causal={causal} window={window}")
        check(window != 0 or not got.any(), "K7 bf16: a row that sees no key is not 0")
    print(f"kernel library vs plain versions: K5 on {len(TOGGLE_SHAPES) + 2} streams at 6 bus "
          f"widths, {2 * len(K5_EDGE_CASES)} edge streams at 3 and one int32 stream at 32 "
          f"(equal), K6 on {2 * len(GEMM_SHAPES) + 1} integer GEMMs on the tensor cores "
          f"(equal, one wrapping; the planes equal too) and float GEMMs, {float_routes['tc']} "
          f"on the tc route and {float_routes['tf32']} on the tf32 route (within "
          f"{GEMM_REL_TOL} * |a| @ |w|, inf and NaN as the plain version; planes equal), K7 on "
          f"{len(ATTENTION_SMALL) + 2} f32 cases on the tf32 route (within {F32_TOL}; planes "
          f"equal) and {len(ATTENTION_BF16)} bf16 cases on the tc route (within "
          f"rtol {BF16_RTOL}, atol {BF16_ATOL})", flush=True)

    # -- phase 3: the main paths ---------------------------------------------
    ref = json.loads((ROOT / "src" / "repro_torch" / "data" / "table1_reference.json").read_text())
    geoms = {
        "WS": SystolicArrayGeometry.paper_32x32(),
        "OS": os_dataflow_geometry(16, 32, 32),
    }

    def check_profiles(path, dataflow, profiles):
        for layer, p, want in zip(RESNET50_TABLE1, profiles, ref["layers"]):
            counts = [
                round(p.a_h * p.h_transitions * p.b_h),
                round(p.a_v * p.v_transitions * p.b_v),
                p.h_transitions,
                p.v_transitions,
            ]
            print(f"  {path} {dataflow} {layer.name}: a_h={p.a_h!r} a_v={p.a_v!r} counts={counts}")
            check(counts == want[dataflow]["counts"],
                  f"{path} {dataflow} {layer.name}: counts {counts} "
                  f"reference {want[dataflow]['counts']}")
            check(p.as_dict() == want[dataflow]["profile"],
                  f"{path} {dataflow} {layer.name}: profile {p.as_dict()} "
                  f"reference {want[dataflow]['profile']}")
            if dataflow == "WS":
                check(p.a_v > p.a_h, f"{path} WS {layer.name}: a_v <= a_h")
        geom = geoms[dataflow]
        avg = combine_profiles(profiles)
        design = avg.as_bus_activity()
        aspect = optimal_aspect_power(geom, design)
        comps = [compare_sym_asym(geom, p.as_bus_activity(), design_act=design) for p in profiles]
        agg = average_comparison(comps)
        want = ref["verdict"][dataflow]
        pairs = [("aspect_opt", aspect, want["aspect_opt"])]
        pairs += [(f"average.{key}", agg[key], want["average"][key]) for key in want["average"]]
        pairs += [(f"average_profile.{key}", getattr(avg, key), want["average_profile"][key])
                  for key in ("a_h", "a_v", "input_zero_fraction")]
        for i, (c, w_l) in enumerate(zip(comps, want["per_layer"])):
            pairs += [(f"L{i + 1}.{key}", getattr(c, key), w_l[key]) for key in w_l]
        for what, got, exp in pairs:
            check(np.isfinite(got) and rel_close(got, exp),
                  f"{path} {dataflow} {what}: {got!r} reference {exp!r}")
        if dataflow == "WS":
            check(agg["interconnect_saving"] > 0 and agg["total_saving"] > 0,
                  f"{path}: the WS asymmetric floorplan saves nothing")
        print(f"{path} {dataflow} verdict: W/H*={aspect!r} interconnect saving="
              f"{agg['interconnect_saving']!r} total saving={agg['total_saving']!r} "
              f"({len(pairs)} floats within {REL_TOL} of the reference)", flush=True)

    def per_gemm_path(dataflow):
        return [
            profile_conv_layer(layer, seed=i, backend="auto", dataflow=dataflow)
            for i, layer in enumerate(RESNET50_TABLE1)
        ]

    def batched_path(dataflow):
        return profile_network(RESNET50_TABLE1, dataflow=dataflow, backend="auto",
                               return_stats=True)

    launches = {}
    main_ms = {}
    for path, expected in (("per-GEMM", ("ws_activity_toggles", "operand_stream_toggles")),
                           ("batched", ("ws_task_toggles", "strip_toggles"))):
        clear_profile_cache()
        reset_counts()
        for dataflow in ("WS", "OS"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if path == "per-GEMM":
                profiles = per_gemm_path(dataflow)
            else:
                profiles, stats = batched_path(dataflow)
            torch.cuda.synchronize()
            main_ms[path, dataflow] = (time.perf_counter() - t0) * 1e3
            check_profiles(path, dataflow, profiles)
            if path == "batched":
                got = {key: getattr(stats, key) for key in BATCH_STATS_FIELDS}
                print(f"  batched {dataflow} scheduler: {got}")
                check(got == ref["batch_stats"][dataflow],
                      f"batched {dataflow}: stats {got} reference {ref['batch_stats'][dataflow]}")
                check(stats.serial_fallbacks == stats.degraded == stats.skipped == 0
                      and not stats.failure_report,
                      f"batched {dataflow}: fallbacks or failures {stats.as_dict()}")
        counts = read_counts()
        print(f"{path} path: WS {main_ms[path, 'WS']:.1f} ms, OS {main_ms[path, 'OS']:.1f} ms; "
              f"launches {counts}", flush=True)
        for name in expected:
            check(counts[name] > 0, f"{name} was not launched on the {path} path")
            launches[name] = counts[name]

    # -- phase 3b: the kernel library's path -----------------------------------
    # Inputs are set up first: the Table-I operands at int16 (as above) and
    # int8 (the same seeded floats, quantized to 8 bits), and seeded bf16
    # activations, weights and attention inputs made on the card.
    lib_layers = []
    for i, ((name, a, w), layer, want) in enumerate(zip(operands, RESNET50_TABLE1, ref["layers"])):
        g = conv_to_gemm(layer)
        a8 = quantize_symmetric(synth_activations(g.m, g.k, layer.input_density, seed=i), 8).values
        w8 = quantize_symmetric(synth_weights(g.k, g.n, seed=i + 1), 8).values
        lib_layers.append((name, a, w, a8, w8, want))
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def randn_bf16(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(torch.bfloat16)

    mlp_x = randn_bf16(MLP_TOKENS, QWEN3_D_MODEL)
    mlp_w = randn_bf16(QWEN3_D_MODEL, QWEN3_D_FF, scale=QWEN3_D_MODEL ** -0.5)
    attn_inputs = [
        (case, s_len, window,
         randn_bf16(1, HEADS, s_len, HEAD_DIM), randn_bf16(1, KV_HEADS, s_len, HEAD_DIM),
         randn_bf16(1, KV_HEADS, s_len, HEAD_DIM))
        for case, s_len, window in ATTENTION_CASES
    ]
    rows = cols = 32

    def partial_sums(a_t, w_t):
        """(M, K, N) int64 WS partial sums: S[t, k, n] = sum of a[t, k'] *
        w[k', n] over k' <= k within k's tile of ``rows`` reduction rows."""
        m, k = a_t.shape
        n = w_t.shape[1]
        k_pad = -(-k // rows) * rows
        a64 = torch.nn.functional.pad(a_t.long(), (0, k_pad - k))
        w64 = torch.nn.functional.pad(w_t.long(), (0, 0, 0, k_pad - k))
        sums = (a64[:, :, None] * w64[None]).view(m, k_pad // rows, rows, n).cumsum(dim=2)
        return sums.view(m, k_pad, n)[:, :k]

    def library_path(checked: bool) -> None:
        """The kernel library's entry points at full width; with ``checked``,
        every result is held against the reference file or the plain
        version (which launch no kernel)."""
        for name, a, w, a8, w8, want in lib_layers:
            m, k = a.shape
            n = w.shape[1]
            n_tiles, m_tiles = -(-n // cols), -(-m // rows)
            a_t, w_t = on_card(a), on_card(w)
            at_t = a_t.t().contiguous()
            # K5: the operand streams (A is post-ReLU int16, so its 32-bit
            # words toggle as its 16-bit bus does; W is signed and is read
            # on the 16-bit bus).
            counts = {
                "WS": [n_tiles * stream_toggle_count(a_t)],
                "OS": [n_tiles * stream_toggle_count(at_t),
                       m_tiles * stream_toggle_count_i64(w_t.long() & bus_mask(16))],
            }
            acts = {
                ("WS", "a_h"): stream_activity(a_t, 16),
                ("OS", "a_h"): stream_activity(at_t, 16),
                ("OS", "a_v"): stream_activity(w_t, 16),
            }
            # K6 at int16 and int8
            a16, w16 = a_t.to(torch.int16), w_t.to(torch.int16)
            a8_t, w8_t = (torch.from_numpy(x.astype(np.int8)).to(dev) for x in (a8, w8))
            tc_before = WM.ws_gemm.tc_launches
            prod16 = ws_matmul(a16, w16)
            check(not checked or WM.ws_gemm.tc_launches == tc_before + 1,
                  f"K6 {name} int16 did not take the tensor cores")
            prod8 = ws_matmul(a8_t, w8_t)
            check(not checked or WM.ws_gemm.tc_launches == tc_before + 2,
                  f"K6 {name} int8 did not take the tensor cores")
            # K5 on the WS vertical bus: the (M, K*N) partial-sum stream
            sums = partial_sums(a_t, w_t)
            if checked:
                bottoms = [min(k0 + rows, k) - 1 for k0 in range(0, k, rows)]
                check(torch.equal(wrap_int32(sums[:, bottoms, :].sum(dim=1)), prod16),
                      f"K6 {name} int16: not the wrapped sum of the tiles' bottom partial sums")
            sums &= bus_mask(WS_BUS_BITS)
            stream = sums.reshape(m, k * n)
            counts["WS"].append(stream_toggle_count_i64(stream))
            acts["WS", "a_v"] = stream_activity(stream, WS_BUS_BITS)
            del sums, stream
            if not checked:
                continue
            for dataflow in ("WS", "OS"):
                check(counts[dataflow] == want[dataflow]["counts"][:2],
                      f"K5 {name} {dataflow}: recount {counts[dataflow]} reference "
                      f"{want[dataflow]['counts'][:2]}")
            for (dataflow, key), got in acts.items():
                check(got == want[dataflow]["profile"][key],
                      f"K5 {name} {dataflow} {key}: {got!r} reference "
                      f"{want[dataflow]['profile'][key]!r}")
            for got, x, y, bits in ((prod16, a16, w16, 16), (prod8, a8_t, w8_t, 8)):
                plain = WM.ws_gemm_plain(x, y)
                check(torch.equal(got, plain), f"K6 {name} int{bits}: kernel and plain version differ")
            print(f"  library {name}: K5 recount WS {counts['WS']} OS {counts['OS']} equal the "
                  f"reference; K6 {m}x{k}x{n} int16 and int8 equal the plain version")
        tc_before = WM.ws_gemm.tc_launches
        mlp_y = ws_matmul(mlp_x, mlp_w)
        check(not checked or WM.ws_gemm.tc_launches == tc_before + 1,
              "K6 bf16 MLP did not take the tensor cores")
        if checked:
            plain = WM.ws_gemm_plain(mlp_x, mlp_w)
            err = (mlp_y - plain).abs()
            bound = GEMM_REL_TOL * (mlp_x.float().abs() @ mlp_w.float().abs())
            check(bool(torch.isfinite(mlp_y).all()) and bool((err <= bound).all()),
                  f"K6 bf16 MLP: |kernel - plain| beyond {GEMM_REL_TOL} * |a| @ |w|")
            max_err["ws_gemm_tc"] = max(max_err["ws_gemm_tc"], err.max().item())
            print(f"  library Qwen3-8B MLP bf16 {tuple(mlp_x.shape)} @ {tuple(mlp_w.shape)}: "
                  f"max |kernel - plain| {err.max().item()!r}, within {GEMM_REL_TOL} * |a| @ |w|")
            del plain, err, bound
        del mlp_y
        for case, s_len, window, q, k_, v in attn_inputs:
            tc_before = FA.flash_attention_fwd.tc_launches
            out = flash_attention(q, k_, v, causal=True, window=window)
            check(not checked or FA.flash_attention_fwd.tc_launches == tc_before + 1,
                  f"K7 {case} did not take the tensor cores")
            if checked:
                plain = FA.flash_attention_fwd_plain(q, k_, v, causal=True, window=window).float()
                err = (out.float() - plain).abs()
                ok = (bool(torch.isfinite(out).all())
                      and bool((err <= BF16_ATOL + BF16_RTOL * plain.abs()).all()))
                max_err["flash_attention_tc"] = max(max_err["flash_attention_tc"], err.max().item())
                check(ok, f"K7 {case}: max |kernel - plain| {err.max().item()!r} beyond rtol "
                          f"{BF16_RTOL} atol {BF16_ATOL}")
                print(f"  library {case} bf16 H={HEADS} KV={KV_HEADS} S={s_len} D={HEAD_DIM} "
                      f"window={window}: max |kernel - plain| {err.max().item()!r} (rtol "
                      f"{BF16_RTOL}, atol {BF16_ATOL})")
                del plain, err

    library_kernels = ("stream_toggles", "ws_gemm_tc", "gemm_operand_planes", "flash_attention_tc")
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    library_path(checked=True)
    torch.cuda.synchronize()
    checked_ms = (time.perf_counter() - t0) * 1e3
    counts = read_counts()
    print(f"kernel-library path (with its checks): {checked_ms:.1f} ms; launches {counts}", flush=True)
    for name in library_kernels:
        check(counts[name] > 0, f"{name} was not launched on the kernel-library path")
    for name in OFF_PATH:
        check(counts[name] == 0, f"{name} (f32 routes) ran on the kernel-library path")
    for name in library_kernels + OFF_PATH:
        launches[name] = counts[name]

    # -- phase 3c: the design-space path ---------------------------------------
    # Measured activities (K2 and K3 through run_profile_batch) -> lane-
    # resolved profiles (L1 and L2) -> the design-space evaluator -> the
    # segment-level layout evaluator (float64 programs on the card) ->
    # Pareto set and floorplan verdict.
    ds_ref = ref["design_space"]
    paper_act = BusActivity.paper_resnet50()
    ds_grid = DesignSpace(**ds_ref["axes"]).expand()
    ds_layers = RESNET50_TABLE1[: ds_ref["layers"]]
    lane_grid = DesignSpace(rows=(16, 32), cols=(32, 64), input_bits=(16,),
                            dataflows=("WS", "OS")).expand()

    # 1. Lane-resolved profiles of the six layers on the paper's array, each
    # with the counts set to 0 just before it and read just after; then L1
    # and L2 against their plain versions on the same operands, bit for bit.
    def check_lanes(kernel, plain, args, what) -> None:
        got = kernel(*args).tolist()
        want_ = plain(*args).tolist()
        note(kernel.__name__, got, want_)
        check(got == want_, f"{kernel.__name__} {what}: kernel {got} plain {want_}")

    clear_profile_cache()
    lane_ms, lane_launches = {}, {}
    for (name, a, w), want in zip(operands, ref["layers"]):
        for dataflow in ("WS", "OS"):
            b_v = want[dataflow]["b_v"]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            reset_counts()
            p, lane_ms[name, dataflow] = host_timed(lambda: profile_gemm(
                a, w, rows, cols, OPERAND_BUS, b_v, dataflow=dataflow, backend="cuda",
                lane_detail=True))
            counts = read_counts()
            lane_launches[name, dataflow] = {k: v for k, v in counts.items() if v}
            want_launches = ({"stream_lane_toggles": 1, "ws_lane_toggles": 1} if dataflow == "WS"
                             else {"stream_lane_toggles": 2})
            check(lane_launches[name, dataflow] == want_launches,
                  f"lanes {dataflow} {name}: launches {lane_launches[name, dataflow]}, want "
                  f"{want_launches}")
            peak_mib = (torch.cuda.max_memory_allocated() - base) / 2**20
            sums = [sum(p.h_lane_toggles), sum(p.v_lane_toggles), p.h_transitions, p.v_transitions]
            check(sums == want[dataflow]["counts"],
                  f"lanes {dataflow} {name}: lane sums {sums} reference {want[dataflow]['counts']}")
            agg = AP.profile_gemm_toggles(a, w, rows, cols, OPERAND_BUS, b_v, dataflow=dataflow)
            check(sums == [agg.h_toggles, agg.v_toggles, agg.h_transitions, agg.v_transitions],
                  f"lanes {dataflow} {name}: lane sums {sums}, {'K1' if dataflow == 'WS' else 'K4'} {agg}")
            tile = (a[:, :rows], w[:rows])
            on_card_lanes = AP.profile_gemm_lane_toggles(*tile, rows, cols, OPERAND_BUS, b_v,
                                                         dataflow=dataflow, engine="cuda")
            cpu_lanes = AP.profile_gemm_lane_toggles(*tile, rows, cols, OPERAND_BUS, b_v,
                                                     dataflow=dataflow, engine="torch")
            check(on_card_lanes == cpu_lanes,
                  f"lanes {dataflow} {name}: first k tile {on_card_lanes} CPU pass {cpu_lanes}")
            a_t, w_t = on_card(a), on_card(w)
            if dataflow == "WS":
                check_lanes(K.ws_lane_toggles, K.ws_lane_toggles_plain, (a_t, w_t, rows, b_v),
                            f"{name} b_v={b_v}")
                check_lanes(K.stream_lane_toggles, K.stream_lane_toggles_plain,
                            (a_t, OPERAND_BUS), f"{name} A b={OPERAND_BUS}")
            else:
                for x_t, bits, what in ((on_card(a.T), OPERAND_BUS, "A^T"), (w_t, b_v, "W")):
                    check_lanes(K.stream_lane_toggles, K.stream_lane_toggles_plain, (x_t, bits),
                                f"{name} OS {what} b={bits}")
            print(f"  lanes {dataflow} {name}: lane profile {lane_ms[name, dataflow]:.2f} ms, "
                  f"launches {lane_launches[name, dataflow]}, peak {peak_mib:.1f} MiB; sums = "
                  f"reference = {'K1' if dataflow == 'WS' else 'K4'}; L1 and L2 = their plain "
                  f"versions; h lanes {p.h_lane_toggles[:4]}..., v lanes ...{p.v_lane_toggles[-6:]}")
    # L1 and L2 at their edges, operands at the int16 extremes
    edge_rng = np.random.default_rng(5)
    for m, k, n, rows_, b_v in LANE_EDGE_CASES:
        a_t = on_card(edge_rng.choice([-32767, 32767, -1, 0, 1, 12345], size=(m, k)))
        w_t = on_card(edge_rng.choice([-32767, 32767, -1, 0, 1, -23456], size=(k, n)))
        check_lanes(K.ws_lane_toggles, K.ws_lane_toggles_plain, (a_t, w_t, rows_, b_v),
                    f"edge {(m, k, n)} rows={rows_} b_v={b_v}")
        check(sum(K.ws_lane_toggles(a_t, w_t, rows_, b_v).tolist())
              == K.ws_activity_toggles(a_t, w_t, rows_, rows_, 16, b_v).tolist()[1],
              f"L1 edge {(m, k, n)} rows={rows_} b_v={b_v}: lane sum is not K1's v count")
    for t_len, lanes_ in STREAM_LANE_EDGE_CASES:
        x_t = on_card(edge_rng.integers(-32767, 32768, size=(t_len, lanes_)))
        for bits in (8, OPERAND_BUS, 33):
            check_lanes(K.stream_lane_toggles, K.stream_lane_toggles_plain, (x_t, bits),
                        f"edge {(t_len, lanes_)} b={bits}")
    print(f"  L1 and L2 equal their plain versions on {len(LANE_EDGE_CASES)} and "
          f"{3 * len(STREAM_LANE_EDGE_CASES)} edge cases (L1's lane sums = K1's v counts); the "
          f"lane profiles launch {sum(sum(v.values()) for v in lane_launches.values())} kernels "
          f"for the six layers' WS and OS profiles; the PyTorch lane passes they replace: "
          f"{PLAIN_LANE_PASSES}", flush=True)

    def design_space_path() -> dict:
        """The path once, each step timed by ``host_timed``; its results,
        for the checks below."""
        out, step_ms = {}, {}

        def step(label, fn):
            result, step_ms[label] = host_timed(fn)
            return result

        out["a_h"], out["a_v"], out["stats"] = step(
            "measured activities", lambda: measured_design_activities(
                ds_grid, ds_layers, backend="cuda", return_stats=True))
        out["lanes"] = step("lane activities", lambda: measured_design_lane_activities(
            lane_grid, RESNET50_TABLE1, backend="cuda"))
        out["eval"] = step("design-space evaluator", lambda: evaluate_design_space(
            ds_grid, out["a_h"], out["a_v"], engine="cuda"))
        out["pareto"] = step("Pareto set", lambda: out["eval"].pareto())
        a_h_l, a_v_l, h_lanes, v_lanes = out["lanes"]
        out["layout"] = step("layout evaluator", lambda: evaluate_layout_design_space(
            lane_grid, a_h_l, a_v_l, layouts=LANE_FAMILIES, h_lanes=h_lanes, v_lanes=v_lanes,
            engine="cuda"))
        out["paper"] = step("paper verdict", lambda: evaluate_layout_design_space(
            DesignSpace(rows=32, cols=32, input_bits=16), paper_act.a_h, paper_act.a_v,
            layouts=("uniform",), engine="cuda"))
        out["ms"] = step_ms
        return out

    clear_profile_cache()
    reset_counts()
    ds_out, main_ms["design-space"] = host_timed(design_space_path)
    counts = read_counts()
    print(f"design-space path: {main_ms['design-space']:.1f} ms (" + ", ".join(
        f"{label} {ms:.1f}" for label, ms in ds_out["ms"].items()) + f"); launches {counts}",
        flush=True)
    ds_launches = {}
    for name in ("ws_task_toggles", "strip_toggles", "ws_lane_toggles", "stream_lane_toggles"):
        check(counts[name] > 0, f"{name} was not launched on the design-space path")
        ds_launches[name] = counts[name]
    for name in ("ws_lane_toggles", "stream_lane_toggles"):
        launches[name] = counts[name]  # their first main path

    # 2. The example's grid: activities, scheduler, evaluator, Pareto set.
    stats = ds_out["stats"]
    got = {key: getattr(stats, key) for key in BATCH_STATS_FIELDS}
    check(got == ds_ref["batch_stats"],
          f"design-space scheduler: stats {got} reference {ds_ref['batch_stats']}")
    check(stats.degraded == stats.skipped == 0 and not stats.failure_report,
          f"design-space scheduler: failures {stats.as_dict()}")
    check(np.array_equal(ds_out["a_h"], ds_ref["a_h"]) and np.array_equal(ds_out["a_v"], ds_ref["a_v"]),
          "design-space activities differ from the reference file's")
    at_paper = np.flatnonzero((ds_grid.rows == 32) & (ds_grid.cols == 32) & ~ds_grid.dataflow_os
                              & ~ds_grid.bus_invert)
    for i, want in enumerate(ref["layers"][: len(ds_layers)]):
        prof = want["WS"]["profile"]
        check(bool((ds_out["a_h"][i, at_paper] == prof["a_h"]).all()
                   and (ds_out["a_v"][i, at_paper] == prof["a_v"]).all()),
              f"design-space activities at 32x32 WS, layer {i}: not the reference profile's")
    np_a_h, np_a_v, np_stats = measured_design_activities(
        ds_grid, ds_layers, backend="numpy", use_cache=False, return_stats=True)
    check(np_stats.jobs == stats.jobs and np_stats.serial_fallbacks == stats.jobs
          and np_stats.degraded == np_stats.skipped == 0 and not np_stats.failure_report,
          f"numpy backend: stats {np_stats.as_dict()}")
    act_err = max(float(np.max(np.abs(x - y) / y)) for x, y in ((ds_out["a_h"], np_a_h),
                                                                  (ds_out["a_v"], np_a_v)))
    check(act_err <= REL_TOL, f"design-space activities vs the numpy oracle: {act_err!r}")
    ev = ds_out["eval"]
    ev_np = evaluate_design_space(ds_grid, ds_out["a_h"], ds_out["a_v"], engine="numpy")
    eval_err = {}
    for field in DS_EVAL_FIELDS:
        g, w_ = np.asarray(getattr(ev, field), float), np.asarray(getattr(ev_np, field), float)
        eval_err[field] = float(np.max(np.abs(g - w_) / np.maximum(np.abs(w_), 1e-300)))
        tol = GSS_ARGMIN_RTOL if field == "aspect_opt_gss" else ENGINE_RTOL
        check(eval_err[field] <= tol, f"design-space {field}: cuda vs numpy {eval_err[field]!r}")
    shape_at = [_power_shape(ds_grid.b_h.astype(float), ds_grid.b_v.astype(float), ds_out["a_h"],
                             ev_np.a_v_eff, e.aspect_opt_gss, np) for e in (ev, ev_np)]
    gss_err = float(np.max(np.abs(shape_at[0] / shape_at[1] - 1)))
    check(gss_err <= ENGINE_RTOL, f"design-space power shape at the GSS argmin: {gss_err!r}")
    check(np.array_equal(ds_out["pareto"], ev_np.pareto()), "design-space Pareto sets differ")
    frontier = np.flatnonzero(ds_out["pareto"])
    print(f"  design space: {ds_grid.n_points} points x {len(ds_layers)} layers, scheduler {got}; "
          f"activities = reference file, within {act_err:.1e} of the numpy oracle; evaluator "
          f"cuda vs numpy max rel {max(v for k, v in eval_err.items() if k != 'aspect_opt_gss'):.1e} "
          f"(GSS argmin {eval_err['aspect_opt_gss']:.1e}, power there {gss_err:.1e}); Pareto "
          f"set of {frontier.size}: " + ", ".join(ds_grid.describe(int(i)) for i in frontier[:8]))

    # 3. Layout families with measured lanes.
    a_h_l, a_v_l, h_lanes, v_lanes = ds_out["lanes"]
    check(np.allclose(h_lanes.sum(-1), a_h_l * lane_grid.b_h, rtol=1e-12, atol=0)
          and np.allclose(v_lanes.sum(-1), a_v_l * lane_grid.b_v, rtol=1e-12, atol=0),
          "lane activities do not sum to the aggregates")
    lev = ds_out["layout"]
    lev_np = evaluate_layout_design_space(lane_grid, a_h_l, a_v_l, layouts=LANE_FAMILIES,
                                          h_lanes=h_lanes, v_lanes=v_lanes, engine="numpy")
    layout_err = 0.0
    for field in LAYOUT_EVAL_FIELDS:
        g, w_ = np.asarray(getattr(lev, field), float), np.asarray(getattr(lev_np, field), float)
        ok = np.isfinite(w_)
        check(bool((np.isfinite(g) == ok).all()), f"layout {field}: feasibility differs")
        layout_err = max(layout_err, float(np.max(np.abs(g[ok] - w_[ok]) / np.abs(w_[ok]))))
    check(layout_err <= ENGINE_RTOL, f"layout evaluator cuda vs numpy: {layout_err!r}")
    check(np.array_equal(lev.best_layout, lev_np.best_layout), "layout winners differ")
    print(f"  layouts: {lane_grid.n_points} points x {len(LANE_FAMILIES)} families x 6 layers with "
          f"measured lanes: cuda vs numpy max rel {layout_err:.1e}; best: " + ", ".join(
              f"{lane_grid.describe(i)} -> {lev.best_layout_name(i)}" for i in range(lane_grid.n_points)))

    # 4. The paper's savings through the segment engine (as
    # benchmarks/bench_layout.py derives them).
    geom = SystolicArrayGeometry.paper_32x32()
    pev = ds_out["paper"]
    p_sym = float(bus_power_arr(geom.rows, geom.cols, geom.b_h, geom.b_v, geom.pe_area_um2,
                                paper_act.a_h, paper_act.a_v, 1.0))
    p_asym = float(pev.bus_power_robust[0, 0])
    fixed, compute = calibration_split_arr(p_sym)
    int_saving = 1.0 - (p_asym + fixed) / (p_sym + fixed)
    tot_saving = 1.0 - (p_asym + fixed + compute) / (p_sym + fixed + compute)
    aspect = float(pev.aspect_robust[0, 0])
    check(f"{aspect:.2f}" == "3.78", f"segment-level W/H* {aspect!r}, paper 3.78")
    check(abs(int_saving - 0.091) <= 0.005, f"segment-level interconnect saving {int_saving!r}")
    check(abs(tot_saving - 0.021) <= 0.005, f"segment-level total saving {tot_saving!r}")
    print(f"  paper savings (segment engine, cuda): W/H*={aspect!r} interconnect -{100 * int_saving:.3f}% "
          f"total -{100 * tot_saving:.3f}% (paper 3.78, 9.1%, 2.1%)")
    print("design-space lane passes (ms): " + ", ".join(
        f"{name} {df} {ms:.2f}" for (name, df), ms in lane_ms.items()), flush=True)

    # -- phase 3d: the serving path ----------------------------------------------
    serving = serving_path_check(smi=smi, stacked=stacked, check_k2=check_k2, check_k3=check_k3)
    main_ms["serving"] = serving["wall_ms"]

    # -- phase 4: times at the main paths' shapes ----------------------------
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def device_events(prof) -> dict:
        """(ms, count) of each device-side event (kernels and copies) of a
        trace, but the profiler's own."""
        return {
            ev.key: (ev.self_device_time_total / 1e3, ev.count)
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0
            and ev.key not in PROFILER_OWN_EVENTS
        }

    # Read between the calls that device_ms traces, so that each call finds
    # its inputs in device memory, not in the 50 MB L2 (a read leaves no
    # dirty line whose write-back the call would wait for).
    # Row sums, so that no reduction across blocks (and no memset of its
    # semaphores, which would hide the kernels' own) takes part.
    l2_flush = torch.zeros((L2_FLUSH_BYTES // 4096, 1024), dtype=torch.int32, device=dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        l2_flush.sum(dim=1)
        torch.cuda.synchronize()
    flush_keys = set(device_events(prof))
    check(not any("Memset" in key for key in flush_keys),
          f"the L2 flush sets memory: {sorted(flush_keys)}")

    def device_ms(fn, calls: int = 20) -> tuple[float, dict]:
        """The device time of one call of ``fn`` from device memory: the
        device events of ``calls`` calls traced by ``torch.profiler`` (after
        one warm-up call), with the L2 flushed by a read before each and the
        flush's own events left out, summed, over ``calls``; and each
        event's share of it."""
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                l2_flush.sum(dim=1)
                fn()
            torch.cuda.synchronize()
        events = {key: ms / calls for key, (ms, _) in device_events(prof).items()
                  if key not in flush_keys}
        check(bool(events), "torch.profiler recorded no device time")
        return sum(events.values()), events

    def toggle_bound_ms(n_bytes: int, sums: int, values: int, bits: int,
                        h_values: int = 0, h_bits: int = 0) -> tuple[float, str]:
        """The toggle counters' bound: the largest of bytes / 3.35 TB/s,
        32-bit integer ops / the integer rate and popcounts / the popcount
        rate.  ``values`` transitions on a ``bits``-wide bus cost one logic
        op per 32-bit word and bits / 32 popcounts each; ``sums`` partial
        sums one multiply-add each; ``h_values`` transitions on an
        ``h_bits``-wide bus as ``values``.  Returns (ms, binding term)."""
        words = -(-bits // 32)
        h_words = -(-h_bits // 32)
        terms = {
            "bytes": n_bytes / PEAK_BYTES_PER_S,
            "integer ops": (sums + values * words + h_values * h_words) / int_ops_per_s,
            "popcounts": (values * bits + h_values * h_bits) / 32 / popc_per_s,
        }
        term = max(terms, key=terms.get)
        return terms[term] * 1e3, term

    totals = {
        name: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bound_by": {}, "library_ms": None}
        for name in KERNELS
    }
    parts: dict[str, dict[str, dict]] = {}

    def add(name, ms, plain, bound, by, library=None, part=None, device=None):
        t = totals[name]
        if device is not None:
            t["device_ms"] = t.get("device_ms", 0.0) + device
        t["ms"] += ms
        t["plain_ms"] += plain
        t["bound_ms"] += bound
        t["bound_by"][by] = t["bound_by"].get(by, 0.0) + bound
        if library is not None:
            t["library_ms"] = (t["library_ms"] or 0.0) + library
        if part is not None:
            q = parts.setdefault(name, {}).setdefault(
                part, {"calls": 0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": None})
            q["calls"] += 1
            q["ms"] += ms
            q["plain_ms"] += plain
            q["bound_ms"] += bound
            if library is not None:
                q["library_ms"] = (q["library_ms"] or 0.0) + library

    print(f"times (ms per call). Toggle counters K1-K5: bound = max(bytes / 3.35 TB/s, 32-bit "
          f"integer ops / ({INT_OPS_PER_CLOCK_SM} x {sms} SMs x {clock_mhz:.0f} MHz), popcounts / "
          f"({POPC_PER_CLOCK_SM} x {sms} SMs x {clock_mhz:.0f} MHz)); a WS partial sum is one "
          f"multiply-add, one logic op per 32-bit word of its bus and bits / 32 popcounts, a bus "
          f"value the last two:")
    for name, a, w in operands:
        m, k = a.shape
        n = w.shape[1]
        a_t, w_t = on_card(a), on_card(w)
        ms = median_ms(lambda: K.ws_activity_toggles(a_t, w_t, 32, 32, 16, WS_BUS_BITS), calls=20)
        plain = median_ms(lambda: K.ws_activity_toggles_plain(a_t, w_t, 32, 32, 16, WS_BUS_BITS),
                          calls=2, bursts=3)
        bound, by = toggle_bound_ms(4 * (m * k + k * n) + 16, m * k * n, (m - 1) * k * n, WS_BUS_BITS,
                                    (m - 1) * k, OPERAND_BUS)
        add("ws_activity_toggles", ms, plain, bound, by)
        print(f"  K1 {name} {m}x{k}x{n}: {ms:.4f} ms, plain {plain:.4f} ms, bound {bound:.5f} ms "
              f"({by}; {100 * bound / ms:.1f}% of it)")
        for stream, what in ((np.ascontiguousarray(a.T), "A"), (w, "W")):
            x_t = on_card(stream)
            t_len, lanes = stream.shape
            ms = median_ms(lambda: K.operand_stream_toggles(x_t, OPERAND_BUS), calls=20)
            device, _ = device_ms(lambda: K.operand_stream_toggles(x_t, OPERAND_BUS))
            plain = median_ms(lambda: K.operand_stream_toggles_plain(x_t, OPERAND_BUS), calls=2, bursts=3)
            bound, by = toggle_bound_ms(4 * t_len * lanes + 8, 0, (t_len - 1) * lanes, OPERAND_BUS)
            add("operand_stream_toggles", ms, plain, bound, by, device=device)
            print(f"  K4 {name} {what} stream {t_len}x{lanes}: {ms:.4f} ms a call, device "
                  f"{device:.5f} ms, plain {plain:.4f} ms, bound {bound:.6f} ms ({by})")

    # K2: the partial sums these tasks need, t_seg x valid_r x cols each
    # (time padding included: it is the kernel's input); K3: every value
    # read once.  The batched main path launches K2 once (WS) and K3 twice
    # (WS strips at b_h, OS strips).
    strips_t, tiles_t, ids_t, wids_t, vr_t = ws_arrays
    n_tasks = ids_t.shape[0]
    t_seg, cols = strips_t.shape[1] - 1, tiles_t.shape[2]
    task_sums = t_seg * cols * int(vr_t.sum())
    useful_sums = sum(int(np.prod(job.gemm_shape())) for job in table1_jobs["WS"])
    ms = median_ms(lambda: K.ws_task_toggles(*ws_arrays, WS_BUS_BITS), calls=20)
    plain = median_ms(lambda: K.ws_task_toggles_plain(*ws_arrays, WS_BUS_BITS), calls=2, bursts=3)
    k2_bytes = sum(x.numel() * x.element_size() for x in ws_arrays) + 8 * n_tasks
    bound, by = toggle_bound_ms(k2_bytes, task_sums, task_sums, WS_BUS_BITS)
    useful, _ = toggle_bound_ms(0, useful_sums, useful_sums, WS_BUS_BITS)
    add("ws_task_toggles", ms, plain, bound, by)
    print(f"  K2 Table-I WS bucket, {n_tasks} tasks, {task_sums} partial sums "
          f"({useful_sums} in the GEMMs: bound {useful:.5f} ms): "
          f"{ms:.4f} ms, plain {plain:.4f} ms, bound {bound:.5f} ms ({by})")
    for strips_x, bits, what in ((strips_t, 16, "WS strips"), (os_strips, 16, "OS stream strips")):
        ms = median_ms(lambda: K.strip_toggles(strips_x, bits), calls=20)
        device, events = device_ms(lambda: K.strip_toggles(strips_x, bits))
        plain = median_ms(lambda: K.strip_toggles_plain(strips_x, bits), calls=2, bursts=3)
        values = strips_x.numel()
        transitions = values - strips_x.shape[0] * strips_x.shape[2]  # row 0 of each strip seeds
        bound, by = toggle_bound_ms(4 * values + 8 * strips_x.shape[0], 0, transitions, bits)
        add("strip_toggles", ms, plain, bound, by, device=device, part=what)
        print(f"  K3 Table-I {what} {tuple(strips_x.shape)}: {ms:.4f} ms a call, device "
              f"{device:.5f} ms ({100 * bound / device:.1f}% of the bound; "
              + ", ".join(f"{ms_:.5f} {key[:40]}" for key, ms_ in events.items())
              + f"), plain {plain:.4f} ms, bound {bound:.6f} ms ({by})")

    # K5: each stream the kernel-library path counts, at its bus width; every
    # value read once.  The 12 partial-sum streams and the 36 operand streams
    # are summed apart.
    print("  kernel library (K5 bound as K1-K4; K6 and K7: max(bytes / 3.35 TB/s, ops / the "
          "rate of the operands' type: 989 TFLOP/s bf16, 1979 Tops/s int8, 495 TFLOP/s TF32 for "
          "f32's three TF32 products)):")
    mask16 = bus_mask(16)
    for name, a, w, a8, w8, _ in lib_layers:
        m, k = a.shape
        n = w.shape[1]
        a_t, w_t = on_card(a), on_card(w)
        at_t = a_t.t().contiguous()
        sums = partial_sums(a_t, w_t)
        sums &= bus_mask(WS_BUS_BITS)
        stream = sums.reshape(m, k * n)
        layer = {}
        for x, bits in ((a_t, 32), (at_t, 32), (w_t.long() & mask16, 64), (stream, 64),
                        (a_t, 16), (at_t, 16), (w_t, 16), (stream, WS_BUS_BITS)):
            ms = median_ms(lambda: TC.stream_toggles(x, bits), calls=20)
            plain = median_ms(lambda: TC.stream_toggles_plain(x, bits), calls=2, bursts=3)
            bound, by = toggle_bound_ms(x.numel() * x.element_size() + 8, 0,
                                        (x.shape[0] - 1) * x.shape[1], bits)
            part = "partial-sum streams" if x is stream else "operand streams"
            add("stream_toggles", ms, plain, bound, by, part=part)
            q = layer.setdefault(part, [0, 0.0, 0.0, 0.0, set()])
            q[0] += 1
            q[1] += ms
            q[2] += plain
            q[3] += bound
            q[4].add(by)
        print(f"  K5 {name}: " + "; ".join(
            f"{part} {q[0]} calls {q[1]:.4f} ms, plain {q[2]:.4f} ms, bound {q[3]:.5f} ms "
            f"({'/'.join(sorted(q[4]))}; {100 * q[3] / q[1]:.1f}% of it)" for part, q in layer.items())
            + f" (the largest {tuple(stream.shape)} int64)")
        del sums, stream
        # K6 at int16 (no PyTorch CUDA int16 GEMM) and int8 (torch._int_mm)
        # on the tensor cores: the whole call (planes, zeroed output, GEMM)
        # and its prep kernel alone.  The bound counts the int8 products the
        # tensor cores run (four for int16).
        for x_np, y_np, dtype, part in ((a, w, torch.int16, "int16"), (a8, w8, torch.int8, "int8")):
            x = torch.from_numpy(x_np).to(dtype).to(dev)
            y = torch.from_numpy(y_np).to(dtype).to(dev)
            tc = median_ms(lambda: WM.ws_gemm(x, y), calls=20)
            prep = median_ms(lambda: WM.gemm_operand_planes(x, y), calls=20)
            prep_device, _ = device_ms(lambda: WM.gemm_operand_planes(x, y))
            plain = median_ms(lambda: WM.ws_gemm_plain(x, y), calls=5, bursts=3)
            prep_plain = median_ms(lambda: WM.gemm_operand_planes_plain(x, y), calls=5, bursts=3)
            library = median_ms(lambda: torch._int_mm(x, y), calls=20) if part == "int8" else None
            size = x.element_size()
            n_bytes = size * (m * k + k * n) + 4 * m * n
            bound_tc, by_tc = bound_ms(n_bytes, 2 * size * size * m * k * n, PEAK_INT8_OPS)
            kp = -(-k // WM.PLANE_K) * WM.PLANE_K
            bound_prep, by_prep = bound_ms(size * (m * k + k * n) + size * (m + n) * kp, 0)
            add("ws_gemm_tc", tc, plain, bound_tc, by_tc, library, part)
            add("gemm_operand_planes", prep, prep_plain, bound_prep, by_prep, None, part,
                device=prep_device)
            lib_text = f"torch._int_mm {library:.4f} ms" if library is not None else "no library call"
            print(f"  K6 {name} {part} {m}x{k}x{n}: tensor cores {tc:.4f} ms (prep {prep:.4f} ms a "
                  f"call, device {prep_device:.5f} ms, plain {prep_plain:.4f} ms, bound "
                  f"{bound_prep:.6f} ms), plain {plain:.4f} ms, {lib_text}, bound {bound_tc:.5f} ms "
                  f"({by_tc})")
    for part, q in parts["stream_toggles"].items():
        print(f"  K5 {part}, all layers: {q['calls']} calls {q['ms']:.4f} ms, plain "
              f"{q['plain_ms']:.4f} ms, bound {q['bound_ms']:.5f} ms ("
              f"{100 * q['bound_ms'] / q['ms']:.1f}% of it)")
    # K6 at the Qwen3-8B MLP width: bf16 on the "tc" route, and f32 on the
    # "tf32" route; each beside torch.matmul on the same inputs (bf16 out
    # for bf16, full f32 for f32).
    m, k = mlp_x.shape
    n = mlp_w.shape[1]
    tc = median_ms(lambda: WM.ws_gemm(mlp_x, mlp_w), calls=10, bursts=3)
    plain = median_ms(lambda: WM.ws_gemm_plain(mlp_x, mlp_w), calls=3, bursts=3)
    library = median_ms(lambda: torch.matmul(mlp_x, mlp_w), calls=10, bursts=3)
    bound, by = bound_ms(2 * (m * k + k * n) + 4 * m * n, 2 * m * k * n, PEAK_BF16_FLOPS)
    add("ws_gemm_tc", tc, plain, bound, by, library, "bf16")
    print(f"  K6 Qwen3-8B MLP bf16 {m}x{k}x{n}: tensor cores {tc:.4f} ms "
          f"({2 * m * k * n / tc / 1e9:.1f} TFLOP/s), plain (f32) {plain:.4f} ms, torch.matmul "
          f"(bf16 out) {library:.4f} ms, bound {bound:.5f} ms ({by})")
    # f32: seeded f32 operands made on the card (not the bf16 ones widened,
    # whose values TF32 holds exactly, so that the small planes are not
    # zero), held to GEMM_REL_TOL * (|a| @ |w|) before they are timed. The
    # bound counts the three TF32 products at the TF32 rate; the bound of
    # one f32 product at the f32 CUDA-core rate is printed beside it.
    mlp_x32 = torch.randn(m, k, generator=gen, device=dev)
    mlp_w32 = torch.randn(k, n, generator=gen, device=dev) * k ** -0.5
    before = WM.ws_gemm.tf32_launches
    got = WM.ws_gemm(mlp_x32, mlp_w32)
    check(WM.ws_gemm.tf32_launches == before + 1, "K6 f32 MLP did not take the tf32 route")
    plain = WM.ws_gemm_plain(mlp_x32, mlp_w32)
    err = (got - plain).abs()
    check(bool(torch.isfinite(got).all())
          and bool((err <= GEMM_REL_TOL * (mlp_x32.abs() @ mlp_w32.abs())).all()),
          f"K6 f32 MLP: |kernel - plain| beyond {GEMM_REL_TOL} * |a| @ |w|")
    max_err["ws_gemm_tf32"] = max(max_err["ws_gemm_tf32"], err.max().item())
    print(f"  K6 Qwen3-8B MLP f32 {m}x{k}x{n}: max |kernel - plain| {err.max().item()!r}, within "
          f"{GEMM_REL_TOL} * |a| @ |w|")
    del got, plain, err
    tf32 = median_ms(lambda: WM.ws_gemm(mlp_x32, mlp_w32), calls=5, bursts=3)
    plain = median_ms(lambda: WM.ws_gemm_plain(mlp_x32, mlp_w32), calls=3, bursts=3)
    library = median_ms(lambda: torch.matmul(mlp_x32, mlp_w32), calls=5, bursts=3)
    n_bytes = 4 * (m * k + k * n + m * n)
    bound, by = bound_ms(n_bytes, 3 * 2 * m * k * n, PEAK_TF32_FLOPS)
    bound_f32, _ = bound_ms(n_bytes, 2 * m * k * n, PEAK_OPS_PER_S)
    add("ws_gemm_tf32", tf32, plain, bound, by, library, "f32")
    print(f"  K6 Qwen3-8B MLP f32 {m}x{k}x{n}: tf32 route (three TF32 products) {tf32:.4f} ms "
          f"({2 * m * k * n / tf32 / 1e9:.1f} f32 TFLOP/s), plain {plain:.4f} ms, torch.matmul "
          f"(full f32) {library:.4f} ms ({library / tf32:.2f}x the route's time), bound "
          f"{bound:.5f} ms ({by}: 3 TF32 products at 495 TFLOP/s; one f32 product at 67 TFLOP/s: "
          f"{bound_f32:.5f} ms)")
    del mlp_x32, mlp_w32
    # K7: 4 * D operations per visible (query, key) pair; the library call
    # is scaled_dot_product_attention on K and V repeated to the query heads
    # (outside the timing), with is_causal or a boolean window mask.
    for case, s_len, window, q, k_, v in attn_inputs:
        rep = HEADS // KV_HEADS
        k_rep, v_rep = k_.repeat_interleave(rep, dim=1), v.repeat_interleave(rep, dim=1)
        if window is None:
            visible = s_len * (s_len + 1) // 2

            def sdpa():
                return torch.nn.functional.scaled_dot_product_attention(q, k_rep, v_rep, is_causal=True)
        else:
            visible = sum(min(t + 1, window) for t in range(s_len))
            ids = torch.arange(s_len, device=dev)
            keep = (ids[:, None] >= ids[None, :]) & (ids[:, None] - ids[None, :] < window)

            def sdpa():
                return torch.nn.functional.scaled_dot_product_attention(q, k_rep, v_rep, attn_mask=keep)
        tc = median_ms(lambda: FA.flash_attention_fwd(q, k_, v, causal=True, window=window),
                       calls=10, bursts=3)
        plain = median_ms(lambda: FA.flash_attention_fwd_plain(q, k_, v, causal=True, window=window),
                          calls=1, bursts=3)
        library = median_ms(sdpa, calls=5, bursts=3)
        n_bytes = sum(x.numel() * x.element_size() for x in (q, k_, v, q))
        flops = 4 * HEAD_DIM * HEADS * visible
        bound, by = bound_ms(n_bytes, flops, PEAK_BF16_FLOPS)
        add("flash_attention_tc", tc, plain, bound, by, library, case)
        print(f"  K7 {case} bf16 S={s_len} window={window} ({visible} visible pairs per head): "
              f"tensor cores {tc:.4f} ms ({flops / tc / 1e9:.1f} TFLOP/s), plain {plain:.4f} ms, "
              f"scaled_dot_product_attention {library:.4f} ms, bound {bound:.5f} ms ({by})")
        # The same case in f32 on the "tf32" route, from seeded f32 inputs
        # made on the card (the bf16 ones widened are exact in TF32, so their
        # small planes would be zero): first held to its plain version
        # (F32_TOL) and to a float64 rendering (F32_REF_TOL), then timed
        # beside SDPA on the same inputs. The bound counts three TF32
        # products at the TF32 rate; that of one f32 product at the f32
        # CUDA-core rate is printed beside it.
        q, k_, v = (torch.randn(1, heads, s_len, HEAD_DIM, generator=gen, device=dev)
                    for heads in (HEADS, KV_HEADS, KV_HEADS))
        k_rep, v_rep = k_.repeat_interleave(rep, dim=1), v.repeat_interleave(rep, dim=1)
        before = FA.flash_attention_fwd.tf32_launches
        got = FA.flash_attention_fwd(q, k_, v, causal=True, window=window)
        check(FA.flash_attention_fwd.tf32_launches == before + 1, f"K7 {case} f32 did not take the tf32 route")
        plain = FA.flash_attention_fwd_plain(q, k_, v, causal=True, window=window)
        exact = FA.flash_attention_fwd_plain(q.double(), k_.double(), v.double(), causal=True,
                                             window=window)
        err = (got - plain).abs()
        err64 = (got.double() - exact).abs()
        plain64 = (plain.double() - exact).abs().max().item()
        check(bool(torch.isfinite(got).all()) and bool((err <= F32_TOL + F32_TOL * plain.abs()).all()),
              f"K7 {case} f32: max |kernel - plain| {err.max().item()!r} beyond rtol = atol = {F32_TOL}")
        check(bool((err64 <= F32_REF_TOL + F32_REF_TOL * exact.abs()).all()),
              f"K7 {case} f32: max |kernel - float64| {err64.max().item()!r} beyond rtol = atol = "
              f"{F32_REF_TOL}")
        max_err["flash_attention_tf32"] = max(max_err["flash_attention_tf32"], err.max().item())
        print(f"  K7 {case} f32: max |kernel - plain| {err.max().item()!r} (within {F32_TOL}), "
              f"|kernel - float64| {err64.max().item()!r} (within {F32_REF_TOL}; the plain "
              f"version's {plain64!r})")
        del got, plain, exact, err, err64
        planes_plain = FA.attention_operand_planes_plain(k_, v)
        for g, p in zip(FA.attention_operand_planes(k_, v), planes_plain):
            check(torch.equal(g.view(torch.int32), p.view(torch.int32)),
                  f"attention_operand_planes {case}: kernel and plain version differ")
        del planes_plain
        tf32 = median_ms(lambda: FA.flash_attention_fwd(q, k_, v, causal=True, window=window),
                         calls=10, bursts=3)
        tf32_device, events = device_ms(
            lambda: FA.flash_attention_fwd(q, k_, v, causal=True, window=window), calls=5)
        plain = median_ms(lambda: FA.flash_attention_fwd_plain(q, k_, v, causal=True, window=window),
                          calls=1, bursts=3)
        library = median_ms(sdpa, calls=3, bursts=3)
        n_bytes32 = sum(x.numel() * x.element_size() for x in (q, k_, v, q))
        bound, by = bound_ms(n_bytes32, 3 * flops, PEAK_TF32_FLOPS)
        bound_f32, _ = bound_ms(n_bytes32, flops, PEAK_OPS_PER_S)
        add("flash_attention_tf32", tf32, plain, bound, by, library, case + " f32")
        print(f"  K7 {case} f32: tf32 route (three TF32 products) {tf32:.4f} ms "
              f"({flops / tf32 / 1e9:.1f} f32 TFLOP/s; {100 * bound / tf32:.1f}% of the bound), device "
              f"{tf32_device:.5f} ms (" + ", ".join(
                  f"{ms_:.5f} {key.replace('void (anonymous namespace)::', '')[:40]}"
                  for key, ms_ in events.items())
              + f"), plain {plain:.4f} ms, scaled_dot_product_attention (f32) {library:.4f} ms "
              f"({tf32 / library:.2f}x its time), bound {bound:.5f} ms ({by}: 3 TF32 products at "
              f"495 TFLOP/s; one f32 product at 67 TFLOP/s: {bound_f32:.5f} ms)")
        # its prep kernel alone: K and V read once, both planes of each written
        b_kv = KV_HEADS
        sp = -(-s_len // FA.PLANE_KEYS) * FA.PLANE_KEYS
        prep = median_ms(lambda: FA.attention_operand_planes(k_, v), calls=20)
        prep_device, _ = device_ms(lambda: FA.attention_operand_planes(k_, v))
        prep_plain = median_ms(lambda: FA.attention_operand_planes_plain(k_, v), calls=3, bursts=3)
        prep_bound, prep_by = bound_ms(4 * 2 * b_kv * s_len * HEAD_DIM
                                       + 4 * 2 * b_kv * HEAD_DIM * (s_len + sp), 0)
        add("attention_operand_planes", prep, prep_plain, prep_bound, prep_by, None, case,
            device=prep_device)
        print(f"  K7 prep {case} (K and V {b_kv}x{s_len}x{HEAD_DIM} f32): {prep:.4f} ms a call, "
              f"device {prep_device:.5f} ms ({100 * prep_bound / prep_device:.1f}% of the bound), "
              f"plain {prep_plain:.4f} ms, bound {prep_bound:.5f} ms ({prep_by})")
        del q, k_, v, k_rep, v_rep
    # L1 and L2 at the lane profiles' shapes (the six layers, WS b_v = 37
    # and b_h = 16; OS A^T and W at 16). Bound: bytes, or 32-bit integer
    # ops: a multiply-add per partial sum and, per transition and 32-bit
    # word of the bus, an XOR and a full adder (two logic ops) that folds it
    # into the bit-sliced counters. No PyTorch call counts bits per lane.
    def lane_bound_ms(n_bytes: int, sums: int, values: int, bits: int) -> tuple[float, str]:
        terms = {"bytes": n_bytes / PEAK_BYTES_PER_S,
                 "integer ops": (sums + 3 * values * -(-bits // 32)) / int_ops_per_s}
        term = max(terms, key=terms.get)
        return terms[term] * 1e3, term

    print("  L1 and L2 (bound = max(bytes / 3.35 TB/s, 32-bit integer ops / the integer rate); a "
          "partial sum is one multiply-add, a transition word an XOR and a full adder):")
    for name, a, w in operands:
        m, k = a.shape
        n = w.shape[1]
        a_t, w_t = on_card(a), on_card(w)
        ms = median_ms(lambda: K.ws_lane_toggles(a_t, w_t, rows, WS_BUS_BITS), calls=20)
        device, _ = device_ms(lambda: K.ws_lane_toggles(a_t, w_t, rows, WS_BUS_BITS))
        plain = median_ms(lambda: K.ws_lane_toggles_plain(a_t, w_t, rows, WS_BUS_BITS), calls=1,
                          bursts=3)
        bound, by = lane_bound_ms(4 * (m * k + k * n) + 8 * WS_BUS_BITS, m * k * n,
                                  (m - 1) * k * n, WS_BUS_BITS)
        add("ws_lane_toggles", ms, plain, bound, by, device=device)
        print(f"  L1 {name} {m}x{k}x{n} b_v={WS_BUS_BITS}: {ms:.4f} ms, device {device:.5f} ms, "
              f"plain {plain:.3f} ms, bound {bound:.5f} ms ({by}; {100 * bound / device:.1f}% of "
              f"the device time)")
        for x_np, what in ((a, "WS A"), (np.ascontiguousarray(a.T), "OS A^T"), (w, "OS W")):
            x_t = on_card(x_np)
            t_len, lanes_ = x_np.shape
            ms = median_ms(lambda: K.stream_lane_toggles(x_t, OPERAND_BUS), calls=20)
            device, _ = device_ms(lambda: K.stream_lane_toggles(x_t, OPERAND_BUS))
            plain = median_ms(lambda: K.stream_lane_toggles_plain(x_t, OPERAND_BUS), calls=2,
                              bursts=3)
            bound, by = lane_bound_ms(4 * t_len * lanes_ + 8 * OPERAND_BUS, 0,
                                      (t_len - 1) * lanes_, OPERAND_BUS)
            add("stream_lane_toggles", ms, plain, bound, by, device=device, part=what)
            print(f"  L2 {name} {what} {t_len}x{lanes_}: {ms:.4f} ms a call, device "
                  f"{device:.5f} ms, plain {plain:.3f} ms, bound {bound:.6f} ms ({by})")
    for what, q in parts["stream_lane_toggles"].items():
        print(f"  L2 {what}, all layers: {q['calls']} calls {q['ms']:.4f} ms, plain "
              f"{q['plain_ms']:.3f} ms, bound {q['bound_ms']:.5f} ms")
    t = totals["ws_lane_toggles"]
    print(f"  L1, all layers: {t['ms']:.4f} ms, device {t['device_ms']:.5f} ms, plain "
          f"{t['plain_ms']:.3f} ms, bound {t['bound_ms']:.5f} ms; the PyTorch lane passes it "
          f"replaced: {PLAIN_LANE_PASSES}", flush=True)

    # The design-space path's PyTorch programs (no hand-written kernel: the
    # reference runs them as jitted XLA), and the lane profiles whole (L1,
    # L2, copies): time a call (CUDA events), the device kernels one call
    # launches and their device time (torch.profiler), and its peak memory
    # above what was allocated before it.
    def program_stats(fn, calls: int = 3) -> dict:
        ms = median_ms(fn, calls=calls, bursts=3)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = device_events(prof)
        return {
            "ms": ms,
            "kernels": sum(n for key, (_, n) in events.items() if not key.startswith("Mem")),
            "device_ms": sum(ms_ for ms_, _ in events.values()),
            "peak_mib": (torch.cuda.max_memory_allocated() - base) / 2**20,
        }

    fleet = DesignSpace(rows=(8, 16, 32, 64, 96, 128), cols=(8, 16, 32, 64, 128, 192, 256, 512),
                        input_bits=(4, 8, 16), dataflows=("WS", "OS"),
                        pe_area_um2=(400.0, 900.0, 1600.0, 2500.0)).expand()
    fleet_rng = np.random.default_rng(0)
    fleet_ah = fleet_rng.uniform(0.1, 0.4, (3, fleet.n_points))
    fleet_av = fleet_rng.uniform(0.2, 0.6, (3, fleet.n_points))
    ds_a_h, ds_a_v = ds_out["a_h"], ds_out["a_v"]
    sweep_aspects = np.geomspace(1 / 16, 16, 64)
    programs = {
        "lane profiles (6 layers, WS b_h=16 b_v=37)": lambda: [
            AP.profile_gemm_lane_toggles(a, w, rows, cols, OPERAND_BUS, WS_BUS_BITS)
            for _, a, w in operands],
        "_evaluate_core (40 points x 3 layers)": lambda: evaluate_design_space(
            ds_grid, ds_a_h, ds_a_v, engine="cuda"),
        "_sweep_core (40 points x 64 aspects)": lambda: sweep_bus_power(
            ds_grid, ds_a_h.mean(0), ds_a_v.mean(0), sweep_aspects, engine="cuda"),
        f"_coeff_eval_core (fleet: {fleet.n_points} points x {len(FLEET_FAMILIES)} families)":
            lambda: evaluate_layout_design_space(fleet, fleet_ah, fleet_av, layouts=FLEET_FAMILIES,
                                                 engine="cuda"),
    }
    numpy_twins = {
        "_evaluate_core": lambda: evaluate_design_space(ds_grid, ds_a_h, ds_a_v, engine="numpy"),
        "_sweep_core": lambda: sweep_bus_power(ds_grid, ds_a_h.mean(0), ds_a_v.mean(0),
                                               sweep_aspects, engine="numpy"),
        "_coeff_eval_core": lambda: evaluate_layout_design_space(
            fleet, fleet_ah, fleet_av, layouts=FLEET_FAMILIES, engine="numpy"),
    }
    ds_programs = {}
    for label, fn in programs.items():
        st_ = program_stats(fn)
        twin = numpy_twins.get(label.split()[0])
        if twin is not None:
            twin()
            st_["numpy_ms"] = min(host_timed(twin)[1] for _ in range(3))
        ds_programs[label] = st_
        print(f"  program {label}: {st_['ms']:.3f} ms a call, {st_['kernels']} kernel launches, "
              f"device {st_['device_ms']:.4f} ms, peak {st_['peak_mib']:.1f} MiB"
              + (f"; numpy engine {st_['numpy_ms']:.3f} ms" if "numpy_ms" in st_ else ""))
    fleet_label = next(label for label in programs if label.startswith("_coeff_eval_core"))
    cells = fleet.n_points * len(FLEET_FAMILIES)
    print(f"  layout evaluator, warm, fleet grid: {cells / ds_programs[fleet_label]['ms'] * 1e3:,.0f} "
          f"(point x layout) cells/s on the card, "
          f"{cells / ds_programs[fleet_label]['numpy_ms'] * 1e3:,.0f} with engine='numpy'", flush=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    library_path(checked=False)
    torch.cuda.synchronize()
    main_ms["library"] = (time.perf_counter() - t0) * 1e3
    print(f"kernel-library path wall (no checks): {main_ms['library']:.1f} ms", flush=True)

    # -- phase 5: where each main path's time goes -----------------------------
    def both_dataflows(run):
        def go():
            for dataflow in ("WS", "OS"):
                run(dataflow)
        return go

    for path, go in (("per-GEMM path (WS + OS, cache cleared", both_dataflows(per_gemm_path)),
                     ("batched path (WS + OS, cache cleared", both_dataflows(batched_path)),
                     ("kernel-library path (no checks", lambda: library_path(checked=False)),
                     ("design-space path (cache cleared", design_space_path)):
        clear_profile_cache()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            go()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        # Device-side events only (kernels and copies); host ops that launched
        # them would count their time twice.  The profiler's own buffer
        # request is not the program's work and is left out.
        events = device_events(prof)
        busy_ms = sum(ms for ms, _ in events.values())
        print(f"trace of the {path}, profiler on): wall "
              f"{wall_ms:.1f} ms, device busy {busy_ms:.4f} ms = {100 * busy_ms / wall_ms:.3f}% "
              f"of the wall time")
        for key, (ms, count) in sorted(events.items(), key=lambda kv: -kv[1][0])[:10]:
            print(f"  device {ms:.4f} ms in {count} x {key[:90]}")

    # -- phase 6: the model path --------------------------------------------------
    # Last: its 16 GB of weights and their cached blocks would otherwise sit
    # under phase 4's flushed device times (run 1 of this phase before phase
    # 4 added a ~0.14 ms elementwise kernel to every one of them).
    model = model_path_check(dev=dev, smi=smi)

    # -- phase 6b: L3 and the Mamba path ---------------------------------------------
    # After phase 6, whose weights are freed here.
    torch.cuda.empty_cache()
    mamba = mamba_path_check(dev=dev, smi=smi)
    add("selective_scan_fwd", mamba["ms"], mamba["plain_ms"], mamba["bound_ms"], mamba["bound_by"])
    max_err["selective_scan_fwd"] = mamba["max_abs_err"]
    # its first main path: the Jamba-width forward
    launches["selective_scan_fwd"] = mamba["launches"]["selective_scan_fwd"]

    # -- phase 6c: L4 at the cells' shapes ------------------------------------------
    torch.cuda.empty_cache()
    norms = norm_path_check(dev=dev, smi=smi)
    for name in ("rms_norm_fwd", "qk_rope_fwd"):
        t = norms[name]
        add(name, t["ms"], t["plain_ms"], t["bound_ms"], t["bound_by"], library=t["library_ms"],
            device=t["device_ms"])
        max_err[name] = t["max_abs_err"]
        # its first main path: the model path (phase 6)
        launches[name] = model["launches"][name]

    # -- phase 7: the training path ------------------------------------------------
    # After phases 6, 6b and 6c, whose bf16 tensors were their own and are freed here.
    torch.cuda.empty_cache()
    print(f"phase 7: {torch.cuda.memory_allocated() / 1024 ** 3:.2f} GiB allocated before it",
          flush=True)
    training = training_path_check(dev=dev, smi=smi)

    # -- phase 8: the mesh path ------------------------------------------------------
    # After phase 7, whose f32 state is freed here.
    torch.cuda.empty_cache()
    mesh = mesh_path_check(dev=dev, smi=smi, model=model, training=training)

    meta = {
        "ws_activity_toggles": (
            "src/repro_torch/csrc/activity_profile.cu",
            "src/repro/kernels/activity_profile/kernel.py:149",
        ),
        "ws_task_toggles": (
            "src/repro_torch/csrc/activity_batch.cu",
            "src/repro/kernels/activity_profile/kernel.py:332",
        ),
        "strip_toggles": (
            "src/repro_torch/csrc/toggle_count.cu",
            "src/repro/kernels/activity_profile/kernel.py:298",
        ),
        "operand_stream_toggles": (
            "src/repro_torch/csrc/toggle_count.cu",
            "src/repro/kernels/activity_profile/kernel.py:249",
        ),
        "stream_toggles": (
            "src/repro_torch/csrc/toggle_count.cu",
            "src/repro/kernels/toggle_count/kernel.py:34",
        ),
        "ws_gemm_tf32": (
            "src/repro_torch/csrc/ws_matmul.cu",
            "src/repro/kernels/ws_matmul/kernel.py:55",
        ),
        "flash_attention_tf32": (
            "src/repro_torch/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention/kernel.py:112",
        ),
        "attention_operand_planes": (
            "src/repro_torch/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention/kernel.py:112",
        ),
        "ws_gemm_tc": (
            "src/repro_torch/csrc/ws_matmul.cu",
            "src/repro/kernels/ws_matmul/kernel.py:55",
        ),
        "gemm_operand_planes": (
            "src/repro_torch/csrc/ws_matmul.cu",
            "src/repro/kernels/ws_matmul/kernel.py:55",
        ),
        "flash_attention_tc": (
            "src/repro_torch/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention/kernel.py:112",
        ),
        # no TPU kernel: the reference's XLA lane passes
        "ws_lane_toggles": (
            "src/repro_torch/csrc/lane_toggles.cu",
            "src/repro/kernels/activity_profile/ops.py:513",
        ),
        "stream_lane_toggles": (
            "src/repro_torch/csrc/lane_toggles.cu",
            "src/repro/kernels/activity_profile/ops.py:486",
        ),
        # no TPU kernel: the reference's Mamba scan
        "selective_scan_fwd": (
            "src/repro_torch/csrc/selective_scan.cu",
            "src/repro/models/ssm.py:73",
        ),
        # no TPU kernel: the reference's RMSNorm and RoPE
        "rms_norm_fwd": (
            "src/repro_torch/csrc/rms_norm.cu",
            "src/repro/models/layers.py:76",
        ),
        "qk_rope_fwd": (
            "src/repro_torch/csrc/rms_norm.cu",
            "src/repro/models/layers.py:112",
        ),
    }
    kernels = []
    for name, t in totals.items():
        source, replaces = meta[name]
        term = max(t["bound_by"], key=t["bound_by"].get)
        row = {
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": max_err[name],
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": "bytes" if term == "bytes" else "operations",
            # None for the toggle counters: no PyTorch call counts bus toggles
            "library_ms": t["library_ms"],
            # bytes, integer ops or popcounts (K1-K5); operations (K6, K7)
            "bound_term": term,
        }
        if "device_ms" in t:
            # the kernels' device time (torch.profiler), where a call's host
            # work outlasts its kernel and "ms" is the host's
            row["device_ms"] = t["device_ms"]
        if name == "ws_gemm_tc":
            row["library_covers"] = ("int8 (torch._int_mm) and bf16 (torch.matmul) calls; "
                                     "PyTorch has no CUDA int16 GEMM")
        if name == "ws_gemm_tf32":
            row["library_covers"] = "f32 torch.matmul in full f32"
        if name == "flash_attention_tf32":
            row["library_covers"] = "f32 scaled_dot_product_attention (is_causal, or a window mask)"
        if name in model["launches"]:
            row["model_launches"] = model["launches"][name]
            if name in OFF_PATH:
                # the f32 route's first main path is the model path
                row["launches"] = model["launches"][name]
        elif name in OFF_PATH:
            row["main_path"] = False
        if name == "flash_attention_tc":
            # K7 at the model path's full-width shape, apart from the
            # kernel-library shapes summed in "ms"
            row["model_shape"] = model["k7"]
        if name in ds_launches:
            row["design_space_launches"] = ds_launches[name]
        if name in ("ws_lane_toggles", "stream_lane_toggles"):
            row["reference"] = "an XLA program (_v_lane_toggles_xla / _h_lane_toggles_xla), not a Pallas kernel"
        if name == "selective_scan_fwd":
            row["reference"] = "an XLA program (lax.associative_scan in the Mamba block), not a Pallas kernel"
            # L3 at the Jamba cell's scan shape (B, S, d_inner, N), bf16
            row["shape"] = mamba["shape"]
        if name in ("rms_norm_fwd", "qk_rope_fwd"):
            row["reference"] = ("an XLA program (rms_norm and apply_rope of the model layers), "
                                "not a Pallas kernel")
            # the long prompt's rows (S, d) and Qwen3-8B's q and k (H, KV, hd), bf16
            row["shape"] = norms["shape"]
            # the torch route's float32 chain of PyTorch passes at the same shapes
            row["torch_route_ms"] = norms[name]["torch_route_ms"]
        if name in serving["launches"]:
            row["serving_launches"] = serving["launches"][name]
        if name in parts:
            row["parts"] = parts[name]
        # the training path trains through the torch attention route (K7
        # has no backward): none of the port's kernels is on it
        row["training_launches"] = training["launches"][name]
        # the mesh path: K7 through local_map on the one-rank mesh
        row["mesh_launches"] = mesh["launches"][name]
        kernels.append(row)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()},
    }), flush=True)


if __name__ == "__main__":
    main()
