"""Multi-pod dry run: trace every (arch x shape x mesh) cell on a fake mesh.

The reference lowers and compiles each cell's step for 512 placeholder XLA
devices and reads XLA's memory and cost analyses and the optimized HLO.
PyTorch has no such compiler, so the port runs the step itself, eagerly,
on tensors that hold no data:

  1. One process initialises ``torch.distributed``'s ``"fake"`` process
     group at ``$REPRO_TORCH_DRYRUN_DEVICES`` ranks (default 512) and is
     its rank 0; every collective returns at once.  It builds the
     production mesh (16x16, or 2x16x16 multi-pod) over it, typed
     ``"cuda"`` (DTensor then takes the collectives a card mesh takes, the
     all-to-all included) while its tensors live on ``meta``.
  2. ``launch.specs.input_specs`` gives the cell's inputs as meta tensors
     and their logical axes; ``parallel.sharding.sharding_for`` places each
     one on the mesh by the parameter rules (``place``: rank 0's block, as
     a DTensor).
  3. The step runs under ``activation_sharding`` (the shard hints pin the
     activations' layouts by the activation rules), under autograd for
     training and ``inference_mode`` for prefill and decode, attention on
     the torch route, which is the program the reference's XLA counts.
     Running to the end IS the test: every op has a DTensor sharding, every
     redistribution a collective.
  4. ``analysis.hlo.TraceCounter`` watches rank 0's local ops: per-device
     FLOPs and bytes, the collectives' result bytes by op, the peak of live
     intermediate bytes and the storages written in place.

The record keeps the reference's keys and file names.  ``memory``:
``argument_size_in_bytes`` is the bytes of the blocks ``place`` gives
rank 0 of the inputs (exact: the reference's compiled number for the same
shardings is the sum of ``NamedSharding.shard_shape``);
``output_size_in_bytes`` the local bytes of what the step returns;
``alias_size_in_bytes`` the local bytes of the donated inputs
(``launch.steps.step_for_shape``'s) that the step writes in place; and
``temp_size_in_bytes`` the peak of live intermediate local bytes over the
step: an eager estimate (each op's result lives until its last reference
goes), not XLA's buffer assignment.  There is no generated code.

Cost: the eager step counts every stage, but tracing a full-depth cell on
a 256-rank mesh costs seconds a layer, so the port keeps the reference's
depth extrapolation: cells of more than two stages are traced at one and
two stages and every sum (FLOPs, bytes, collectives, argument, output and
aliased bytes) is extrapolated, total(n) = c1 + (c2 - c1) * (n - 1), which
is exact for identical stages.  The peak of live bytes is a maximum: what
earlier stages leave alive is at it only from the second stage on, so it
takes one more trace, at three stages, and the line through two and three,
temp(n) = t2 + (t3 - t2) * (n - 2).  The per-device FLOPs, bytes and collective bytes feed
``analysis.roofline.roofline`` (one H100 SXM by default).  A decode step
writes the KV cache at position 0, whose slot rank 0 holds on every mesh,
so that the counted rank does the write (the reference's position is a
traced scalar; the cost does not depend on it).

Where DTensor lacks a path that the reference's partitioner has, the
models take their own (``parallel.sharding.local_blocks``: each rank on
its own block through ``local_map``): xLSTM's gates run ``F.logsigmoid``
so (no sharding rule for ``aten.log_sigmoid_backward``), as do its mLSTM
and sLSTM recurrences on (batch, head) blocks (the sLSTM's S steps are
then plain tensor ops, not DTensor dispatches) and Mamba's causal
convolution on (batch, channel) blocks; MusicGen's codebook head is one
product per codebook, stacked; a partial sum is reduced before Mamba adds
its ``dt`` bias.
``reduced_matrix`` (``--reduced-matrix``) traces every reduced arch's
train, prefill and decode step on an 8-rank (4, 2) fake mesh, which this
torch must take whole.

Usage:
  python -m repro_torch.launch.dryrun --arch yi_6b --shape train_4k [--multi-pod]
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--out results/dryrun]
  python -m repro_torch.launch.dryrun --reduced-matrix
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import logging
import os
import time
import traceback
from pathlib import Path

import torch

from repro_torch.analysis.hlo import TraceCounter
from repro_torch.analysis.roofline import model_flops_for, roofline
from repro_torch.configs.registry import ARCH_IDS, SHAPES, ShapeSpec, all_cells, get_arch
from repro_torch.launch import specs as specs_lib
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.launch.steps import step_for_shape
from repro_torch.optim import adamw
from repro_torch.parallel import sharding as sh

__all__ = ["fake_world", "measure_cell", "reduced_matrix", "run_cell", "trace_cell"]

_ORDER = {"train": ("state", "batch"), "prefill": ("params", "batch"),
          "decode": ("params", "cache", "batch")}
# per-device counts a trace gives, each extrapolated over depth
_COUNTS = ("flops", "bytes_accessed", "coll_bytes", "argument_size_in_bytes",
           "output_size_in_bytes", "alias_size_in_bytes", "temp_size_in_bytes")


@contextlib.contextmanager
def fake_world(size: int | None = None):
    """The ``"fake"`` process group at ``size`` ranks (default
    ``$REPRO_TORCH_DRYRUN_DEVICES``, else 512), this process its rank 0;
    destroyed on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    size = size or int(os.environ.get("REPRO_TORCH_DRYRUN_DEVICES", "512"))
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def _local_bytes(t: torch.Tensor) -> int:
    local = t.to_local() if sh.is_dtensor(t) else t
    return local.numel() * local.element_size()


@dataclasses.dataclass
class TracedCell:
    """What one trace of a cell's step counted on rank 0."""

    counts: dict
    collectives: dict  # the counter's CollectiveStats.as_dict()
    seconds: float


def trace_cell(cfg, shape, mesh, opt_cfg=None, grad_compression: str = "none",
               param_rules: dict | None = None, act_rules: dict | None = None) -> TracedCell:
    """Run one step of ``cfg`` at ``shape`` on meta DTensors over ``mesh``
    (a process group of the mesh's size must be initialised) and count it."""
    in_specs, in_axes = specs_lib.input_specs(cfg, shape)
    order = _ORDER[shape.kind]
    if shape.kind == "train":
        step, donate = step_for_shape(cfg, shape, opt_cfg or adamw.AdamWConfig(),
                                      grad_compression=grad_compression)
    else:
        step, donate = step_for_shape(cfg, shape)
    shardings = {k: sh.tree_shardings(in_axes[k], in_specs[k], mesh, param_rules) for k in order}
    t0 = time.perf_counter()
    mode = torch.inference_mode() if shape.kind != "train" else contextlib.nullcontext()
    with mode:
        args = [sh.place(in_specs[k], shardings[k]) for k in order]
        # what rank 0 holds of the inputs: its placed blocks
        arg_bytes = sum(_local_bytes(t) for a in args for t in _leaves(a))
        if shape.kind == "decode":
            args[2] = dict(args[2], pos=0)  # see the module's docstring
        counter = TraceCounter()
        counter.exclude(args)
        with sh.activation_sharding(mesh, act_rules), counter:
            out = step(*args)
    donated = [t for i in donate for t in _leaves(args[i])]
    coll = counter.collectives
    counts = {
        "flops": counter.flops,
        "bytes_accessed": counter.bytes_accessed,
        "coll_bytes": coll.total_bytes,
        "argument_size_in_bytes": arg_bytes,
        "output_size_in_bytes": sum(map(_local_bytes, _leaves(out))),
        "alias_size_in_bytes": sum(_local_bytes(t) for t in donated
                                   if _storage(t) in counter.written),
        "temp_size_in_bytes": counter.peak_bytes,
    }
    return TracedCell(counts, coll.as_dict(), time.perf_counter() - t0)


def _storage(t: torch.Tensor) -> int:
    local = t.to_local() if sh.is_dtensor(t) else t
    return local.untyped_storage()._cdata


def measure_cell(cfg, shape, mesh, **kw) -> tuple[dict, dict, list[TracedCell]]:
    """(per-device counts at ``cfg``'s depth, collectives by op, the traces
    recorded): one trace for up to two stages, else traces at one, two and
    three stages, extrapolated linearly in depth (the module's docstring);
    each after an unrecorded one-stage step that takes the process's
    one-time set-up."""
    n = cfg.n_stages
    pat = len(cfg.stage_pattern)
    # the first step in a process also does one-time set-up (DTensor builds
    # helper meshes and fills its caches): a one-stage step, not recorded
    trace_cell(dataclasses.replace(cfg, n_layers=pat), shape, mesh, **kw)
    if n <= 2:
        traced = trace_cell(cfg, shape, mesh, **kw)
        return traced.counts, traced.collectives, [traced]
    t1, t2, t3 = (trace_cell(dataclasses.replace(cfg, n_layers=k * pat), shape, mesh, **kw)
                  for k in (1, 2, 3))

    def line(a, b):
        return a + (b - a) * (n - 1)

    counts = {k: line(t1.counts[k], t2.counts[k]) for k in _COUNTS}
    # the peak is a maximum, not a sum: from the second stage on, what
    # earlier stages leave alive (the stash a backward reads, the residual)
    # is there at it, so its line starts at two stages
    counts["temp_size_in_bytes"] = t2.counts["temp_size_in_bytes"] + (
        t3.counts["temp_size_in_bytes"] - t2.counts["temp_size_in_bytes"]) * (n - 2)
    colls = {}
    for key in ("bytes_by_op", "count_by_op"):
        ops = set(t1.collectives[key]) | set(t2.collectives[key])
        colls[key] = {op: line(t1.collectives[key].get(op, 0), t2.collectives[key].get(op, 0))
                      for op in sorted(ops)}
    colls["total_bytes"] = sum(colls["bytes_by_op"].values())
    colls["total_count"] = sum(colls["count_by_op"].values())
    return counts, colls, [t1, t2, t3]


def run_cell(
    arch: str,
    shape_name: str,
    multi_pod: bool = False,
    out_dir: str | Path = "results/dryrun",
    grad_compression: str | None = None,
    remat: str | None = None,
    rules_override: dict | None = None,
    cfg_overrides: dict | None = None,
    moment_dtype: str | None = None,
    tag: str = "",
) -> dict:
    """Trace one cell on the production mesh; returns (and writes) the
    record dict (the reference's keys)."""
    shape = SHAPES[shape_name]
    cfg = get_arch(arch).with_dtypes("bfloat16", "bfloat16")
    if remat is not None:
        cfg = dataclasses.replace(cfg, remat=remat)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    # llama4-400B: bf16 optimizer moments (16-bit optimizer), as the reference
    opt_cfg = adamw.AdamWConfig(
        moment_dtype=moment_dtype or ("bfloat16" if "llama4" in arch else "float32")
    )
    comp = grad_compression or ("bf16" if multi_pod else "none")
    param_rules = dict(sh.DEFAULT_PARAM_RULES)
    act_rules = dict(sh.DEFAULT_ACT_RULES)
    if rules_override:
        param_rules.update(rules_override.get("param", {}))
        act_rules.update(rules_override.get("act", {}))

    t0 = time.time()
    record = {
        "arch": arch,
        "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "chips": 512 if multi_pod else 256,
        "kind": shape.kind,
        "grad_compression": comp if shape.kind == "train" else None,
        "remat": cfg.remat,
        "tag": tag,
    }
    try:
        with fake_world():
            mesh = make_production_mesh(multi_pod=multi_pod, device_type="cuda")
            record["chips"] = mesh.size()
            counts, colls, traces = measure_cell(
                cfg, shape, mesh, opt_cfg=opt_cfg, grad_compression=comp,
                param_rules=param_rules, act_rules=act_rules)
        deepest = traces[-1]
        rf = roofline(counts["flops"], counts["bytes_accessed"], counts["coll_bytes"],
                      record["chips"], model_flops_for(cfg, shape))
        record.update(
            status="ok",
            compile_s=round(time.time() - t0, 2),
            memory={k: int(counts[k]) for k in _COUNTS[3:]},
            cost={"flops": float(deepest.counts["flops"]),
                  "bytes accessed": float(deepest.counts["bytes_accessed"])},
            cost_extrapolated={
                "flops_per_device": float(counts["flops"]),
                "bytes_per_device": float(counts["bytes_accessed"]),
                "coll_bytes_per_device": float(counts["coll_bytes"]),
            },
            collectives=colls,
            roofline=rf.as_dict(),
            hlo_bytes=None,  # no HLO: the step is traced eagerly
            traced_stages=[min(cfg.n_stages, i + 1) for i in range(len(traces))]
            if len(traces) > 1 else [cfg.n_stages],
            trace_s=[round(t.seconds, 2) for t in traces],
        )
    except Exception as e:  # record failures — they are bugs to fix
        record.update(
            status="error",
            compile_s=round(time.time() - t0, 2),
            error=f"{type(e).__name__}: {e}",
            traceback=traceback.format_exc()[-4000:],
        )

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    name = f"{arch}__{shape_name}__{record['mesh']}" + (f"__{tag}" if tag else "")
    (out_dir / f"{name}.json").write_text(json.dumps(record, indent=1))
    return record


def reduced_matrix(archs=ARCH_IDS) -> dict:
    """Trace each reduced arch (bf16) at ``ShapeSpec("t", kind, 64, 8)`` for
    every step kind on a (4, 2) ("data", "model") mesh of an 8-rank fake
    process group: {"arch/kind": {"status": "ok", "flops", "seconds"}, or
    {"status": the error, "traceback"}}."""
    out = {}
    with fake_world(8):
        mesh = make_mesh((4, 2), ("data", "model"), device_type="cuda")
        for arch in archs:
            cfg = get_arch(arch).reduced().with_dtypes("bfloat16", "bfloat16")
            for kind in _ORDER:
                try:
                    traced = trace_cell(cfg, ShapeSpec("t", kind, 64, 8), mesh)
                    out[f"{arch}/{kind}"] = {"status": "ok", "flops": traced.counts["flops"],
                                             "seconds": traced.seconds}
                except Exception as e:  # recorded: each cell is a case of its own
                    out[f"{arch}/{kind}"] = {"status": f"{type(e).__name__}: {e}",
                                             "traceback": traceback.format_exc()[-4000:]}
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--reduced-matrix", action="store_true",
                    help="trace every reduced arch x step kind on an 8-rank (4, 2) fake mesh; "
                    "prints one line a cell, then the results as one JSON line")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--grad-compression", default=None)
    ap.add_argument("--remat", default=None)
    ap.add_argument("--moment-dtype", default=None)
    ap.add_argument("--tag", default="")
    ap.add_argument(
        "--cfg", default=None,
        help='JSON dict of ArchConfig overrides, e.g. \'{"loss_chunk": 512}\'',
    )
    ap.add_argument(
        "--rules", default=None,
        help='JSON sharding-rule overrides: {"param": {...}, "act": {...}}; '
        "rule values are lists of mesh-axis-name lists, e.g. "
        '\'{"param": {"expert_embed": []}, "act": {"expert_embed": []}}\'',
    )
    args = ap.parse_args()
    # DTensor warns on every multi-step redistribution; the counts say it
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)
    if args.reduced_matrix:
        matrix = reduced_matrix()
        for cell, rec in matrix.items():
            print(f"{'OK  ' if rec['status'] == 'ok' else 'FAIL'} {cell:32s} {rec['status'][:300]}",
                  flush=True)
        print(json.dumps(matrix))
        return 0 if all(rec["status"] == "ok" for rec in matrix.values()) else 1
    cfg_overrides = json.loads(args.cfg) if args.cfg else None
    rules_override = None
    if args.rules:
        raw = json.loads(args.rules)
        rules_override = {
            kind: {ax: tuple(tuple(g) for g in groups) for ax, groups in d.items()}
            for kind, d in raw.items()
        }

    cells = all_cells() if args.all else [(args.arch, args.shape)]
    failures = 0
    for arch, shape in cells:
        rec = run_cell(
            arch,
            shape,
            multi_pod=args.multi_pod,
            out_dir=args.out,
            grad_compression=args.grad_compression,
            remat=args.remat,
            rules_override=rules_override,
            cfg_overrides=cfg_overrides,
            moment_dtype=args.moment_dtype,
            tag=args.tag,
        )
        if rec["status"] == "ok":
            r = rec["roofline"]
            m = rec["memory"]
            print(
                f"OK   {arch:24s} {shape:12s} {rec['mesh']:8s} "
                f"trace={rec['compile_s']:7.1f}s "
                f"t_comp={r['t_compute_s']:.3e} t_mem={r['t_memory_s']:.3e} "
                f"t_coll={r['t_collective_s']:.3e} dom={r['dominant']:10s} "
                f"frac={r['roofline_fraction']:.3f}",
                flush=True,
            )
            print(
                f"     memory: args={m['argument_size_in_bytes'] / 2**30:.2f}GiB "
                f"out={m['output_size_in_bytes'] / 2**30:.2f}GiB "
                f"temp={m['temp_size_in_bytes'] / 2**30:.2f}GiB per device | "
                f"flops/dev={r['flops_per_device']:.3e} "
                f"bytes/dev={r['bytes_per_device']:.3e} "
                f"coll_bytes/dev={r['coll_bytes_per_device']:.3e} "
                f"collectives={rec['collectives']['total_count']}",
                flush=True,
            )
        else:
            failures += 1
            print(f"FAIL {arch:24s} {shape:12s} {rec['mesh']:8s} {rec['error']}", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
