"""One run of one cell: set-up, the measured window, the traced steps,
the comparison with the plain reference, and the result line.

Everything that belongs to one configuration, traffic mix, metric or
reference family is a file of its own, found by the name
``BENCHMARK.json`` gives it:

* ``configs/<config>.json``: the sizes as run (``model``, which the
  reference reads), the port's registry entry and the keys replaced in it
  (``port``), the served type, the reference family, what was cut, assumed
  and departs from the registry;
* ``traffic/<traffic>.json``: a closed loop of prefill steps, ``batch``
  prompts of ``prompt_len`` fresh token ids a step, one step in flight;
* ``metrics/<metric>.py``: ``read(run) -> float | None`` of a ``Run``;
* ``reference/<family>.py``: ``param_specs``, ``active_matmul_params`` and
  ``last_logits`` (plain PyTorch, float32);
* ``limits/<workload>.json``: the numbers ``check`` compares and their
  limits.

The benchmark draws every weight and token id on the device from the
seed, hands the same weight tensors to the program (a ``meta`` model
loaded with ``assign=True``) and to the reference, and runs only
``repro_torch.models.model.forward(cfg, params, tokens, last_only=True)``
in the window.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import statistics
import sys
import time
from pathlib import Path

import torch

from portbench import check, counts
from portbench import trace as tracing

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
# Top-level module names that may not be loaded in a run: JAX and the JAX
# package this program was ported from.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")
TOKEN_STREAM = 0x9E3779B97F4A7C15  # the token ids' generator: seed xor this


@dataclasses.dataclass
class Step:
    start: float  # host clock: before the draw
    dispatch: float  # the call to forward
    done: float  # logits on the host


@dataclasses.dataclass
class Run:
    """What a metric reader reads."""
    model: dict
    family: object
    traffic: dict
    on_card: bool
    peaks: dict | None
    setup_s: float
    steps: list
    window_s: float
    trace: tracing.Trace | None = None

    @property
    def batch(self) -> int:
        return self.traffic["batch"]

    @property
    def seq(self) -> int:
        return self.traffic["prompt_len"]

    @property
    def tokens_per_step(self) -> int:
        return self.batch * self.seq


def load_module(path: Path):
    name = "portbench_file_" + "_".join(path.relative_to(PKG).with_suffix("").parts).replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_json(kind: str, name: str) -> dict:
    return json.loads((PKG / kind / f"{name}.json").read_text())


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    family: object
    end_to_end: list  # metric entries of BENCHMARK.json that this cell reports
    per_layer: list
    limits: dict | None


def load_cell(workload: str) -> Cell:
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    config = load_json("configs", entry["config"])
    family = load_module(PKG / "reference" / f"{config['family']}.py")

    def mine(metrics):
        return [m for m in metrics if workload in m.get("workloads", [workload])]

    return Cell(workload, entry["chips"], config, load_json("traffic", entry["traffic"]), family,
                mine(bench["end_to_end"]), mine(bench["per_layer"]), check.load_limits(workload))


def port_config(config: dict):
    """The program's ``ArchConfig``: the registry entry, the keys the file
    replaces, the served type; every size the reference reads that the
    config also holds must agree with it."""
    from repro_torch.configs.registry import get_arch

    port = config["port"]
    cfg = dataclasses.replace(get_arch(port["arch"]), **port["replace"])
    cfg = cfg.with_dtypes(config["dtype"], config["dtype"])
    fields = {f.name for f in dataclasses.fields(cfg)}
    differ = {k: (v, getattr(cfg, k)) for k, v in config["model"].items()
              if k in fields and getattr(cfg, k) != v}
    if differ:
        raise ValueError(f"{config['name']}: the program's config departs from the file: {differ}")
    return cfg


def draw_weights(specs: dict, seed: int, device, dtype: torch.dtype) -> dict:
    """Every weight from one generator on ``device`` seeded with ``seed``,
    one call per stacked leaf in name order, in ``dtype``."""
    gen = torch.Generator(device=device).manual_seed(seed % 2**64)
    weights = {}
    for name in sorted(specs):
        shape, init = specs[name]
        t = torch.randn(shape, generator=gen, dtype=dtype, device=device)
        if init == "norm":
            t.mul_(0.1).add_(1.0)
        else:
            t.mul_(init)
        weights[name] = t
    return weights


def load_program(cfg, weights: dict):
    """The program's ``Model`` holding ``weights`` themselves (no copy)."""
    from repro_torch.models.model import Model

    model = Model(cfg, None, device="meta")
    model.load_state_dict(weights, strict=True, assign=True)
    return model


def forward(cfg, model, tokens):
    """The window's entry: the serving prefill path on its default route."""
    from repro_torch.models.model import forward as program_forward

    return program_forward(cfg, model, tokens, last_only=True)[0]


def token_draw(traffic: dict, vocab: int, seed: int, device):
    gen = torch.Generator(device=device).manual_seed((seed ^ TOKEN_STREAM) % 2**64)
    shape = (traffic["batch"], traffic["prompt_len"])
    return lambda: torch.randint(0, vocab, shape, generator=gen, dtype=torch.int32, device=device)


def run_steps(program, draw, *, seconds: float | None = None, count: int | None = None,
              keep=None) -> list:
    """Closed loop, one step in flight: draw a batch, call the program,
    bring its logits to the host; until ``count`` steps are done or a step
    ends ``seconds`` after the first began."""
    from torch.profiler import record_function

    steps = []
    begin = time.perf_counter()
    while True:
        with record_function("portbench.step"):
            start = time.perf_counter()
            with record_function("portbench.draw"):
                tokens = draw()
            with record_function("portbench.forward"):
                dispatch = time.perf_counter()
                logits = program(tokens)
            with record_function("portbench.sync"):
                host = logits.to("cpu")
                done = time.perf_counter()
        steps.append(Step(start, dispatch, done))
        if keep is not None:
            keep(tokens, host)
        if count is not None and len(steps) >= count:
            return steps
        if seconds is not None and done - begin >= seconds:
            return steps


def traced_steps(program, draw, n: int) -> tracing.Trace:
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        run_steps(program, draw, count=n + 1)  # the first is the profiler's warm-up
    return tracing.parse(tracing.export(prof))


def reference_logits(cell: Cell, weights: dict, tokens, info: dict) -> list:
    """The reference's answer for each prompt of ``tokens``, on the host:
    its (V,) logits, or where the cell's limits give a ``route_margin``,
    its (C, V) candidates (``reference/mixtral.py``)."""
    model = cell.config["model"]
    margin = (cell.limits or {}).get("route_margin")
    if margin is not None:
        return [c.cpu() for c in cell.family.last_logit_candidates(model, weights, tokens,
                                                                   margin["value"], info)]
    kwargs = {}
    if "num_experts" in model:
        kwargs["expert_loads"] = info.setdefault("expert_loads", [])
    return list(cell.family.last_logits(model, weights, tokens, **kwargs).cpu())


def metric_value(entry: dict, run: Run):
    value = load_module(PKG / "metrics" / f"{entry['name']}.py").read(run)
    if value is None:
        return None
    return {"value": float(value), "unit": entry["unit"]}


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN_MODULES))


def execute(workload: str, seed: int, seconds: float, trace: bool, *, device, t0: float,
            program=forward, out=None, phases=None) -> int:
    """One run; prints the result as the last line of ``out`` (standard
    output by default) and the numbers compared, each beside its limit,
    as the last lines of standard error.  Returns the exit code."""
    out = out or sys.stdout
    err = sys.stderr
    cell = load_cell(workload)
    model_doc, traffic = cell.config["model"], cell.traffic
    if traffic.get("loop") != "closed" or traffic.get("in_flight") != 1:
        raise ValueError(f"{traffic['name']}: the generator runs a closed loop with one step in flight")
    on_card = device.type == "cuda"
    cfg = port_config(cell.config)
    dtype = getattr(torch, cell.config["dtype"])
    phases = dict(phases or {}, config=time.perf_counter() - t0)
    weights = draw_weights(cell.family.param_specs(model_doc), seed, device, dtype)
    prog_model = load_program(cfg, weights)
    if on_card:
        torch.cuda.synchronize()
    phases["weights"] = time.perf_counter() - t0

    def call(tokens):
        return program(cfg, prog_model, tokens)

    draw = token_draw(traffic, model_doc["vocab_size"], seed, device)
    run_steps(call, draw, count=traffic["warmup_steps"])
    if on_card:
        from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd
        torch.cuda.synchronize()
        k7_before = flash_attention_fwd.tc_launches
    setup_s = time.perf_counter() - t0
    phases["warm-up"] = setup_s

    kept = []
    steps = run_steps(call, draw, seconds=seconds, keep=lambda t, h: kept.append((t, h)))
    window_s = steps[-1].done - steps[0].start
    if on_card:
        k7_per_step = (flash_attention_fwd.tc_launches - k7_before) / len(steps)
    trace_doc = traced_steps(call, draw, traffic["trace_steps"]) if trace else None
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
                   "count": cell.chips if on_card else 1}
    if on_card:
        device_info["memory_peak_bytes"] = torch.cuda.max_memory_allocated(device)
    if trace_doc is not None and on_card:
        device_info["busy_s"] = trace_doc.busy_s
        device_info["window_s"] = trace_doc.window_s
    del prog_model
    if on_card:
        torch.cuda.empty_cache()

    # the comparison, after the window: a sample of its steps from the seed
    info = {}
    chosen = check.sample_steps(len(kept), traffic["check_steps"], seed)
    t_check = time.perf_counter()
    prog_rows, ref_rows = [], []
    for i in chosen:
        tokens, host = kept[i]
        ref_rows += reference_logits(cell, weights, tokens, info)
        prog_rows.append(host.float())
    nums = check.numbers(torch.cat(prog_rows), ref_rows)
    correct, compared = check.judge(nums, cell.limits)
    check_s = time.perf_counter() - t_check

    run = Run(model_doc, cell.family, traffic, on_card,
              counts.peaks_for(device_info["kind"]) if on_card else None,
              setup_s, steps, window_s, trace_doc)
    entries = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for entry in entries:
        value = metric_value(entry, run)
        if value is not None:
            metrics[entry["name"]] = value

    prompts = len(steps) * traffic["batch"]
    print(f"{workload} seed {seed}: {len(steps)} steps ({prompts} prompts) in {window_s:.3f} s, "
          f"set-up {setup_s:.3f} s; checked steps {chosen} against the reference in "
          f"{check_s:.1f} s", file=err)
    print("set-up ends (s from process start): "
          + ", ".join(f"{k} {v:.3f}" for k, v in phases.items()), file=err)
    walls = [f"{1e3 * (s.done - s.dispatch):.2f}" for s in steps[:3]]
    print(f"the window's first steps (ms) {', '.join(walls)}; median "
          f"{1e3 * statistics.median(s.done - s.dispatch for s in steps):.2f}", file=err)
    if on_card:
        print(f"K7 bf16 launches a step {k7_per_step:g}", file=err)
    if info.get("expert_loads"):
        t = traffic["batch"] * traffic["prompt_len"]
        capacity = max(int(t * model_doc["top_k"] * model_doc["capacity_factor"])
                       // model_doc["num_experts"], 1)
        print(f"largest expert load over the checked steps' layers {max(info['expert_loads'])} "
              f"slots, the program's capacity {capacity}", file=err)
    if info.get("paths"):
        print(f"reference paths of each checked prompt's last token {info['paths']}, "
              f"{info['capped']} prompts cut to the nearest", file=err)
    print("numbers: " + ", ".join(f"{k} {v!r}" for k, v in nums.items()), file=err)
    if not cell.limits:
        print(f"no limits file for {workload}: not correct", file=err)
    for name, c in compared.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=err)

    bad = forbidden_modules()
    if bad:
        print(f"loaded in this process: {', '.join(bad)}; no result", file=err)
        return 3
    result = {"correct": bool(correct), "attempted": prompts, "failed": 0, "metrics": metrics,
              "device": device_info}
    if trace_doc is not None and on_card:
        result["breakdown"] = trace_doc.breakdown()
    result["checks"] = compared
    print(json.dumps(result), file=out, flush=True)
    return 0


def main(argv=None, t0: float | None = None) -> int:
    import argparse

    t0 = time.perf_counter() if t0 is None else t0
    phases = {"imports": time.perf_counter() - t0}
    parser = argparse.ArgumentParser(description="Run one cell of the port's benchmark.")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    cell = load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    torch.zeros(1, device="cuda")
    phases["cuda"] = time.perf_counter() - t0
    return execute(args.workload, args.seed, args.seconds, bool(args.trace),
                   device=torch.device("cuda", 0), t0=t0, phases=phases)
