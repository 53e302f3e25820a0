"""Device time and idle gaps charged to the program's own spans.

A trace exported while ``repro_torch.obs.tracing()`` is on holds the
program's ``model.*`` spans on the host beside the harness's
``portbench.*`` ones, which ``trace.parse`` reads as it reads any trace.
Here each device record of a full step (``trace.parse``'s steps) is
joined to the call that launched it through the ``correlation`` arg that
the profiler writes on both (launches: categories ``cuda_runtime`` and
``cuda_driver``), and charged to every program span that encloses that
launch on the host thread, once each; its self time goes to the
innermost.  Each idle gap under ``portbench.forward`` is cut at the
program spans' edges and each piece charged to the innermost program
span (``portbench.forward`` where none encloses it).

    python -m portbench.spans --workload <name> --seed <n>

runs a cell's traced steps on the card twice, plain and then under
``obs.tracing()``, and prints to standard error a line per program span
(self device ms, launches and idle ms a step), the spans' on-cost (the
traced steps' mean wall, span pass minus plain pass), the off-cost of a
span, the coverage and the share of records matched to a launch, and the
block metrics of ``METRICS``; their JSON is the last line of standard
output.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from collections import defaultdict

from portbench import trace as tracing

PROGRAM_PREFIX = "model."
LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")
FORWARD = "portbench.forward"
# The block spans: everything under model.forward but the residual adds.
BLOCKS = ("model.embed", "model.attn", "model.mlp", "model.moe", "model.norm", "model.head")


@dataclasses.dataclass
class Spans:
    steps: int  # full steps read
    records: list  # (device us, enclosing program spans outermost first) of each matched record
    unmatched: int  # device records whose launch was not found
    idle: dict  # innermost program span (or FORWARD) -> idle us under FORWARD
    opened: dict  # program span -> times entered

    def device_ms(self, any_of, none_of=()) -> float | None:
        """Device ms a step of the records launched under a span of
        ``any_of`` and under none of ``none_of``; None where no span of
        ``any_of`` was entered."""
        if not self.steps or not set(any_of) & set(self.opened):
            return None
        us = sum(d for d, names in self.records
                 if set(names) & set(any_of) and not set(names) & set(none_of))
        return us / 1e3 / self.steps

    def by_span(self) -> dict:
        """Innermost span (None: outside them) -> (self device ms, launches, idle ms) a step."""
        out = defaultdict(lambda: [0.0, 0, 0.0])
        for d, names in self.records:
            row = out[names[-1] if names else None]
            row[0] += d / 1e3 / self.steps
            row[1] += 1 / self.steps
        for name, us in self.idle.items():
            out[None if name == FORWARD else name][2] += us / 1e3 / self.steps
        return {k: tuple(v) for k, v in out.items()}

    @property
    def matched_share(self) -> float:
        return len(self.records) / max(len(self.records) + self.unmatched, 1)

    @property
    def coverage(self) -> float | None:
        """Share of the device time launched inside model.forward that a block span holds."""
        inside = [(d, names) for d, names in self.records if "model.forward" in names]
        total = sum(d for d, _ in inside)
        if not total:
            return None
        return sum(d for d, names in inside if set(names) & set(BLOCKS)) / total


def _enclosing(spans: list, times: list) -> list:
    """For each of ``times`` (sorted), the names of the spans (start, end,
    name) that hold it, outermost first; spans on one thread nest."""
    spans = sorted(spans, key=lambda s: (s[0], -s[1]))
    out, stack, j = [], [], 0
    for t in times:
        while j < len(spans) and spans[j][0] <= t:
            while stack and stack[-1][1] <= spans[j][0]:
                stack.pop()
            stack.append(spans[j])
            j += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        out.append(tuple(s[2] for s in stack))
    return out


def read(doc: dict) -> Spans:
    steps = tracing.parse(doc).full_steps
    events = [e for e in doc.get("traceEvents", []) if e.get("ph") == "X" and "dur" in e]
    launches = {e["args"]["correlation"]: (float(e["ts"]), e.get("tid")) for e in events
                if e.get("cat") in LAUNCH_CATEGORIES and "correlation" in e.get("args", {})}
    program = defaultdict(list)  # host thread -> [(start, end, name)]
    forward = []
    for e in events:
        name = str(e.get("name", ""))
        if e.get("cat") != "user_annotation":
            continue
        start, end = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        if name.startswith(PROGRAM_PREFIX):
            program[e.get("tid")].append((start, end, name))
        elif name == FORWARD:
            forward.append((name, start, end))
    held = {}  # correlation -> enclosing program spans of its launch
    for tid, spans in program.items():
        mine = sorted((ts, c) for c, (ts, t) in launches.items() if t == tid)
        held.update(zip((c for _, c in mine), _enclosing(spans, [ts for ts, _ in mine])))
    device = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                     e.get("args", {}).get("correlation")) for e in events
                    if e.get("cat") in tracing.DEVICE_CATEGORIES
                    and e.get("name") not in tracing.PROFILER_OWN)
    host = [(s, t, name) for name, s, t in forward] + [sp for v in program.values() for sp in v]
    records, unmatched, idle, opened = [], 0, defaultdict(float), defaultdict(int)
    for step in steps:
        s0, s1 = step.start, step.end
        mine = [(a, b, c) for a, b, c in device if s0 <= a < s1]
        for a, b, c in mine:
            if c in launches:
                records.append((b - a, held.get(c, ())))
            else:
                unmatched += 1
        for s, _, name in host:
            opened[name] += s0 <= s < s1 and name.startswith(PROGRAM_PREFIX)
        # the step cut at every span's and every busy interval's edge; each
        # idle piece under FORWARD goes to the innermost span at its start
        busy = tracing._union([(a, min(b, s1)) for a, b, _ in mine])
        points = sorted({s0, s1} | {t for s, e, _ in host for t in (s, e) if s0 < t < s1}
                        | {t for a, b in busy for t in (a, b) if s0 < t < s1})
        i = 0
        for t0, t1, names in zip(points, points[1:], _enclosing(host, points[:-1])):
            while i < len(busy) and busy[i][1] <= t0:
                i += 1
            if FORWARD in names and not (i < len(busy) and busy[i][0] <= t0):
                idle[names[-1]] += t1 - t0
    return Spans(len(steps), records, unmatched, dict(idle), {k: v for k, v in opened.items() if v})


def expert_row_use_pct(counters: dict) -> float | None:
    """Slots the MoE computed over the expert rows its products ran."""
    if not counters.get("moe.expert_rows"):
        return None
    kept = counters["moe.slots"] - counters.get("moe.slots_dropped", 0)
    return 100.0 * kept / counters["moe.expert_rows"]


METRICS = {
    "attn_device_ms.prefill": lambda s: s.device_ms({"model.attn"}),
    "mlp_device_ms.prefill": lambda s: s.device_ms({"model.mlp", "model.moe.experts"}),
    "moe_route_device_ms.prefill": lambda s: s.device_ms({"model.moe"}, {"model.moe.experts"}),
    "norm_rope_device_ms.prefill": lambda s: s.device_ms({"model.norm", "model.rope"}),
}


def off_cost_ns(n: int = 1_000_000) -> float:
    """ns a gated-off span costs on this host: ``with obs.span(...)`` in a loop."""
    from repro_torch import obs

    t = time.perf_counter()
    for _ in range(n):
        with obs.span("model.attn"):
            pass
    return (time.perf_counter() - t) / n * 1e9


def measure(workload: str, seed: int, device) -> dict:
    """A cell's traced steps, plain and under ``obs.tracing()``; prints the
    lines to standard error and returns what they say."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from portbench import harness
    from repro_torch import obs

    err = sys.stderr
    cell = harness.load_cell(workload)
    model_doc, traffic = cell.config["model"], cell.traffic
    cfg = harness.port_config(cell.config)
    dtype = getattr(torch, cell.config["dtype"])
    weights = harness.draw_weights(cell.family.param_specs(model_doc), seed, device, dtype)
    program = harness.load_program(cfg, weights)

    def call(tokens):
        return harness.forward(cfg, program, tokens)

    draw = harness.token_draw(traffic, model_doc["vocab_size"], seed, device)
    harness.run_steps(call, draw, count=traffic["warmup_steps"])
    n = traffic["trace_steps"]
    plain = harness.traced_steps(call, draw, n)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with obs.tracing():
        with profile(activities=activities) as prof:
            harness.run_steps(call, draw, count=n + 1)  # the first is the profiler's warm-up
        counters = obs.counters()
    doc = tracing.export(prof)
    traced, spans = tracing.parse(doc), read(doc)

    def wall_ms(t):
        return 1e3 * t.window_s / len(t.full) if t.full else float("nan")

    on_ms = wall_ms(traced) - wall_ms(plain)
    off_ns = off_cost_ns()
    per_forward = sum(spans.opened.values()) / max(spans.steps, 1)
    out = {"workload": workload, "seed": seed, "steps": spans.steps,
           "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "metrics": {k: f(spans) for k, f in METRICS.items()},
           "counters": counters, "coverage": spans.coverage,
           "matched_share": spans.matched_share, "unmatched": spans.unmatched,
           "spans_per_forward": per_forward, "on_cost_ms": on_ms,
           "on_cost_pct": 100 * on_ms / wall_ms(plain), "off_cost_ns_per_span": off_ns,
           "off_cost_ms_per_forward": off_ns * per_forward / 1e6,
           "plain_step_ms": wall_ms(plain), "span_step_ms": wall_ms(traced)}
    out["metrics"]["expert_row_use_pct.prefill"] = expert_row_use_pct(counters)
    for name, (ms, launches, idle) in sorted(spans.by_span().items(), key=lambda kv: -kv[1][0]):
        print(f"span {name or '(no program span: draw, sync, outside model.forward)'}: self device "
              f"{ms:.4f} ms, {launches:g} launches, idle {idle:.4f} ms a step", file=err)
    print(f"on-cost: {on_ms:.3f} ms a traced step ({out['on_cost_pct']:.3f}%), "
          f"{out['span_step_ms']:.3f} against {out['plain_step_ms']:.3f} ms", file=err)
    print(f"off-cost: {off_ns:.1f} ns a span x {per_forward:g} spans a forward = "
          f"{out['off_cost_ms_per_forward']:.4f} ms", file=err)
    print(f"coverage {spans.coverage}, records matched {spans.matched_share:.6f} "
          f"({spans.unmatched} unmatched); counters {counters}", file=err)
    print("metrics: " + ", ".join(f"{k} {v!r}" for k, v in out["metrics"].items()), file=err)
    return out


def main(argv=None) -> int:
    import torch

    parser = argparse.ArgumentParser(description="Charge a cell's device time to the program's spans.")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    out = measure(args.workload, args.seed, torch.device("cuda", 0))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    from portbench import run  # noqa: F401  (build caches inside the checkout, src on the path)

    sys.exit(main())
