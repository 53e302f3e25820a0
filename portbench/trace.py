"""Reading a ``torch.profiler`` trace of a few steady steps.

The harness marks each step with ``record_function`` spans
(``portbench.step`` around ``portbench.draw``, ``portbench.forward`` and
``portbench.sync``).  The trace is exported as Chrome JSON into a
temporary directory and read back here: device operations (kernels,
copies, memsets) with their start and length, and the harness's spans on
the host, all on the profiler's one clock.

Step ``i`` owns the device time from its ``portbench.step`` start to the
next step's start (the last: to its own end); a kernel belongs to the step
in which it starts, which is the step that launched it, since every step
ends in a synchronising copy.  The device's idle time is cut by what the
host was doing: each piece of a gap goes to the innermost harness span
that held the host then (``portbench.loop`` outside them).  The first traced step is the profiler's
warm-up and is left out.  The profiler on this card has been seen to lose
a block of device records in about one trace in twelve, so a step that
holds fewer device records than the fullest step is left out as well:
every step runs the same operations.
"""

from __future__ import annotations

import dataclasses
import json
import tempfile
from collections import defaultdict
from pathlib import Path

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
# Device-side records the profiler makes for itself.
PROFILER_OWN = ("Activity Buffer Request",)
SPAN_PREFIX = "portbench."


@dataclasses.dataclass
class StepTrace:
    start: float  # microseconds on the profiler's clock
    end: float
    records: int
    busy: float  # microseconds with an operation running
    ops: dict  # device operation name -> (microseconds, count)
    gaps: dict  # host span name -> idle microseconds


@dataclasses.dataclass
class Trace:
    steps: list  # StepTrace of every traced step but the first
    full: list  # indices into steps of those that lost no record

    @property
    def full_steps(self) -> list:
        return [self.steps[i] for i in self.full]

    @property
    def busy_s(self) -> float:
        return sum(s.busy for s in self.full_steps) / 1e6

    @property
    def window_s(self) -> float:
        return sum(s.end - s.start for s in self.full_steps) / 1e6

    def op_seconds(self) -> dict:
        """Device seconds and launches by operation name over the full steps."""
        total = defaultdict(lambda: [0.0, 0])
        for s in self.full_steps:
            for name, (us, n) in s.ops.items():
                total[name][0] += us / 1e6
                total[name][1] += n
        return {k: tuple(v) for k, v in total.items()}

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(((name, sec) for name, (sec, _) in self.op_seconds().items()),
                     key=lambda kv: -kv[1])[:top]
        gaps = defaultdict(float)
        for s in self.full_steps:
            for name, us in s.gaps.items():
                gaps[name] += us / 1e6
        idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n[:120], v] for n, v in ops],
                "idle_gaps": [[n, v] for n, v in idle]}


def export(prof) -> dict:
    """The profiler's Chrome trace as a dict, through a temporary file."""
    with tempfile.TemporaryDirectory(prefix="portbench-trace-") as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        return json.loads(path.read_text())


def _union(intervals: list) -> list:
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _innermost(spans: list, t: float) -> str:
    inside = [(end - start, name) for name, start, end in spans if start <= t < end]
    return min(inside)[1] if inside else SPAN_PREFIX + "loop"


def _split(spans: list, a: float, b: float) -> list:
    """[(host span name, microseconds)] of the idle gap [a, b), cut where a
    span begins or ends, each piece under the innermost span at its start."""
    cuts = sorted({a, b} | {t for _, s0, s1 in spans for t in (s0, s1) if a < t < b})
    return [(_innermost(spans, t0), t1 - t0) for t0, t1 in zip(cuts, cuts[1:])]


def parse(doc: dict) -> Trace:
    events = [e for e in doc.get("traceEvents", []) if e.get("ph") == "X" and "dur" in e]
    device = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in events
                    if e.get("cat") in DEVICE_CATEGORIES and e.get("name") not in PROFILER_OWN)
    spans = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
             if e.get("cat") == "user_annotation" and str(e.get("name", "")).startswith(SPAN_PREFIX)]
    starts = sorted((s, end) for name, s, end in spans if name == SPAN_PREFIX + "step")
    steps = []
    for i, (s0, s_end) in enumerate(starts):
        s1 = starts[i + 1][0] if i + 1 < len(starts) else s_end
        mine = [(a, b, n) for a, b, n in device if s0 <= a < s1]
        ops = defaultdict(lambda: [0.0, 0])
        for a, b, n in mine:
            ops[n][0] += b - a
            ops[n][1] += 1
        busy = _union([(a, min(b, s1)) for a, b, _ in mine])
        gaps = defaultdict(float)
        edge = s0
        near = [sp for sp in spans if sp[1] < s1 and sp[2] > s0]
        for a, b in busy + [[s1, s1]]:
            if a > edge:
                for name, us in _split(near, edge, a):
                    gaps[name] += us
            edge = max(edge, b)
        steps.append(StepTrace(s0, s1, len(mine), sum(b - a for a, b in busy),
                               {k: tuple(v) for k, v in ops.items()}, dict(gaps)))
    steps = steps[1:]  # the profiler's warm-up
    most = max((s.records for s in steps), default=0)
    full = [i for i, s in enumerate(steps) if s.records == most and most > 0]
    return Trace(steps, full)
