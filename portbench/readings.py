"""Readings that the limits of ``check`` are set from, on the card; the
benchmark's runs never run this.

    python -m portbench.readings --workload <name> --seeds 1,2,... \
        [--control-seeds 1,2,3] [--margins 0,0.05,...] [--out <file>]

For each seed, in one process: the weights drawn as a run draws them, the
program driven through ``harness.run_steps`` for the traffic's
``check_steps`` steps at the cell's own load (the window's entry, batch
and prompt length), and the compared numbers of the program's logits
against the float32 reference.  For a control seed also:

* the control, the reference computed with every weight product in
  float8 e4m3 (``_plain.fp8_mm``), its numbers taken at the token it puts
  first;
* the faults of ``faults.py`` that the cell can have, applied to the
  program's logits: a served token altered where it is produced,
  and (batch > 1) half of the batch left out.

With ``--margins`` (a mixture of experts), every number is read against
the reference's candidates (``last_logit_candidates``) at each margin,
and each prompt's last token is followed on both sides (the program's
through a wrapper of ``models.blocks._top_k``): the layers where its
experts differ, and up to the first of them the router's error, the
widest gap between two experts' logit differences on the two sides,
which is what a margin has to cover.

Writes every reading as JSON to ``--out`` and a summary to standard error.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

from portbench import check, faults, harness
from portbench.reference import _plain


class RouteRecorder:
    """Wraps the program's top-k to keep each prompt's last token's
    experts, (B, k), and router log-probabilities, (B, E), a layer."""

    def __init__(self, seq: int):
        from repro_torch.models import blocks

        self.blocks, self.seq, self.routes, self.logp = blocks, seq, [], []
        self.inner = blocks._top_k

        def top_k(probs, k):
            vals, idx = self.inner(probs, k)
            self.routes.append(idx.reshape(-1, self.seq, k)[:, -1].cpu())
            self.logp.append(probs.reshape(-1, self.seq, probs.shape[-1])[:, -1].double().log().cpu())
            return vals, idx

        blocks._top_k = top_k

    def close(self):
        self.blocks._top_k = self.inner


def follow(prog_routes: list, prog_logp: list, ref_routes: list, ref_logits: list) -> list:
    """Per prompt: the layers where the last token's expert sets differ,
    and the router's error up to and including the first of them."""
    out = []
    for b in range(ref_routes[0].shape[0]):
        flips, error = [], 0.0
        for layer, (pr, pl, rr, rl) in enumerate(zip(prog_routes, prog_logp, ref_routes,
                                                     ref_logits)):
            if not flips:
                d = pl[b] - rl[b].double()
                error = max(error, float(d.max() - d.min()))
            if set(pr[b].tolist()) != set(rr[b].tolist()):
                flips.append(layer)
        out.append({"flipped_layers": flips, "router_error": error})
    return out


def reference_answers(cell, weights, tokens, margins: list, record: dict) -> dict:
    """{margin: each prompt's answer}: with no margins {None: (V,) logits
    of each prompt}; otherwise each prompt's (C, V) candidates at each
    margin, from one pass of the reference."""
    model = cell.config["model"]
    if not margins:
        return {None: list(cell.family.last_logits(model, weights, tokens).cpu())}
    kept = []
    with _plain.strict_f32():
        cell.family.last_logits(model, weights, tokens, expert_loads=record["loads"],
                                last_routes=record["routes"], last_router=record["router"],
                                kept=kept)
        out = {}
        for m in margins:
            out[m] = []
            for b in range(tokens.shape[0]):
                rows, capped = cell.family.last_token_paths(
                    model, weights, int(tokens[b, -1]), [(k[b], v[b]) for k, v in kept], m)
                out[m].append(rows.cpu())
                record["paths"].setdefault(str(m), []).append([rows.shape[0], bool(capped)])
    return out


def readings(workload: str, seeds: list, control_seeds: list, device, margins: list) -> list:
    cell = harness.load_cell(workload)
    cfg = harness.port_config(cell.config)
    model_doc, traffic = cell.config["model"], cell.traffic
    dtype = getattr(torch, cell.config["dtype"])
    n_layers = model_doc["n_layers"]
    rows = []
    for seed in seeds:
        t0 = time.perf_counter()
        weights = harness.draw_weights(cell.family.param_specs(model_doc), seed, device, dtype)
        prog = harness.load_program(cfg, weights)
        draw = harness.token_draw(traffic, model_doc["vocab_size"], seed, device)
        kept = []
        recorder = RouteRecorder(traffic["prompt_len"]) if margins else None
        harness.run_steps(lambda t: harness.forward(cfg, prog, t), draw,
                          count=traffic["check_steps"], keep=lambda t, h: kept.append((t, h)))
        if recorder:
            recorder.close()
        del prog
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        row = {"seed": seed, "program_s": t1 - t0}
        record = {"loads": [], "routes": [], "router": [], "paths": {}}
        answers, program, followed = {}, [], []
        broken = {"altered_token": [], "half_batch": []}
        for i, (tokens, host) in enumerate(kept):
            record["routes"].clear(), record["router"].clear()
            for m, a in reference_answers(cell, weights, tokens, margins, record).items():
                answers.setdefault(m, []).extend(a)
            if recorder:
                part = slice(i * n_layers, (i + 1) * n_layers)
                followed += follow(recorder.routes[part], recorder.logp[part], record["routes"],
                                   record["router"])
            program.append(host.float())
            broken["altered_token"].append(faults.altered_token(host.float()))
            broken["half_batch"].append(faults.half_batch(host.float()))
        row["reference_s"] = time.perf_counter() - t1
        program = torch.cat(program)
        row["program"] = {str(m): check.numbers(program, a) for m, a in answers.items()}
        row["per_prompt"] = {str(m): check.per_prompt(program, a) for m, a in answers.items()}
        if recorder:
            row["followed"] = followed
            row["paths"] = record["paths"]
        if record["loads"]:
            row["largest_expert_load"] = max(record["loads"])
        if seed in control_seeds:
            t2 = time.perf_counter()
            ctrl = torch.cat([cell.family.last_logits(model_doc, weights, tokens,
                                                      mm=_plain.fp8_mm).cpu()
                              for tokens, _ in kept])
            row["control_s"] = time.perf_counter() - t2
            row["control"] = {str(m): check.numbers(ctrl, a) for m, a in answers.items()}
            row["control_per_prompt"] = {str(m): check.per_prompt(ctrl, a)
                                         for m, a in answers.items()}
            row["faults"] = {name: {str(m): check.numbers(torch.cat(v), a)
                                    for m, a in answers.items()}
                             for name, v in broken.items()
                             if name != "half_batch" or traffic["batch"] > 1}
        rows.append(row)
        print(json.dumps(row), file=sys.stderr, flush=True)
        del weights
        torch.cuda.empty_cache()
    return rows


def summary(rows: list) -> dict:
    """[least, largest] of each number over the seeds, by source and
    margin."""
    out = {}
    for key in ("program", "control"):
        have = [r[key] for r in rows if key in r]
        for m in (have[0] if have else {}):
            nums = [h[m] for h in have]
            out.setdefault(key, {})[m] = {n: [min(x[n] for x in nums), max(x[n] for x in nums)]
                                          for n in nums[0]}
    errors = [f["router_error"] for r in rows for f in r.get("followed", [])]
    if errors:
        out["router_error_max"] = max(errors)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--control-seeds", default="")
    parser.add_argument("--margins", default="")
    parser.add_argument("--out")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("readings need a CUDA device", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",")]
    control = [int(s) for s in args.control_seeds.split(",") if s]
    margins = [float(m) for m in args.margins.split(",") if m]
    rows = readings(args.workload, seeds, control, torch.device("cuda", 0), margins)
    doc = {"workload": args.workload, "device": torch.cuda.get_device_name(0),
           "summary": summary(rows), "rows": rows}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(doc, indent=1))
    print(json.dumps(doc["summary"]), file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
