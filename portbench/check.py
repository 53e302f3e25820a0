"""The comparison that decides ``correct``.

The program's last-position logits of a sample of the window's steps,
drawn from the seed, are held against the plain reference's float32
logits of the same prompts, computed after the window.  Where the
reference gives a prompt several candidate answers (a mixture of experts'
last token near a tie of its router, ``reference/mixtral.py``), the
prompt is held to the candidate nearest the program's logits.  The
numbers, over every prompt of the sampled steps:

* ``rel_l2_max``: the largest ||program - reference|| / ||reference||
  over the prompts' logits;
* ``served_gap_max``: the widest gap by which the token served greedily
  (the program's argmax) lies below the reference's best logit.

``portbench/limits/<workload>.json`` names the numbers a cell compares,
each with its limit and the readings the limit was set from; a number
above its limit, one that is not finite, or a cell with no limits file
makes the run not correct.
"""

from __future__ import annotations

import json
import math
import random
from pathlib import Path

import torch

LIMITS = Path(__file__).resolve().parent / "limits"


def sample_steps(n_steps: int, k: int, seed: int) -> list:
    """``k`` distinct step indices of ``n_steps``, drawn from ``seed``."""
    return sorted(random.Random(seed).sample(range(n_steps), min(k, n_steps)))


def per_prompt(program: torch.Tensor, reference) -> tuple[list, list]:
    """(relative L2, served gap) of each of (N, V) program logits against
    the reference's: (N, V), or a list of N (C, V) candidates of which
    each prompt is held to the one nearest its logits."""
    rel, gap = [], []
    for n, p in enumerate(program.double()):
        r = reference[n].double().reshape(-1, p.numel())
        err = (p - r).norm(dim=-1) / r.norm(dim=-1)
        best = int(err.argmin())
        rel.append(float(err[best]))
        gap.append(float(r[best].amax() - r[best, p.argmax()]))
    return rel, gap


def numbers(program: torch.Tensor, reference) -> dict:
    """The compared numbers of (N, V) program logits against the
    reference's (as ``per_prompt``)."""
    rel, gap = per_prompt(program, reference)
    return {"rel_l2_max": max(rel), "served_gap_max": max(gap)}


def load_limits(workload: str) -> dict | None:
    path = LIMITS / f"{workload}.json"
    return json.loads(path.read_text()) if path.exists() else None


def judge(nums: dict, limits: dict | None) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) for the numbers ``limits``
    compares."""
    if not limits:
        return False, {}
    out = {}
    ok = True
    for name, spec in limits["compared"].items():
        value = nums.get(name, float("nan"))
        out[name] = {"value": value, "limit": spec["limit"]}
        ok &= math.isfinite(value) and value <= spec["limit"]
    return ok, out
