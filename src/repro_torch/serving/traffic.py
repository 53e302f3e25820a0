"""Seeded traffic model: request distributions -> MAC-share-weighted job sets.

Layer 2 of the serving subsystem (DESIGN.md §Serving-workloads).  A
``TrafficModel`` describes one serving replica's steady-state second —
request rate, log-normal prompt/generation length distributions, and the
continuous-batching knobs (decode step time, prefill batching window,
batch caps).  Everything downstream is a deterministic function of the
model's seed:

  1. ``sample_requests`` draws N requests (prompt len, gen len, arrival
     time) from one ``np.random.default_rng(seed)`` stream;
  2. ``traffic_classes`` folds them into a handful of (regime, batch,
     seq) shape classes: prefill requests bucket by power-of-two prompt
     length and batch by arrivals per batching window; decode batch sizes
     come from the sampled in-flight concurrency (each request occupies
     the decode pool for ``gen_len * decode_step_s`` seconds — Little's
     law made empirical), bucketed to powers of two under the
     continuous-batching cap.  Each class carries its token rate and
     execution rate for the steady-state second;
  3. ``weighted_gemms`` expands every class through ``serving.expand`` and
     weights each GEMM shape class by its MAC share of that second —
     weights sum to 1 exactly, and ``macs_per_token`` (total MAC/s over
     total served tokens/s) is the bridge from the design-space engine's
     J/op answers to J/token.

At fleet scale ("millions of users") traffic shards across replicas; the
QPS here is per replica — the quantity one systolic array actually sees.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np

from repro_torch.core.workloads import Gemm
from repro_torch.serving.expand import ServingGemm, expand_arch

__all__ = [
    "TrafficModel",
    "TrafficClass",
    "ServingJobSet",
    "PRESETS",
    "get_preset",
    "sample_requests",
    "traffic_classes",
    "weighted_gemms",
]


@dataclasses.dataclass(frozen=True)
class TrafficModel:
    """One replica's steady-state serving traffic, fully seeded.

    ``prompt_len``/``gen_len`` are log-normal in TOKEN space: the tuple is
    (mean tokens, sigma of log) — mean is the actual distribution mean, so
    ``prefill_decode_ratio`` is exactly ``prompt_mean / gen_mean``.
    """

    name: str
    qps: float  # requests/s into this replica
    prompt_len: tuple[float, float]  # (mean tokens, log-space sigma)
    gen_len: tuple[float, float]
    max_prompt: int = 32768
    max_gen: int = 8192
    decode_step_s: float = 0.02  # nominal decode step latency (pool residency)
    prefill_window_s: float = 0.05  # arrivals batched per prefill launch
    max_decode_batch: int = 256  # continuous-batching concurrency cap
    max_prefill_batch: int = 32
    min_seq_bucket: int = 16  # smallest power-of-two prefill bucket
    n_samples: int = 2048  # sampled requests per draw
    n_probes: int = 256  # concurrency probe instants
    seed: int = 0

    def __post_init__(self):
        if self.qps <= 0:
            raise ValueError("qps must be positive")
        for label, (mean, sigma) in (
            ("prompt_len", self.prompt_len),
            ("gen_len", self.gen_len),
        ):
            if mean < 1 or sigma < 0:
                raise ValueError(f"{label}: need mean >= 1, sigma >= 0")
        if self.n_samples < 2 or self.n_probes < 2:
            raise ValueError("need n_samples, n_probes >= 2")

    @property
    def prefill_decode_ratio(self) -> float:
        """Target prefill:decode token ratio (prompt mean over gen mean)."""
        return self.prompt_len[0] / self.gen_len[0]

    def with_ratio(self, ratio: float) -> "TrafficModel":
        """Same traffic with the gen-length mean rescaled so that
        prompt:gen token ratio == ``ratio`` (the ratio-sweep knob)."""
        if ratio <= 0:
            raise ValueError("ratio must be positive")
        return dataclasses.replace(
            self,
            name=f"{self.name}@pd{ratio:g}",
            gen_len=(self.prompt_len[0] / ratio, self.gen_len[1]),
        )


@dataclasses.dataclass(frozen=True)
class TrafficClass:
    """One (regime, batch, seq) shape class of the steady-state second."""

    regime: str  # "prefill" | "decode"
    batch: int  # prefill: requests per launch; decode: step batch size
    seq_len: int  # prefill: padded bucket length; decode: 1
    tokens_per_s: float  # actual (unpadded) served tokens attributed here
    execs_per_s: float  # forward-step executions per second

    @property
    def tokens_per_exec(self) -> int:
        return self.batch * self.seq_len


def _lognormal_lens(rng, mean: float, sigma: float, lo: int, hi: int, n: int):
    """Log-normal token lengths with the given DISTRIBUTION mean."""
    mu = math.log(mean) - 0.5 * sigma * sigma
    lens = np.rint(rng.lognormal(mu, sigma, size=n)).astype(np.int64)
    return np.clip(lens, lo, hi)


def sample_requests(tm: TrafficModel):
    """Seeded request draw: (prompt_lens, gen_lens, arrival_s), arrivals
    uniform over a window of ``n_samples / qps`` seconds (sorted)."""
    rng = np.random.default_rng(tm.seed)
    prompts = _lognormal_lens(rng, *tm.prompt_len, 1, tm.max_prompt, tm.n_samples)
    gens = _lognormal_lens(rng, *tm.gen_len, 1, tm.max_gen, tm.n_samples)
    window_s = tm.n_samples / tm.qps
    arrivals = np.sort(rng.uniform(0.0, window_s, size=tm.n_samples))
    return prompts, gens, arrivals


def _pow2_bucket(x, lo: int, hi: int):
    """Round up to the nearest power of two in [lo, hi] (vectorized)."""
    x = np.maximum(np.asarray(x, np.int64), 1)
    exp = np.ceil(np.log2(x)).astype(np.int64)
    return np.clip(2 ** exp, lo, hi)


def traffic_classes(tm: TrafficModel) -> list[TrafficClass]:
    """The steady-state second as a small list of weighted shape classes."""
    prompts, gens, arrivals = sample_requests(tm)
    window_s = tm.n_samples / tm.qps
    classes: list[TrafficClass] = []

    # --- prefill: bucket prompts by power-of-two length ---------------------
    seq_buckets = _pow2_bucket(prompts, tm.min_seq_bucket, tm.max_prompt)
    for bucket in sorted(np.unique(seq_buckets)):
        in_b = seq_buckets == bucket
        rate_b = float(in_b.sum()) / window_s  # requests/s at this length
        batch = int(np.clip(round(rate_b * tm.prefill_window_s), 1, tm.max_prefill_batch))
        classes.append(
            TrafficClass(
                regime="prefill",
                batch=batch,
                seq_len=int(bucket),
                tokens_per_s=float(prompts[in_b].sum()) / window_s,
                execs_per_s=rate_b / batch,
            )
        )

    # --- decode: in-flight concurrency under continuous batching ------------
    # each request occupies the decode pool for gen * decode_step_s seconds
    # starting at its arrival; probe the pool at n_probes instants of the
    # interior of the window (edges are cold-start / drain artifacts)
    durations = gens.astype(np.float64) * tm.decode_step_s
    t0, t1 = 0.1 * window_s, 0.9 * window_s
    probes = np.linspace(t0, t1, tm.n_probes)
    conc = (
        (arrivals[None, :] <= probes[:, None])
        & (probes[:, None] < (arrivals + durations)[None, :])
    ).sum(axis=1)
    live = conc > 0
    total_decode_tok = float(gens.sum()) / window_s  # served decode tokens/s
    if live.any():
        batch_eff = np.minimum(conc[live], tm.max_decode_batch)
        buckets = _pow2_bucket(batch_eff, 1, tm.max_decode_batch)
        # token throughput share of each batch bucket ~ observed step width
        share = np.zeros(0)
        uniq = sorted(np.unique(buckets))
        share = np.array(
            [float(batch_eff[buckets == b].sum()) for b in uniq], np.float64
        )
        share = share / share.sum()
        for b, s in zip(uniq, share):
            tok_b = total_decode_tok * float(s)
            classes.append(
                TrafficClass(
                    regime="decode",
                    batch=int(b),
                    seq_len=1,
                    tokens_per_s=tok_b,
                    execs_per_s=tok_b / float(b),
                )
            )
    else:  # degenerate ultra-light traffic: a single batch-1 decode class
        classes.append(
            TrafficClass("decode", 1, 1, total_decode_tok, total_decode_tok)
        )
    return classes


# ---------------------------------------------------------------------------
# The weighted GEMM job set
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ServingJobSet:
    """(model x traffic) -> deduped GEMM shape classes + MAC-share weights.

    ``weights`` sum to 1 and are each GEMM's share of the replica's total
    MAC/s; ``mac_rate`` keeps the unnormalized MAC/s.  ``macs_per_token``
    bridges J/op to J/token: J/token = j_per_mac * macs_per_token.
    """

    arch: str
    traffic: str
    gemms: tuple[Gemm, ...]
    weights: np.ndarray  # (G,) MAC shares, sum == 1
    mac_rate: np.ndarray  # (G,) MAC/s
    regimes: tuple[str, ...]  # per-GEMM regime
    densities: tuple[float | None, ...]  # per-GEMM operand density hint
    classes: tuple[TrafficClass, ...]
    tokens_per_s: float  # served tokens/s (prefill + decode, unpadded)

    @property
    def macs_per_token(self) -> float:
        return float(self.mac_rate.sum() / self.tokens_per_s)

    def regime_weights(self, regime: str) -> np.ndarray:
        """Weights restricted to one regime (zero elsewhere, unnormalized)."""
        mask = np.asarray([r == regime for r in self.regimes], float)
        return np.asarray(self.weights) * mask


def weighted_gemms(cfg, tm: TrafficModel, *, arch_name: str | None = None) -> ServingJobSet:
    """Expand ``cfg`` under every traffic class and weight by MAC share.

    Identical (regime, block, m, k, n) shape classes across traffic classes
    merge into one entry whose MAC/s accumulates in deterministic class
    order — the numpy-oracle re-derivation in benchmarks/bench_serving.py
    reproduces these weights bit-exactly.
    """
    classes = traffic_classes(tm)
    order: dict[tuple, int] = {}
    entries: list[ServingGemm] = []
    rates: list[float] = []
    for tc in classes:
        for sg in expand_arch(cfg, tc.regime, tc.batch, tc.seq_len):
            key = (sg.regime, sg.block, sg.gemm.m, sg.gemm.k, sg.gemm.n)
            idx = order.get(key)
            if idx is None:
                order[key] = len(entries)
                entries.append(sg)
                rates.append(0.0)
                idx = order[key]
            rates[idx] += tc.execs_per_s * sg.macs
    mac_rate = np.asarray(rates, np.float64)
    weights = mac_rate / mac_rate.sum()
    gemms = tuple(
        Gemm(f"{sg.regime[:3]}.{sg.block}", sg.gemm.m, sg.gemm.k, sg.gemm.n)
        for sg in entries
    )
    return ServingJobSet(
        arch=arch_name or getattr(cfg, "name", "?"),
        traffic=tm.name,
        gemms=gemms,
        weights=weights,
        mac_rate=mac_rate,
        regimes=tuple(sg.regime for sg in entries),
        densities=tuple(sg.input_density for sg in entries),
        classes=tuple(classes),
        tokens_per_s=float(sum(tc.tokens_per_s for tc in classes)),
    )


# ---------------------------------------------------------------------------
# Presets
# ---------------------------------------------------------------------------

# Per-replica traffic regimes.  prefill_heavy is the RAG/summarization
# shape (long prompts, terse answers, ~48:1 prefill:decode tokens);
# decode_heavy is the chat/agent shape (short prompts, long generations,
# ~1:5) whose steady-state decode pool rides the continuous-batching cap —
# skinny M=batch GEMMs dominating the MAC budget.
PRESETS: dict[str, TrafficModel] = {
    "prefill_heavy": TrafficModel(
        name="prefill_heavy",
        qps=8.0,
        prompt_len=(6144.0, 0.6),
        gen_len=(128.0, 0.5),
    ),
    "decode_heavy": TrafficModel(
        name="decode_heavy",
        qps=8.0,
        prompt_len=(192.0, 0.6),
        gen_len=(1024.0, 0.5),
    ),
    "balanced": TrafficModel(
        name="balanced",
        qps=8.0,
        prompt_len=(1024.0, 0.7),
        gen_len=(512.0, 0.6),
    ),
}


def get_preset(name: str) -> TrafficModel:
    if isinstance(name, TrafficModel):
        return name
    if name not in PRESETS:
        raise KeyError(f"unknown traffic preset {name!r}; known: {sorted(PRESETS)}")
    return PRESETS[name]
